"""How the host's thread counts move ``test_torch_system.py``'s FedAvg
trajectory (LTRF, 12 rounds): the port's accuracy history under
``torch.set_num_threads(N)`` and the reference loop's under the XLA CPU
thread settings of this process, and Table III's ``traffic_to_reach`` at
the reference's best accuracy.

  PYTHONPATH=.:src:tests JAX_PLATFORMS=cpu python tests/torch_thread_spread.py --torch-threads 1
  XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1" \\
      PYTHONPATH=.:src:tests JAX_PLATFORMS=cpu python tests/torch_thread_spread.py --torch-threads 1

Prints one JSON line.
"""
import argparse
import json
import os

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-threads", type=int, default=1)
    args = ap.parse_args()
    import test_torch_system as S                  # pins one thread at import
    torch.set_num_threads(args.torch_threads)
    run = S._fedavg("letterfreq")
    ref = run["ref_history"]
    port = run["port"].history
    target = S._best(ref)["accuracy"]
    print(json.dumps({
        "torch_threads": torch.get_num_threads(), "cpus": os.cpu_count(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "ref_accuracy": [h["accuracy"] for h in ref],
        "port_accuracy": [h["accuracy"] for h in port],
        "target": target,
        "port_traffic_to_target": S.traffic_to_reach(port, target),
        "ref_traffic_to_target": S.traffic_to_reach(ref, target)}))


if __name__ == "__main__":
    main()
