"""Where a round's time goes on the card: one warm-up round, then one round
of each trainer under ``torch.profiler`` at the paper's EMNIST width, or
with ``--cinic`` at its CINIC-10 width (``cinic_cnn``, 32x32x3, width 32).

  PYTHONPATH=src python -m repro_torch.examples.profile_round [--cinic] [--out DIR]

Prints, per trainer: the round's wall seconds, the summed device time of
all kernels, the device idle share (1 - device time / wall time, kernels
serialized on one stream), the launch count, and the top kernels by
device time.  ``--out`` also writes each trainer's Chrome trace there.
"""
import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
from repro_torch.examples.astraea_vs_fedavg import configuration
from repro_torch.optim import adam


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cinic", action="store_true", help="the CINIC-10 arm")
    args = ap.parse_args()
    fed, model, c, _ = configuration(args.cinic, full=True)
    common = dict(clients_per_round=c, local=LocalSpec(20, 2), seed=0)
    trainers = {
        "FedAvg": FedAvgTrainer(model, adam(1e-3), fed, **common),
        "Astraea": AstraeaTrainer(model, adam(1e-3), fed, gamma=4,
                                  alpha=0.67, **common),
    }
    report = {}
    for name, tr in trainers.items():
        tr.run_round()                          # warm-up (cuDNN plans, build)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(device_us(e) for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=device_us, reverse=True)[:args.top]
        report[name] = {
            "wall_s": wall, "device_s": dev_us / 1e6,
            "idle_share": 1.0 - dev_us / 1e6 / wall, "kernel_launches": launches,
            "top": [{"kernel": e.key[:90], "count": e.count,
                     "device_ms": device_us(e) / 1e3} for e in top]}
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(args.out) / f"{name.lower()}_round.json"))
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
