"""Quickstart on the PyTorch/CUDA port: Astraea vs FedAvg on a
globally-imbalanced federation (the twin of ``examples/quickstart.py``).

The tour of the public API: build a TABLE I-style federated dataset,
train the paper's CNN with FedAvg and with Astraea, print the accuracy,
mediator-KLD and traffic comparison.  The same federation, model,
trainers, rounds and printed lines as the JAX quickstart.

  PYTHONPATH=src python -m repro_torch.examples.quickstart                 # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --rounds 2

On the card the round runs the three FL kernels: Eq. 6 (``fedavg_agg``),
Alg. 3's greedy pass (``kld_greedy_picks``) and Alg. 2's warp
(``affine_warp``).  ``--model-parallel t`` puts both trainers on the 2-D
``(mediator, model)`` mesh of one mediator row and ``t`` logical model
positions on ``--device`` (``launch/mesh.py::make_fl_mesh``): the weights
are split over the model axis at rest, the trajectory and the WAN ledger
are the 1-D run's, and the model-axis gathers go to the intra-pod ledger.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --rounds 2 --model-parallel 2
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
from repro_torch.data.federated import EMNIST_LIKE, partition
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_fl_mesh
from repro_torch.models.cnn import emnist_cnn
from repro_torch.optim import adam

# the federation and trainers (``examples/quickstart.py``)
CLIENTS, PER_ROUND, GAMMA, ALPHA, ROUNDS = 16, 8, 4, 0.67, 8


def federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=10, image_size=16,
                               noise=0.45, distort=0.35)
    fed = partition(spec, num_clients=CLIENTS, total_samples=1600, test_samples=600,
                    sizes="instagram", global_dist="letterfreq", local="random",
                    seed=0, name="LTRF-quickstart")
    return spec, fed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="model-axis size of the 2-D (mediator, model) mesh, its "
                         "positions logical ones on --device; default: 1-D")
    args = ap.parse_args(argv)
    mesh = None
    if args.model_parallel is not None:
        if args.model_parallel < 1:
            ap.error(f"--model-parallel {args.model_parallel}: must be >= 1")
        dev = resolve_device(args.device)
        mesh = make_fl_mesh(mediator=1, model=args.model_parallel,
                            devices=(dev,) * args.model_parallel)
    rounds = args.rounds
    eval_every = max(rounds // 2, 1)

    spec, fed = federation()
    model = emnist_cnn(spec.num_classes, image_size=16)
    local = LocalSpec(batch_size=20, epochs=2)

    print("== FedAvg (baseline) ==")
    fedavg = FedAvgTrainer(model, adam(1e-3), fed, clients_per_round=PER_ROUND,
                           local=local, seed=0, device=args.device, mesh=mesh)
    fh = fedavg.fit(rounds, eval_every=eval_every)
    for h in fh:
        print(f"  round {h['round']:3d}  acc={h['accuracy']:.3f}  "
              f"traffic={h['traffic_mb']:.0f} MB")

    print(f"== Astraea (online augmentation alpha={ALPHA} + mediators gamma={GAMMA}) ==")
    astraea = AstraeaTrainer(model, adam(1e-3), fed, clients_per_round=PER_ROUND,
                             gamma=GAMMA, local=local, mediator_epochs=1,
                             alpha=ALPHA, seed=0, device=args.device, mesh=mesh)
    ah = astraea.fit(rounds, eval_every=eval_every)
    for h in ah:
        print(f"  round {h['round']:3d}  acc={h['accuracy']:.3f}  "
              f"traffic={h['traffic_mb']:.0f} MB  "
              f"mediator_kld={h.get('mediator_kld_mean', float('nan')):.3f}")

    print(f"\nAstraea improvement: "
          f"{ah[-1]['accuracy'] - fh[-1]['accuracy']:+.3f} top-1 "
          f"(paper: +0.0559 on imbalanced EMNIST)")
    print(f"extra client storage from augmentation: "
          f"{astraea.extra_storage_frac:.0%} realized "
          f"(materializing would cost {astraea.planned_extra_frac:.0%} -- "
          f"paper Fig. 9 trade-off, avoided by the online pipeline)")
    fa_mb, as_mb = fh[-1]["traffic_mb"], ah[-1]["traffic_mb"]
    print(f"WAN traffic after {rounds} rounds: FedAvg {fa_mb:.1f} MB vs "
          f"Astraea {as_mb:.1f} MB ({as_mb / fa_mb:.2f}x per-round "
          f"surcharge; Table III wins on rounds-to-accuracy)")
    # the 2-D mesh: the bytes of weights a position holds, and the
    # model-axis gathers on the intra-pod ledger, off the WAN numbers above
    st = astraea.engine.store.stats()
    if st["model_axis"] > 1:
        print(f"model_parallel={st['model_axis']}: {st['per_device_param_bytes']} "
              f"param bytes a position (replica {4 * fedavg.engine.comm.num_params}), "
              f"intra-pod traffic {astraea.engine.comm.intra_pod_megabytes:.1f} MB off "
              f"the WAN ledger")
    return {"fedavg": fh, "astraea": ah, "num_params": fedavg.engine.comm.num_params,
            "num_classes": spec.num_classes, "num_clients": CLIENTS,
            "store_stats": st, "intra_pod_bytes": astraea.engine.comm.intra_pod_bytes}


if __name__ == "__main__":
    main()
