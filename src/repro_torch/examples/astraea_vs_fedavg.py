"""The paper's headline experiment on the PyTorch/CUDA port: FedAvg vs
augmentation-only vs full Astraea on globally-imbalanced data, with the
WAN traffic ledger.

  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg            # small
  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg --full     # 47-class EMNIST width
  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg --cinic    # CINIC-like
  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg --cinic --full
  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg --device cpu
  PYTHONPATH=src python -m repro_torch.examples.astraea_vs_fedavg --staleness 2 --store spilled

The default configuration is the JAX example's (10 classes at 16x16, 16
clients, 8 per round); ``--full`` is the paper's EMNIST width: 47 classes
at 28x28 (68,873 parameters), 64 clients, 16 per round.  ``--cinic`` is
the JAX example's CINIC arm (10 classes at 16x16x3, ``cinic_cnn`` at width
16, a normal global distribution); ``--cinic --full`` is the paper's
CINIC-10 model: 32x32x3, width 32 (2,168,362 parameters), 64 clients, 16
per round.

Every trainer is evaluated each round; the table ends with Table III's
metric, the WAN traffic each method spent until it first reached
FedAvg's best accuracy (``fl_experiments.traffic_to_reach``).

``--store`` places every trainer's client data (``replicated``, ``host``
or ``spilled``, ``core/client_store.py``); ``--staleness S`` adds an async
Astraea run (``core/async_engine.py``): a wave per mediator, bounded
staleness S, one mediator in three 4x slower (the JAX example's fleet),
with its simulated round-time speedup over the synchronous barrier.
"""
import argparse
import dataclasses

from repro_torch.core import (AstraeaTrainer, AsyncSpec, FedAvgTrainer, LocalSpec,
                              StragglerSpec)
from repro_torch.data.federated import CINIC_LIKE, EMNIST_LIKE, partition
from repro_torch.examples.fl_experiments import best_accuracy, traffic_to_reach
from repro_torch.models.cnn import cinic_cnn, emnist_cnn
from repro_torch.optim import adam


def configuration(cinic: bool, full: bool):
    """``(federation, model, clients per round, the paper's top-1 gain)``
    of one arm of the experiment."""
    if cinic:
        spec = dataclasses.replace(CINIC_LIKE, image_size=32 if full else 16,
                                   noise=0.5, distort=0.35)
        model = cinic_cnn(spec.num_classes, image_size=spec.image_size,
                          width=32 if full else 16)
        gd, paper = "normal", "+0.0589"
    elif full:
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=47)
        model = emnist_cnn(47, 28)
        gd, paper = "letterfreq", "+0.0559"
    else:
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=10, image_size=16,
                                   noise=0.45, distort=0.35)
        model = emnist_cnn(10, 16)
        gd, paper = "letterfreq", "+0.0559"
    if full:
        fed = partition(spec, num_clients=64, total_samples=6400,
                        test_samples=1000 if cinic else 2350, sizes="instagram",
                        global_dist=gd, local="random", seed=0)
        return fed, model, 16, paper
    fed = partition(spec, num_clients=16, total_samples=1600, test_samples=600,
                    sizes="instagram", global_dist=gd, local="random", seed=0)
    return fed, model, 8, paper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--cinic", action="store_true",
                    help="the CINIC-10 arm (cinic_cnn, 32x32x3 with --full)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's width: 64 clients, 16 per round")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--store", default="replicated",
                    choices=("replicated", "host", "spilled"),
                    help="client-store placement policy of every trainer")
    ap.add_argument("--staleness", type=int, default=None,
                    help="add an async Astraea run at this staleness bound")
    args = ap.parse_args()

    fed, model, c, paper = configuration(args.cinic, args.full)
    local = LocalSpec(20, 2)
    common = dict(clients_per_round=c, local=local, seed=0, device=args.device,
                  store=args.store)

    runs = []
    fa = FedAvgTrainer(model, adam(1e-3), fed, **common)
    runs.append(("FedAvg", fa.fit(args.rounds, eval_every=1)))
    ao = AstraeaTrainer(model, adam(1e-3), fed, gamma=1, alpha=0.67, **common)
    runs.append(("Astraea (aug only)", ao.fit(args.rounds, eval_every=1)))
    aa = AstraeaTrainer(model, adam(1e-3), fed, gamma=4, mediator_epochs=1,
                        alpha=0.67, **common)
    runs.append(("Astraea (aug+mediators)", aa.fit(args.rounds, eval_every=1)))
    if args.staleness is not None:
        spec = AsyncSpec(staleness_bound=args.staleness, wave_size=1,
                         straggler=StragglerSpec(model="fixed", straggler_frac=0.34,
                                                 slowdown=4.0, seed=0))
        at = AstraeaTrainer(model, adam(1e-3), fed, gamma=4, mediator_epochs=1,
                            alpha=0.67, async_spec=spec, **common)
        runs.append((f"Astraea (async S={args.staleness})",
                     at.fit(args.rounds, eval_every=1)))

    target = best_accuracy(runs[0][1])
    print(f"\n{'method':26s} {'top1':>7s} {'traffic MB':>11s} "
          f"{'MB to FedAvg best':>18s}")
    for name, hist in runs:
        h, reach = hist[-1], traffic_to_reach(hist, target)
        print(f"{name:26s} {h['accuracy']:7.3f} {h['traffic_mb']:11.1f} "
              f"{'not reached' if reach is None else f'{reach:.1f}':>18s}")
    f, a = runs[0][1][-1], runs[2][1][-1]
    print(f"\nAstraea - FedAvg = {a['accuracy'] - f['accuracy']:+.3f} "
          f"(paper: {paper}); FedAvg's best top-1 {target:.3f}")
    print(f"WAN traffic ratio Astraea/FedAvg = "
          f"{a['traffic_mb'] / f['traffic_mb']:.2f}x per round")
    if args.staleness is not None:
        h = runs[3][1][-1]
        print(f"async S={args.staleness} under a 4x straggler: simulated round-time "
              f"speedup {h['sim_speedup']:.2f}x, staleness <= {h['staleness_max']}, "
              f"overlap {h['overlap_frac']:.2f}, top-1 vs sync Astraea "
              f"{h['accuracy'] - a['accuracy']:+.3f}")
    if args.store != "replicated":
        s = aa.engine.store.stats()
        print(f"{args.store} store: {s['per_device_bytes'] / 2 ** 20:.2f} MiB on the "
              f"device, {s['streamed_bytes'] / 2 ** 20:.2f} MiB streamed "
              f"(intra-pod ledger), WAN unchanged")

if __name__ == "__main__":
    main()
