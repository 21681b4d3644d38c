"""Section II-B motivation on the port: the five TABLE I federations, end
to end, and Fig. 1's per-class recall under global imbalance.

  PYTHONPATH=src python -m repro_torch.examples.imbalance_motivation [--device cpu]

For each federation: its three imbalance statistics
(``distribution.imbalance_summary``: client-size CV, mean local KLD,
global KLD) and FedAvg's top-1 after ``--rounds`` rounds.  Global
imbalance (LTRF) should cost FedAvg accuracy where size or local
imbalance (BAL2, INS) does not.  Then the per-class recall of FedAvg on
LTRF1 (``fl.confusion_matrix``), classes ordered frequent to rare: the
rare classes are the ones the model stops predicting.  Runs on the CUDA
device unless ``--device`` says otherwise.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import FedAvgTrainer, LocalSpec
from repro_torch.core import distribution as dist
from repro_torch.core.fl import confusion_matrix
from repro_torch.data.federated import EMNIST_LIKE, letter_frequency_probs, table1
from repro_torch.models.cnn import emnist_cnn
from repro_torch.optim import adam


def federations():
    """The JAX example's TABLE I federations (10 classes at 16x16)."""
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=10, image_size=16,
                               noise=0.45, distort=0.35)
    return table1(spec, num_clients=16, total_samples=1600, test_samples=600)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    feds = federations()
    model = emnist_cnn(10, 16)
    common = dict(clients_per_round=8, local=LocalSpec(20, 2), seed=0,
                  device=args.device)

    print(f"{'dataset':8s} {'size_cv':>8s} {'local_kld':>10s} {'global_kld':>11s} "
          f"{'top1':>7s}")
    results, trainers = {}, {}
    for name, fed in feds.items():
        stats = dist.imbalance_summary(fed.client_counts())
        tr = FedAvgTrainer(model, adam(1e-3), fed, **common)
        acc = tr.fit(args.rounds, eval_every=args.rounds)[-1]["accuracy"]
        results[name], trainers[name] = acc, tr
        print(f"{name:8s} {float(stats['size_cv']):8.2f} "
              f"{float(stats['local_kld_mean']):10.3f} "
              f"{float(stats['global_kld']):11.3f} {acc:7.3f}")
    print(f"\nglobal-imbalance accuracy drop (INS - LTRF1): "
          f"{results['INS'] - results['LTRF1']:+.3f}  (paper: +0.079)")

    # Fig. 1(b)/(c): per-class recall of the LTRF1 model
    fed, tr = feds["LTRF1"], trainers["LTRF1"]
    _, recall = confusion_matrix(model, tr.params,
                                 torch.from_numpy(fed.test_images).to(tr.device),
                                 torch.from_numpy(fed.test_labels).to(tr.device),
                                 fed.num_classes)
    order = np.argsort(-letter_frequency_probs(fed.num_classes))
    print("\nper-class recall on LTRF1 (classes ordered frequent -> rare):")
    print("  " + " ".join(f"{recall[c]:.2f}" for c in order))
    print(f"  majority-3 recall {recall[order[:3]].mean():.2f} vs minority-3 recall "
          f"{recall[order[-3:]].mean():.2f} (paper Fig. 1c: minority rows collapse)")


if __name__ == "__main__":
    main()
