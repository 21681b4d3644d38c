"""Cost-sensitive reweighting baseline (the ablation partner of Astraea).

The server knows the global label histogram (clients report it in the
initialization phase), so it can broadcast inverse-frequency class weights
for the local loss: no extra communication, no extra storage.  Unlike
Alg. 2 it adds no minority-class information, and unlike Alg. 3 it leaves
each client's own imbalance as it is.  Mirrors
``repro/core/reweighting.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fedavg import FedAvgTrainer
from repro_torch.device import resolve_device


def inverse_frequency_weights(global_counts: np.ndarray, *,
                              smoothing: float = 1.0,
                              normalize: bool = True) -> np.ndarray:
    """w_c = (n / C) / (count_c + smoothing), normalized to mean 1."""
    counts = np.asarray(global_counts, np.float64)
    w = (counts.sum() / len(counts)) / (counts + smoothing)
    if normalize:
        w = w * len(w) / w.sum()
    return w.astype(np.float32)


def weighted_cross_entropy(class_weights: torch.Tensor):
    """Loss factory: the NLL of each sample weighted by its label's class
    weight (and its mask), over the summed weights."""

    def loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        w = class_weights.to(logits.device)[labels.long()]
        if mask is not None:
            w = w * mask
        return (nll * w).sum() / w.sum().clamp_min(1e-6)

    return loss


@dataclass
class ReweightedFedAvgTrainer(FedAvgTrainer):
    """FedAvg whose local loss is inverse-frequency weighted by the global
    label distribution (server-computed, broadcast once)."""

    def __post_init__(self):
        counts = self.data.client_counts().sum(0)
        # the weights live on the training device: a captured round must
        # not copy them from the host
        self.device = resolve_device(self.device)
        wce = weighted_cross_entropy(
            torch.from_numpy(inverse_frequency_weights(counts)).to(self.device))

        def loss_fn(model, params, x, y, mask, keep):
            return wce(model.apply(params, x, keep), y, mask)

        self.loss_fn = loss_fn
        super().__post_init__()
