"""Local client training, Eq. 6 averaging and evaluation.

A *client update* is E epochs of mini-batch training on the client's padded,
masked local data, from supplied weights, with a fresh optimizer state.
Each epoch applies one permutation of the padded rows and then takes
``pad / B`` steps.  A fully masked batch has zero loss, so its gradients
are exactly zero; a client whose mask is all zero therefore leaves the
weights bitwise unchanged (fresh Adam moments stay zero).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.draws import ClientDraws
from repro_torch.models.cnn import Params, cross_entropy_loss
from repro_torch.optim.optimizers import Optimizer, apply_updates


@dataclass(frozen=True)
class LocalSpec:
    """Static local-training hyperparameters (paper TABLE II: B, E)."""
    batch_size: int
    epochs: int


# loss_fn(model, params, x, y, mask, keep) -> scalar loss
LossFn = Callable[..., torch.Tensor]


def masked_ce_loss(model, params: Params, x, y, mask, keep) -> torch.Tensor:
    """The default local loss: masked cross-entropy of the training-mode
    logits (dropout keep-masks ``keep``)."""
    return cross_entropy_loss(model.apply(params, x, keep), y, mask)


def _grads(model, params: Params, x, y, mask, keep, loss_fn: LossFn) -> Params:
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(model, leaves, x, y, mask, keep)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


def client_update(model, opt: Optimizer, spec: LocalSpec, params: Params,
                  x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                  draws: ClientDraws, loss_fn: LossFn | None = None) -> Params:
    """``spec.epochs`` epochs of mini-batch steps over ``x (pad, H, W, C)``,
    ``y (pad,)``, ``mask (pad,)``; returns the new weights.  ``loss_fn``
    replaces the masked cross-entropy (``core/reweighting.py``)."""
    n_pad, bsz = x.shape[0], spec.batch_size
    if n_pad % bsz:
        raise ValueError(f"pad {n_pad} is not a multiple of batch_size {bsz}")
    loss_fn = loss_fn or masked_ce_loss
    state = opt.init(params)
    sites = model.dropout_sites(bsz)
    for epoch in range(spec.epochs):
        perm = draws.permutation(epoch, n_pad)
        xs, ys, ms = x[perm], y[perm], mask[perm]
        for step in range(n_pad // bsz):
            sl = slice(step * bsz, (step + 1) * bsz)
            keep = draws.keep_masks(epoch, step, sites)
            grads = _grads(model, params, xs[sl], ys[sl], ms[sl], keep, loss_fn)
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
    return params


def weighted_average(trees: Params, weights: torch.Tensor) -> Params:
    """Eq. 6 over stacked ``(M, ...)`` leaves, plain tensordot form."""
    wnorm = weights.to(torch.float32)
    wnorm = wnorm / wnorm.sum().clamp_min(1e-12)
    return {k: torch.tensordot(wnorm, leaf, dims=1).to(leaf.dtype)
            for k, leaf in trees.items()}


@torch.no_grad()
def evaluate(model, params: Params, x: torch.Tensor, y: torch.Tensor,
             batch_size: int = 512) -> dict[str, float]:
    """Top-1 accuracy and mean NLL on a (balanced) test set."""
    n = x.shape[0]
    correct = torch.zeros((), dtype=torch.float64, device=x.device)
    loss_sum = torch.zeros((), dtype=torch.float64, device=x.device)
    for start in range(0, n, batch_size):
        bx, by = x[start:start + batch_size], y[start:start + batch_size].long()
        logits = model.apply(params, bx)
        correct += (logits.argmax(-1) == by).sum()
        logp = F.log_softmax(logits, dim=-1)
        loss_sum += -logp.gather(1, by[:, None]).sum()
    return {"accuracy": float(correct) / n, "loss": float(loss_sum) / n}


@torch.no_grad()
def confusion_matrix(model, params: Params, x: torch.Tensor, y: torch.Tensor,
                     num_classes: int, batch_size: int = 512):
    """Row-normalizable confusion counts + per-class recall (Fig. 1)."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for start in range(0, x.shape[0], batch_size):
        p = model.apply(params, x[start:start + batch_size]).argmax(-1).cpu().numpy()
        t = y[start:start + batch_size].cpu().numpy()
        np.add.at(cm, (t, p), 1)
    recall = cm.diagonal() / np.maximum(cm.sum(axis=1), 1)
    return cm, recall
