"""Local client training, Eq. 6 averaging and evaluation.

A *client update* is E epochs of mini-batch training on the client's padded,
masked local data, from supplied weights, with a fresh optimizer state.
Each epoch applies one permutation of the padded rows and then takes
``pad / B`` steps.  A fully masked batch has zero loss, so its gradients
are exactly zero; a client whose mask is all zero therefore leaves the
weights bitwise unchanged (fresh Adam moments stay zero).

``client_update`` trains one client; ``client_update_rows`` trains ``M``
clients in lockstep, one per row of stacked ``(M, ...)`` weights, with
``torch.func.vmap`` over the rows' gradients and Adam on the stacked
leaves (elementwise, and every row takes the same step count).  Its draws
arrive as tensors, so the whole update can be captured as a CUDA graph.

The trained tree is whatever ``model.apply`` takes: the weights, or under
LoRA the adapter state, which ``models.lora.MergedModel`` merges into the
frozen backbone; an empty tree (a rank-0 adapter state) trains nothing.
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
    if not params:
        return params
    loss_fn = loss_fn or masked_ce_loss
    state = opt.init(params)
    sites = model.dropout_sites(bsz)
    for epoch in range(spec.epochs):
        perm = draws.permutation(epoch, n_pad)
        xs, ys, ms = x[perm], y[perm], mask[perm]
        keeps = draws.epoch_keep_masks(epoch, n_pad // bsz, sites)
        for step in range(n_pad // bsz):
            sl = slice(step * bsz, (step + 1) * bsz)
            keep = [k[step] for k in keeps]
            grads = _grads(model, params, xs[sl], ys[sl], ms[sl], keep, loss_fn)
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
    return params


def row_grads(model, loss_fn: LossFn | None = None):
    """``grads(params, x, y, mask, keep)`` over stacked rows: params
    ``(M, ...)`` leaves, ``x (M, B, H, W, C)``, ``y``/``mask (M, B)``, each
    keep-mask ``(M, *site)``; row ``m``'s gradient is the gradient of its
    own loss (``torch.func.vmap`` of ``torch.func.grad``)."""
    loss_fn = loss_fn or masked_ce_loss

    def row_loss(params, x, y, mask, keep):
        return loss_fn(model, params, x, y, mask, keep)

    return torch.func.vmap(torch.func.grad(row_loss))


def client_update_rows(model, opt: Optimizer, spec: LocalSpec, params: Params,
                       x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       perms: torch.Tensor, keeps: list[torch.Tensor],
                       loss_fn: LossFn | None = None) -> Params:
    """``client_update`` of ``M`` clients in lockstep: ``params`` stacked
    ``(M, ...)``, ``x (M, pad, H, W, C)``, ``y``/``mask (M, pad)``; the
    draws as tensors, ``perms (M, E, pad)`` (row ``m``'s permutation of
    epoch ``e``) and per dropout site ``keeps[i] (M, E, pad / B, *site)``.
    Returns the stacked new weights.  Nothing here reads a device value on
    the host, so the update can run inside a CUDA graph capture."""
    m, n_pad = y.shape
    bsz = spec.batch_size
    if n_pad % bsz:
        raise ValueError(f"pad {n_pad} is not a multiple of batch_size {bsz}")
    if not params:
        return params
    grads_of = row_grads(model, loss_fn)
    state = opt.init(params)
    rows = torch.arange(m, device=y.device)[:, None]
    for epoch in range(spec.epochs):
        for step in range(n_pad // bsz):
            idx = perms[:, epoch, step * bsz:(step + 1) * bsz]
            keep = [k[:, epoch, step] for k in keeps]
            grads = grads_of(params, x[rows, idx], y[rows, idx], mask[rows, idx],
                             keep)
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
