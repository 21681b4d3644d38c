"""Mediator update (Alg. 1, MediatorUpdate).

Within one mediator the assigned clients train sequentially -- client i+1
starts from client i's weights -- for ``E_m`` mediator epochs; the mediator
returns the weight delta relative to the weights it received.  Slots run
in order, every one of the ``gamma`` slots, as the reference's scan does
(``repro/core/mediator.py``): a slot the schedule left empty has a zero
mask, so its gradients are exactly zero -- a no-op under Adam, while
AdamW's decoupled decay ``-lr * wd * p`` still applies at each of its
steps, in both packages.

``mediator_update_rows`` runs ``M`` mediators in lockstep: slot ``s`` of
every row trains together (``fl.client_update_rows``), each slot with a
fresh Adam state; an empty slot or a dummy row runs with its zero mask,
as in ``mediator_update``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.draws import ClientDraws
from repro_torch.core.fl import LocalSpec, LossFn, client_update, client_update_rows
from repro_torch.models.cnn import Params
from repro_torch.optim.optimizers import Optimizer


def mediator_update(model, opt: Optimizer, local: LocalSpec,
                    mediator_epochs: int, params: Params, xs: torch.Tensor,
                    ys: torch.Tensor, masks: torch.Tensor,
                    draws_for: Callable[[int, int], ClientDraws],
                    loss_fn: LossFn | None = None) -> Params:
    """``xs (gamma, pad, H, W, C)``, ``ys``/``masks (gamma, pad)``;
    ``draws_for(mediator_epoch, slot)`` gives each client update's draws;
    ``loss_fn`` replaces the masked cross-entropy (``core/fl.py``).
    Returns ``trained - params``."""
    gamma = xs.shape[0]
    w = params
    for epoch in range(mediator_epochs):
        for slot in range(gamma):
            w = client_update(model, opt, local, w, xs[slot], ys[slot],
                              masks[slot], draws_for(epoch, slot), loss_fn)
    return {k: w[k] - params[k] for k in params}


def mediator_update_rows(model, opt: Optimizer, local: LocalSpec,
                         mediator_epochs: int, params: Params, xs: torch.Tensor,
                         ys: torch.Tensor, masks: torch.Tensor,
                         perms: torch.Tensor, keeps: list[torch.Tensor],
                         loss_fn: LossFn | None = None) -> Params:
    """``mediator_update`` of ``M`` rows at once: ``params`` stacked ``(M,
    ...)``, ``xs (M, gamma, pad, H, W, C)``, ``ys``/``masks (M, gamma,
    pad)``; the draws ``perms (M, gamma, E_m, E, pad)`` and per dropout
    site ``keeps[i] (M, gamma, E_m, E, pad / B, *site)``.  Returns the
    stacked ``trained - params``."""
    w = params
    for epoch in range(mediator_epochs):
        for slot in range(xs.shape[1]):
            w = client_update_rows(model, opt, local, w, xs[:, slot], ys[:, slot],
                                   masks[:, slot], perms[:, slot, epoch],
                                   [k[:, slot, epoch] for k in keeps], loss_fn)
    return {k: w[k] - params[k] for k in params}
