"""Mediator update (Alg. 1, MediatorUpdate).

Within one mediator the assigned clients train sequentially -- client i+1
starts from client i's weights -- for ``E_m`` mediator epochs; the mediator
returns the weight delta relative to the weights it received.  Slots run
in order; a slot the schedule left empty (``active[slot]`` false) is an
exact no-op and is skipped.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.draws import ClientDraws
from repro_torch.core.fl import LocalSpec, LossFn, client_update
from repro_torch.models.cnn import Params
from repro_torch.optim.optimizers import Optimizer


def mediator_update(model, opt: Optimizer, local: LocalSpec,
                    mediator_epochs: int, params: Params, xs: torch.Tensor,
                    ys: torch.Tensor, masks: torch.Tensor,
                    draws_for: Callable[[int, int], ClientDraws],
                    active: Sequence[bool] | None = None,
                    loss_fn: LossFn | None = None) -> Params:
    """``xs (gamma, pad, H, W, C)``, ``ys``/``masks (gamma, pad)``;
    ``draws_for(mediator_epoch, slot)`` gives each client update's draws;
    ``loss_fn`` replaces the masked cross-entropy (``core/fl.py``).
    Returns ``trained - params``."""
    gamma = xs.shape[0]
    w = params
    for epoch in range(mediator_epochs):
        for slot in range(gamma):
            if active is not None and not active[slot]:
                continue
            w = client_update(model, opt, local, w, xs[slot], ys[slot],
                              masks[slot], draws_for(epoch, slot), loss_fn)
    return {k: w[k] - params[k] for k in params}
