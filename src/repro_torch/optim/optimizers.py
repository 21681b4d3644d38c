"""Functional optimizers over parameter dicts (no ``torch.optim``).

The calling convention is the reference's (``repro/optim/optimizers.py``):

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Adam is written out as the reference computes it, op for op in fp32:
``u = -lr * mhat / (sqrt(vhat) + eps)`` with ``mhat = m / (1 - b1**t)`` and
``vhat = v / (1 - b2**t)``, the bias corrections in fp32; AdamW then
subtracts ``lr * weight_decay * p``.  The list ops are ``torch._foreach_*``
so a step costs a few launches on the card, each a separately rounded
elementwise op as in the reference.  A learning rate may be a schedule,
``step -> lr`` (``optim/schedules.py``), read at the 1-based step.

The step count, the bias corrections and the rate are host floats, and no
step reads a device value, so an update can be captured in a CUDA graph
(``core/engine.py``): the capture bakes those floats in, which is right
because every replay runs the same steps from a fresh state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

Params = dict[str, torch.Tensor]
LearningRate = float | Callable[[int], torch.Tensor]


def _lr_at(learning_rate: LearningRate, step: int) -> float:
    """The rate at ``step`` as the fp32 value the reference multiplies by."""
    if callable(learning_rate):
        return float(torch.as_tensor(learning_rate(step), dtype=torch.float32))
    return learning_rate


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], dict]
    update: Callable[..., tuple[Params, dict]]


def apply_updates(params: Params, updates: Params) -> Params:
    keys = list(params)
    new = torch._foreach_add([params[k] for k in keys],
                             [updates[k] for k in keys])
    return dict(zip(keys, new))


def sgd(learning_rate: LearningRate, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        mom = {k: torch.zeros_like(p) for k, p in params.items()} \
            if momentum else None
        return {"step": 0, "momentum": mom}

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        if momentum:
            mom = torch._foreach_add(
                torch._foreach_mul([state["momentum"][k] for k in keys],
                                   momentum), g)
            eff = torch._foreach_add(torch._foreach_mul(mom, momentum), g) \
                if nesterov else mom
            new_mom = dict(zip(keys, mom))
        else:
            eff, new_mom = g, None
        # the reference reads a schedule at the 0-based step here
        updates = torch._foreach_mul(eff, -_lr_at(learning_rate, state["step"]))
        return dict(zip(keys, updates)), {"step": state["step"] + 1,
                                          "momentum": new_mom}

    return Optimizer(init, update)


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam, or AdamW with ``weight_decay`` (decoupled: ``u -= lr * wd * p``,
    which needs ``params`` in ``update``)."""
    def init(params):
        return {"step": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        step = state["step"] + 1
        keys = list(grads)
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(
            torch._foreach_mul([state["mu"][k] for k in keys], b1),
            torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(
            torch._foreach_mul([state["nu"][k] for k in keys], b2),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        # bias corrections as fp32 scalars, like the reference's
        # ``1 - b ** step.astype(float32)``
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        mhat = torch._foreach_div(mu, bc1)
        vhat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
        lr = _lr_at(learning_rate, step)
        updates = torch._foreach_div(torch._foreach_mul(mhat, -lr), denom)
        if weight_decay and params is not None:
            # lr * wd as the reference rounds it: in fp32 when lr is a
            # schedule's fp32 value, as one double product otherwise
            coef = float(torch.tensor(lr, dtype=torch.float32) * weight_decay) \
                if callable(learning_rate) else lr * weight_decay
            updates = torch._foreach_sub(
                updates, torch._foreach_mul([params[k] for k in keys], coef))
        return dict(zip(keys, updates)), {"step": step,
                                          "mu": dict(zip(keys, mu)),
                                          "nu": dict(zip(keys, nu))}

    return Optimizer(init, update)


def adamw(learning_rate: LearningRate, weight_decay: float = 0.01,
          **kw) -> Optimizer:
    return adam(learning_rate, weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale every gradient by ``min(1, max_norm / ||g||)`` with ``||g||``
    the fp32 norm over all leaves -- of one model: over stacked ``(M, ...)``
    rows it would mix the rows' norms (the lockstep rows do not clip)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}
