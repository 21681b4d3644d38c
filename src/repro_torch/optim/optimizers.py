"""Functional optimizers over parameter dicts (no ``torch.optim``).

The calling convention is the reference's (``repro/optim/optimizers.py``):

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Adam is written out as the reference computes it, op for op in fp32:
``u = -lr * mhat / (sqrt(vhat) + eps)`` with ``mhat = m / (1 - b1**t)`` and
``vhat = v / (1 - b2**t)``, the bias corrections in fp32.  The list ops are
``torch._foreach_*`` so a step costs a few launches on the card, each a
separately rounded elementwise op as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], dict]
    update: Callable[..., tuple[Params, dict]]


def apply_updates(params: Params, updates: Params) -> Params:
    keys = list(params)
    new = torch._foreach_add([params[k] for k in keys],
                             [updates[k] for k in keys])
    return dict(zip(keys, new))


def sgd(learning_rate: float, momentum: float = 0.0,
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
        updates = torch._foreach_mul(eff, -learning_rate)
        return dict(zip(keys, updates)), {"step": state["step"] + 1,
                                          "momentum": new_mom}

    return Optimizer(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
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
        updates = torch._foreach_div(torch._foreach_mul(mhat, -learning_rate),
                                     denom)
        return dict(zip(keys, updates)), {"step": step,
                                          "mu": dict(zip(keys, mu)),
                                          "nu": dict(zip(keys, nu))}

    return Optimizer(init, update)
