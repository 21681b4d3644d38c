"""Learning-rate schedules: callables ``step -> lr`` (a 0-d float32 tensor),
computed in float32 as ``repro/optim/schedules.py`` computes them."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.0):
    def fn(step):
        t = torch.clamp(_f32(step) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(decay_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
