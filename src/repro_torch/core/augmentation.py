"""Algorithm 2 -- global data distribution based data augmentation.

Server side (numpy, copied from ``repro/core/augmentation.py``): every class
below the mean count ``C_bar`` gets ``round((C_bar / C_y) ** alpha)``
augmentations per sample.

Client side, online: each round every scheduled client's padded batch is
redrawn by a fixed-shape class-conditional resample + warp.  Output slot
``i`` draws its source sample from the categorical with weights
``mask * (1 + plan[y])`` and is a warped copy with probability
``plan[y] / (1 + plan[y])``, so the expected class mixture is exactly
``planned_counts`` normalized.  The warp goes through
``kernels.ops.affine_warp`` -- one launch for a whole round's slots.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

AUG_MODES = (None, "online")


# --------------------------------------------------------------------------
# Server-side plan (Alg. 2 lines 1-6)
# --------------------------------------------------------------------------

def augmentation_plan(global_counts: np.ndarray, alpha: float) -> np.ndarray:
    """Per-class number of augmentations per existing sample: 0 for classes
    at/above the mean or empty, else ``round((C_bar / C_i) ** alpha)``."""
    counts = np.asarray(global_counts, np.float64)
    if counts.ndim != 1:
        raise ValueError(f"global_counts must be 1-D, got shape {counts.shape}")
    c_bar = counts.mean()
    n_aug = np.zeros(counts.shape, np.int64)
    grow = (counts > 0) & (counts < c_bar)
    n_aug[grow] = np.rint((c_bar / counts[grow]) ** alpha).astype(np.int64)
    return n_aug


def planned_counts(global_counts: np.ndarray, alpha: float) -> np.ndarray:
    """Post-augmentation expected global counts."""
    counts = np.asarray(global_counts, np.float64)
    return counts * (1 + augmentation_plan(counts, alpha))


def online_mixture(global_counts: np.ndarray, alpha: float) -> np.ndarray:
    """Expected class distribution of ONE online draw: ``planned_counts``
    normalized to 1."""
    planned = planned_counts(global_counts, alpha)
    return planned / max(planned.sum(), 1.0)


# --------------------------------------------------------------------------
# Client-side primitives (Alg. 2 line 11, ``Augment``)
# --------------------------------------------------------------------------

def affine_from_uniform(u: torch.Tensor, *, shift: float = 3.0, rot: float = 0.3,
                        shear: float = 0.2, zoom: float = 0.15):
    """Map ``(n, 6)`` uniforms in [0, 1) to ``(n, 2, 2)`` inverse maps and
    ``(n, 2)`` translations: rotation, shear and zoom about the centre."""
    def between(x, lo, hi):
        return x * (hi - lo) + lo
    theta = between(u[:, 0], -rot, rot)
    sh = between(u[:, 1], -shear, shear)
    zx = 1.0 + between(u[:, 2], -zoom, zoom)
    zy = 1.0 + between(u[:, 3], -zoom, zoom)
    trans = between(u[:, 4:6], -shift, shift)
    cos, sin = torch.cos(theta), torch.sin(theta)
    mats = torch.stack([torch.stack([cos / zx, (sin + sh) / zx], -1),
                        torch.stack([-sin / zy, cos / zy], -1)], -2)
    return mats, trans.contiguous()


def warp_params(n: int, *, generator: torch.Generator,
                device: torch.device | str = "cpu", **kw):
    """``n`` independent random affine draws: ``(n, 2, 2)`` mats and
    ``(n, 2)`` translations."""
    u = torch.rand((n, 6), generator=generator, device=device)
    return affine_from_uniform(u, **kw)


def warp_batch(images: torch.Tensor, *, generator: torch.Generator, **kw
               ) -> torch.Tensor:
    """One random affine warp of every image in ``(B, H, W, C)``."""
    mats, trans = warp_params(images.shape[0], generator=generator,
                              device=images.device, **kw)
    return ops.affine_warp(images, mats, trans)


def online_augment_rows(x: torch.Tensor, y: torch.Tensor, plan: torch.Tensor,
                        idx: torch.Tensor, u: torch.Tensor, mats: torch.Tensor,
                        trans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Resample + warp ``R`` padded client batches at once.

    ``x (R, pad, H, W, C)``, ``y (R, pad)``; ``plan (num_classes,)``; the
    draws ``idx (R, pad)`` source indices, ``u (R, pad)`` uniforms, ``mats
    (R*pad, 2, 2)`` and ``trans (R*pad, 2)``.  All ``R*pad`` warps are one
    ``ops.affine_warp`` call.  Returns ``(x_drawn, y_drawn)``."""
    r, pad = y.shape
    rows = torch.arange(r, device=x.device)[:, None]
    sx, sy = x[rows, idx], y[rows, idx]
    s_mult = 1.0 + plan.to(torch.float32)[sy.long()]
    p_aug = (s_mult - 1.0) / s_mult                # n_aug / (1 + n_aug)
    is_aug = u < p_aug
    warped = ops.affine_warp(sx.reshape((r * pad,) + sx.shape[2:]).contiguous(),
                             mats.contiguous(), trans.contiguous())
    sel = is_aug.reshape(is_aug.shape + (1,) * (x.dim() - 2))
    return torch.where(sel, warped.reshape(sx.shape), sx), sy


def online_augment_batch(x: torch.Tensor, y: torch.Tensor, plan: torch.Tensor,
                         draws) -> tuple[torch.Tensor, torch.Tensor]:
    """One padded client batch ``x (pad, H, W, C)``, ``y (pad,)`` with its
    draws ``(idx, u, mats, trans)``."""
    idx, u, mats, trans = draws
    ax, ay = online_augment_rows(x[None], y[None], plan, idx[None], u[None],
                                 mats, trans)
    return ax[0], ay[0]
