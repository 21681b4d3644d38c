"""Plain PyTorch versions of the port's three CUDA kernels.

Each function computes what its kernel computes, with ordinary tensor ops
on whatever device its inputs are on.  ``ops`` takes them for CPU tensors;
on the card they are the yardstick each kernel is held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.distribution import merged_kld_scores


def normalized_weights(weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6 weights ``w / sum(w)`` in fp32 (zero rows stay exact zeros)."""
    w = weights.to(torch.float32)
    return w / w.sum().clamp_min(1e-12)


def fedavg_agg(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6: ``out[n] = sum_m (w_m / sum w) * deltas[m, n]``, fp32
    accumulate, result in ``deltas``' dtype.  ``deltas (M, N)``,
    ``weights (M,)`` raw sizes."""
    wn = normalized_weights(weights)
    return (wn[:, None] * deltas.to(torch.float32)).sum(0).to(deltas.dtype)


def kld_greedy_picks(client_counts: torch.Tensor, gamma: int) -> torch.Tensor:
    """The whole Alg. 3 pass: ``(K, C)`` histograms -> ``(K,)`` int32
    absorption order.  Each step scores every client against the open
    mediator, masks the picked ones to +inf, takes the first minimum
    (lowest client id among ties), folds the pick in, and opens a fresh
    mediator after every ``gamma`` picks."""
    counts = client_counts.to(torch.float32)
    k, c = counts.shape
    picked = torch.zeros(k, dtype=torch.bool, device=counts.device)
    med = torch.zeros(c, dtype=torch.float32, device=counts.device)
    inf = torch.tensor(float("inf"), device=counts.device)
    picks = torch.empty(k, dtype=torch.int32, device=counts.device)
    fill = 0
    for s in range(k):
        scores = torch.where(picked, inf, merged_kld_scores(med, counts))
        pick = torch.argmin(scores)             # first minimum
        picks[s] = pick
        picked[pick] = True
        med = med + counts[pick]
        fill += 1
        if fill == gamma:
            med = torch.zeros_like(med)
            fill = 0
    return picks


def warp_coords(h: int, w: int, mats: torch.Tensor, trans: torch.Tensor):
    """Inverse-mapped source coordinates ``(B, H, W)`` of every output
    pixel: ``mat @ (iy - cy, ix - cx) + (cy, cx) + t``, in the kernel's
    op order."""
    dev = mats.device
    iy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = (iy - cy).expand(h, w), (ix - cx).expand(h, w)
    m = mats.to(torch.float32)[:, :, :, None, None]         # (B, 2, 2, 1, 1)
    t = trans.to(torch.float32)[:, :, None, None]           # (B, 2, 1, 1)
    sy = m[:, 0, 0] * dy + m[:, 0, 1] * dx + cy + t[:, 0]
    sx = m[:, 1, 0] * dy + m[:, 1, 1] * dx + cx + t[:, 1]
    return sy, sx


def affine_warp(images: torch.Tensor, mats: torch.Tensor,
                trans: torch.Tensor) -> torch.Tensor:
    """Bilinear inverse-affine warp about the image centre, zero outside.

    ``images (B, H, W, C)`` float32, ``mats (B, 2, 2)``, ``trans (B, 2)``.
    The four taps of every output pixel are gathered directly; a tap
    outside ``[0, H-1] x [0, W-1]`` gets weight 0."""
    b, h, w, c = images.shape
    sy, sx = warp_coords(h, w, mats, trans)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    flat = images.reshape(b, h * w, c)
    out = torch.zeros_like(flat)
    for oy, ox in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + oy, x0 + ox
        wgt = (fy if oy else 1.0 - fy) * (fx if ox else 1.0 - fx)
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        wgt = torch.where(valid, wgt, torch.zeros((), device=wgt.device))
        src = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        tap = torch.gather(flat, 1, src.reshape(b, h * w, 1).expand(b, h * w, c))
        out = out + wgt.reshape(b, h * w, 1) * tap
    return out.reshape(b, h, w, c)
