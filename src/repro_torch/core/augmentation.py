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

Materialized (the paper's deployment, Alg. 2 lines 8-13): before training
every client appends ``plan[y]`` warped copies of each of its samples and
shuffles; ``rebalance_federation`` warps the whole federation's copies in
one ``affine_warp`` launch.  Its draws -- each client's shuffle seed and
warp parameters -- come from ``draws.rebalance`` (``core/draws.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops

AUG_MODES = (None, "online", "materialized")


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


# --------------------------------------------------------------------------
# Materialized client rebalance (Alg. 2 lines 8-13)
# --------------------------------------------------------------------------

def random_affine(image: torch.Tensor, mat: torch.Tensor,
                  trans: torch.Tensor) -> torch.Tensor:
    """One inverse-affine warp of an ``(H, W, C)`` image about its centre
    (bilinear, zero outside) with the drawn ``mat (2, 2)`` and ``trans
    (2,)``."""
    return ops.affine_warp(image[None].contiguous(), mat[None].contiguous(),
                           trans[None].contiguous())[0]


def augment_batch(images: torch.Tensor, n_copies: int, mats: torch.Tensor,
                  trans: torch.Tensor) -> torch.Tensor:
    """``n_copies`` warps of each image, copy-major: ``(n, H, W, C)`` ->
    ``(n * n_copies, H, W, C)`` where row ``c * n + i`` warps image ``i``
    with ``mats[c * n + i]``, ``trans[c * n + i]``; one warp launch."""
    tiled = images.repeat(n_copies, *([1] * (images.dim() - 1)))
    return ops.affine_warp(tiled.contiguous(), mats.contiguous(), trans.contiguous())


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _source_rows(labels: np.ndarray, plan: np.ndarray) -> np.ndarray:
    """Source index of each augmentation of a client: sample ``i`` repeated
    ``plan[labels[i]]`` times."""
    return np.repeat(np.arange(labels.shape[0]), np.asarray(plan)[labels])


def _append_and_shuffle(images: np.ndarray, labels: np.ndarray, reps: np.ndarray,
                        aug: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Alg. 2 line 13: originals plus augmentations, shuffled by
    ``default_rng(seed)``.  The reference pads the warp stack to a power of
    two with ``rng.choice`` before it shuffles; the same draw is taken here
    so the shuffle sees the same generator state."""
    rng = np.random.default_rng(seed)
    if reps.size == 0:
        perm = rng.permutation(images.shape[0])
        return images[perm], labels[perm]
    total_pad = _next_pow2(reps.size)
    if total_pad != reps.size:
        rng.choice(reps, total_pad - reps.size)
    out_x = np.concatenate([images, aug.astype(images.dtype)])
    out_y = np.concatenate([labels, labels[reps]])
    perm = rng.permutation(out_x.shape[0])
    return out_x[perm], out_y[perm]


def rebalance_client(images: np.ndarray, labels: np.ndarray,
                     n_aug_per_class: np.ndarray, seed: int, mats: torch.Tensor,
                     trans: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Apply the server's plan to one client's local dataset: one warp
    launch over its augmentations (on ``mats``' device), appended and
    shuffled.  ``mats (n, 2, 2)``/``trans (n, 2)`` hold one draw per
    augmentation, ``n = sum(n_aug_per_class[labels])``."""
    images, labels = np.asarray(images), np.asarray(labels)
    reps = _source_rows(labels, n_aug_per_class)
    aug = np.zeros((0,) + images.shape[1:], np.float32)
    if reps.size:
        src = torch.from_numpy(np.ascontiguousarray(images[reps], np.float32))
        aug = ops.affine_warp(src.to(mats.device), mats.contiguous(),
                              trans.contiguous()).cpu().numpy()
    return _append_and_shuffle(images, labels, reps, aug, seed)


def rebalance_federation(client_images: list[np.ndarray],
                         client_labels: list[np.ndarray], num_classes: int,
                         alpha: float, draws, device: torch.device | str = "cpu"):
    """End-to-end Alg. 2 over a federation.  Every client's augmentations
    go through ONE ``affine_warp`` launch on ``device``; client ``i``'s
    draws are ``draws.rebalance(i, n_i)``.

    Returns ``(new_client_images, new_client_labels, plan,
    extra_storage_frac)``."""
    counts = np.zeros(num_classes)
    for y in client_labels:
        counts += np.bincount(y, minlength=num_classes)
    plan = augmentation_plan(counts, alpha)
    reps = [_source_rows(np.asarray(y), plan) for y in client_labels]
    drawn = [draws.rebalance(i, r.size) for i, r in enumerate(reps)]
    total = sum(r.size for r in reps)
    warped = np.zeros((0,), np.float32)
    if total:
        src = np.concatenate([np.asarray(x, np.float32)[r]
                              for x, r in zip(client_images, reps)])
        mats = torch.cat([d[1].to(device) for d in drawn]).contiguous()
        trans = torch.cat([d[2].to(device) for d in drawn]).contiguous()
        warped = ops.affine_warp(torch.from_numpy(src).to(device), mats,
                                 trans).cpu().numpy()
    out_x, out_y, start = [], [], 0
    for x, y, r, (seed, _, _) in zip(client_images, client_labels, reps, drawn):
        cx, cy = _append_and_shuffle(np.asarray(x), np.asarray(y), r,
                                     warped[start:start + r.size], seed)
        start += r.size
        out_x.append(cx)
        out_y.append(cy)
    before = sum(x.shape[0] for x in client_images)
    after = sum(x.shape[0] for x in out_x)
    return out_x, out_y, plan, (after - before) / max(before, 1)


class AugPhase(NamedTuple):
    """Resolved Alg. 2 initialization phase (``resolve_aug_mode``)."""
    data: object                    # FederatedDataset (rebuilt if materialized)
    plan: np.ndarray | None         # the server's n_aug array (None = NoAug)
    engine_plan: np.ndarray | None  # plan to hand the round engine (online)
    extra_storage_frac: float       # realized (materialized mode only)
    planned_extra_frac: float       # what materializing would cost
    mode: str | None                # effective mode after the alpha gate


def resolve_aug_mode(data, alpha: float | None, aug_mode: str | None, *,
                     draws=None, device: torch.device | str = "cpu") -> AugPhase:
    """The trainers' shared Alg. 2 phase.  ``alpha=None`` disables
    augmentation whatever ``aug_mode``; ``"materialized"`` rebuilds the
    federation up front with ``draws`` on ``device``; ``"online"`` returns
    the plan for the engine's in-round pipeline, or no engine plan when it
    is all zero (nothing to augment)."""
    if aug_mode not in AUG_MODES:
        raise ValueError(f"unknown aug_mode {aug_mode!r}; "
                         f"expected one of {AUG_MODES}")
    mode = aug_mode if alpha is not None else None
    if mode is None:
        return AugPhase(data, None, None, 0.0, 0.0, None)
    counts = data.client_counts().sum(axis=0)
    planned = planned_counts(counts, alpha)
    planned_frac = float(planned.sum() / max(counts.sum(), 1.0) - 1.0)
    if mode == "materialized":
        cx, cy, plan, extra = rebalance_federation(
            data.client_images, data.client_labels, data.num_classes, alpha,
            draws, device)
        data = dataclasses.replace(data, client_images=cx, client_labels=cy)
        return AugPhase(data, plan, None, extra, planned_frac, mode)
    plan = augmentation_plan(counts, alpha)
    return AugPhase(data, plan, plan if plan.any() else None, 0.0, planned_frac,
                    mode)


def resolve_engine_plan(phase: AugPhase, adaptive_plan: bool,
                        alpha: float | None
                        ) -> tuple[np.ndarray | None, float | None]:
    """Both trainers' adaptive-plan resolution: ``(engine_plan,
    adaptive_aug_alpha)`` for the engine.  Adaptive mode needs the online
    pipeline and installs the in-round plan even when the initial plan is
    all zero (a later cohort may need one); the static path keeps the
    zero-plan fast path (no plan, no resample)."""
    if not adaptive_plan:
        return phase.engine_plan, None
    if phase.mode != "online":
        raise ValueError("adaptive_plan requires aug_mode='online' with "
                         "alpha set (the plan must live inside the round "
                         "to be refreshed)")
    return phase.plan, alpha
