"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with ordinary tensor ops
on whatever device its inputs are on.  ``ops`` takes them for CPU tensors;
on the card they are the yardstick each kernel is held against.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distribution import kld_to_uniform, merged_kld_scores


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


def kld_score(mediator_counts: torch.Tensor,
              client_counts: torch.Tensor) -> torch.Tensor:
    """Alg. 3 scores ``D_KL(normalize(med + c_k) || U)``: ``(C,)`` and
    ``(K, C)`` -> ``(K,)`` float32 (``merged_kld_scores``)."""
    return merged_kld_scores(mediator_counts, client_counts)


def kld_score_matrix(mediator_counts: torch.Tensor,
                     client_counts: torch.Tensor) -> torch.Tensor:
    """``kld_score`` of every mediator row: ``(M, C)`` and ``(K, C)`` ->
    ``(M, K)`` float32."""
    merged = mediator_counts.to(torch.float32)[:, None, :] \
        + client_counts.to(torch.float32)[None, :, :]
    return kld_to_uniform(merged)


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


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None,
                   q_offset: int, device) -> torch.Tensor:
    """``(sq, skv)`` bool: key ``j`` is visible to query ``i`` (absolute
    position ``q_offset + i``) under the causal and sliding-window masks."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention in the model layout: ``q (b, sq, H, d)``, ``k, v
    (b, skv, KV, d)`` with query head ``h`` reading KV head ``h // (H/KV)``.
    Returns ``(b, sq, H, d)`` in ``q``'s dtype.

    The flash kernel's arithmetic on the whole row at once: fp32 scores
    scaled by ``1/sqrt(d)``, masked scores ``-1e30``, ``p = exp(s - max)``
    with masked ``p`` set to 0, fp32 ``p @ v``, denominator
    ``max(l, 1e-30)`` (a row with no visible key gives zeros)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    qf = q.to(torch.float32).reshape(b, sq, kv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(torch.float32)) * (1.0 / math.sqrt(d))
    mask = attention_mask(sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(-1).clamp_min(1e-30)                          # (b, g, r, q)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v.to(torch.float32))
    out = out / denom[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled visible scores, ``(b, H, sq)``
    fp32, natural log: ``log sum_k exp(q.k / sqrt(d))`` over the keys the
    masks leave it, ``+inf`` for a row that sees no key (so ``exp(s -
    lse)`` is 0 there).  What the forward kernels write for the backward."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.to(torch.float32).reshape(b, sq, kv, h // kv, d),
                     k.to(torch.float32)) * (1.0 / math.sqrt(d))
    mask = attention_mask(sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse, math.inf)
    return lse.reshape(b, h, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention`` from its formula, in fp32:
    ``P = softmax(Q K^T / sqrt(d))`` under the forward's masks (a row with
    no visible key has ``P = 0``), ``D = rowsum(dO * O)`` from the given
    ``out``, ``dS = P * (dO V^T - D)``, ``dQ = dS K / sqrt(d)``, ``dK =
    dS^T Q / sqrt(d)`` and ``dV = P^T dO``, each query head's share summed
    into its KV head.  Returns ``dq, dk, dv`` in the inputs' dtypes."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    qf = q.to(f32).reshape(b, sq, kv, rep, d)
    kf, vf = k.to(f32), v.to(f32)
    do = dout.to(f32).reshape(b, sq, kv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) * scale
    mask = attention_mask(sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dsum = (do * out.to(f32).reshape(b, sq, kv, rep, d)).sum(-1)      # (b, q, g, r)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", do, vf)
    ds = p * (dp - dsum.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf) * scale
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, do)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor):
    """Mamba-2 intra-chunk block for every (batch, chunk, head), fp32
    (float64 for float64 inputs, the tests' exact yardstick).

    ``x (b, nc, L, h, p)``, ``dt (b, nc, L, h)``, ``A (h,)``, ``B, C
    (b, nc, L, n)`` -> ``y_diag (b, nc, L, h, p)`` in ``x``'s dtype,
    ``S (b, nc, h, n, p)`` f32, ``g (b, nc, h)`` f32:

        cum       = cumsum(dt * A[h])
        y_diag_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
        S         = sum_l exp(cum_L - cum_l) dt_l B_l x_l^T
        g         = exp(cum_L)

    The decay is masked to ``-inf`` above the diagonal before ``exp``, so
    it stays finite whatever the segment sums."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    L = x.shape[2]
    cum = torch.cumsum(dtf * A.to(f32), dim=2)                  # (b, nc, L, h)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b, nc, i, j, h)
    tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tril[:, :, None], seg, -math.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    dx = dtf[..., None] * xf                                    # (b, nc, L, h, p)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, dx)
    w = (torch.exp(cum[:, :, -1:, :] - cum) * dtf)[..., None] * Bf[:, :, :, None, :]
    S = torch.einsum("bclhn,bclhp->bchnp", w, xf)
    g = torch.exp(cum[:, :, -1, :])
    return y.to(x.dtype), S, g


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                  dS: torch.Tensor, dg: torch.Tensor):
    """The gradient of ``ssd_chunk`` from its formulas, in fp32 (float64
    for float64 inputs): given the
    output gradients ``dy`` (like ``x``), ``dS (b, nc, h, n, p)`` and ``dg
    (b, nc, h)``, returns ``dx, ddt, dA, dB, dC`` in the inputs' dtypes.

    Per (batch, chunk, head), with ``P_ij = (C_i . B_j) exp(cum_i - cum_j)``
    on the lower triangle (the forward's masked exp), ``M'_ij = P_ij dt_j``,
    ``e_l = exp(cum_L - cum_l)`` and ``W_ls = e_l dt_l B_ls``:

        dx     = M'^T dy + W dS
        dM'    = dy x^T (lower triangle),   dW = x dS^T
        dC     = dCB B,  dB = dCB^T C + sum_h e dt dW,
                 dCB_ij = sum_h dM'_ij exp(cum_i - cum_j) dt_j
        dcum_l = sum_j G_lj - sum_i G_il - H_l,  G = dM' * M' off the
                 diagonal, H_l = sum_s dW_ls W_ls for l < L; cum_L also
                 gets sum_l H_l + dg g (the diagonal of G and H_L, in two
                 terms that cancel, are left out: on steep segments their
                 rounding would swamp dA)
        ddt_l  = A d(dA)_l + sum_i dM'_il P_il + e_l sum_s dW_ls B_ls,
                 d(dA) = reverse-cumsum(dcum)
        dA     = sum_{b, c, l} dt_l d(dA)_l

    cum is summed in float64 and its differences rounded to the working
    type: in fp32 one ulp of a running sum of a few hundred is ~3e-5 of
    absolute error in every exp, which the dt gradient carries."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Af, Bf, Cf = x.to(f32), dt.to(f32), A.to(f32), B.to(f32), C.to(f32)
    dyf, dSf, dgf = dy.to(f32), dS.to(f32), dg.to(f32)
    L = x.shape[2]
    # in float64: each exponent is a difference of two running sums that
    # grow over the chunk (the kernel's rule)
    cum = torch.cumsum(dtf.double() * Af.double(), dim=2)       # (b, nc, L, h)
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(f32)   # (b, nc, i, j, h)
    tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tril[:, :, None], seg, -math.inf))
    P = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None] * decay
    dtj = dtf[:, :, None, :, :]                                 # dt_j over (i, j)
    Mp = P * dtj
    e = torch.exp((cum[:, :, -1:, :] - cum).to(f32))            # (b, nc, L, h)
    W = (e * dtf)[..., None] * Bf[:, :, :, None, :]             # (b, nc, l, h, n)
    dx = torch.einsum("bcijh,bcihp->bcjhp", Mp, dyf) \
        + torch.einsum("bclhn,bchnp->bclhp", W, dSf)
    dM = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf) * tril[:, :, None]
    dW = torch.einsum("bclhp,bchnp->bclhn", xf, dSf)
    dCB = (dM * decay * dtj).sum(-1)                            # (b, nc, i, j)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bf)
    dB = torch.einsum("bcij,bcin->bcjn", dCB, Cf) \
        + torch.einsum("bclhn,bclh->bcln", dW, e * dtf)
    G = dM * Mp * torch.ones(L, L, dtype=torch.bool, device=x.device).tril(-1)[:, :, None]
    H = (dW * W).sum(-1)                                        # (b, nc, l, h)
    H[:, :, -1] = 0.0                   # e_L = 1: cum_L's two terms cancel
    dcum = G.sum(3) - G.sum(2) - H
    dcum[:, :, -1] += H.sum(2) + dgf * torch.exp(cum[:, :, -1].to(f32))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = (dM * P).sum(2) + e * (dW * Bf[:, :, :, None, :]).sum(-1) + Af * ddA
    dA = (dtf * ddA).sum((0, 1, 2))
    return dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype)
