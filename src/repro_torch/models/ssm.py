"""Mamba-2 SSD layer pieces (``repro/models/ssm.py``), chunked.

The selective SSM per head (A scalar, one B/C group)

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,    y_t = C_t h_t + D x_t

runs in chunks of L: the intra-chunk block (``y_diag``, the chunk's
outgoing state and its decay) is the ``ssd_chunk`` kernel, and its
gradient the ``ssd_chunk_bwd`` kernel; the recurrence over chunks, the
inter-chunk output ``y_off`` and the ``D`` skip are torch, differentiated
by autograd (the reference leaves them to XLA, outside any Pallas kernel).

Shapes: x (b, l, h, p); dt (b, l, h); B, C (b, l, n); A (h,); D (h,).
The state is (b, h, p, n) fp32, the conv tail (b, k-1, channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                  tail: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq: ``x (bt, l, c)``, ``w (k, c)``.
    Returns ``(y, new_tail)``; the tail carries the last k-1 inputs."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                        # (bt, l+k-1, c)
    l = x.shape[1]
    y = xp[:, 0:l] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + l] * w[i]
    if b is not None:
        y = y + b
    return y, xp[:, -(k - 1):]


def dt_and_A(dt: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's step sizes ``softplus(dt + dt_bias)`` and decay rates
    ``A = -exp(A_log)``, fp32, for the heads ``dt_bias`` and ``A_log``
    hold."""
    dt = torch.logaddexp(dt.to(torch.float32) + dt_bias.to(torch.float32),
                         torch.zeros((), device=dt.device))              # softplus
    return dt, -torch.exp(A_log.to(torch.float32))


def gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The scan's output gated by ``silu(z)`` (fp32, cast to ``y``'s
    dtype), ahead of the gated RMS norm."""
    return y * F.silu(z.to(torch.float32)).to(y.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, D: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns ``y (b, l, h, p)`` in ``x``'s dtype and
    the final state ``(b, h, p, n)`` fp32.  ``l`` must be a multiple of
    ``chunk``.

    The kernel takes fp32 copies of x, B and C, so ``y_diag`` stays fp32
    until ``y_off`` and the skip are added, as in the reference."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    c = l // chunk
    f32 = torch.float32
    xc = x.reshape(b, c, chunk, h, p).to(f32).contiguous()
    dtc = dt.reshape(b, c, chunk, h).to(f32).contiguous()
    Bc = B.reshape(b, c, chunk, n).to(f32).contiguous()
    Cc = C.reshape(b, c, chunk, n).to(f32).contiguous()
    Af = A.to(f32).contiguous()
    y_diag, S, g = ops.ssd_chunk(xc, dtc, Af, Bc, Cc)       # S (b, c, h, n, p)

    state = torch.zeros(b, h, p, n, dtype=f32, device=x.device) if init_state is None \
        else init_state.to(f32)
    s_pn = S.transpose(-1, -2)                              # (b, c, h, p, n)
    h_prev = torch.empty(b, c, h, p, n, dtype=f32, device=x.device)
    for ci in range(c):
        h_prev[:, ci] = state
        state = g[:, ci, :, None, None] * state + s_pn[:, ci]

    decay_in = torch.exp(torch.cumsum(dtc * Af, dim=2))     # (b, c, L, h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, h_prev) * decay_in[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p) + D.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update: ``x (b, h, p)``, ``dt (b, h)``, ``B, C
    (b, n)``, ``state (b, h, p, n)`` fp32."""
    f32 = torch.float32
    dtf, xf = dt.to(f32), x.to(f32)
    g = torch.exp(dtf * A.to(f32))                          # (b, h)
    upd = dtf[:, :, None, None] * B.to(f32)[:, None, None, :] * xf[..., None]
    state = g[..., None, None] * state + upd
    y = torch.einsum("bn,bhpn->bhp", C.to(f32), state)
    y = y + D.to(f32)[None, :, None] * xf
    return y.to(x.dtype), state
