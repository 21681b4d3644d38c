"""Transformer layers of the port's model zoo (``repro/models/layers.py``).

Activations are ``(batch, seq, d_model)``; attention tensors keep the
reference's model layout ``(batch, seq, heads, head_dim)``; weights are
``(d_in, d_out)``, so a projection is ``x @ w``.  Prefill and training
attention always go through the flash kernel (``kernels.ops``); the
reference's ``attention_scores``, ``blockwise_attention`` and
``local_window_attention`` are XLA lowerings of the same function.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             var: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 RMS norm with a zero-centred scale ``(1 + scale)``; ``var`` the
    rows' fp32 mean square where it comes from elsewhere (a row split over
    a model axis), else ``x``'s."""
    xf = x.to(torch.float32)
    if var is None:
        var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm; the output is multiplied by ``scale`` itself (the
    reference's ``layer_norm``; not the ``1 + scale`` of ``rms_norm``)."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding on halves.  ``x (..., seq, heads, head_dim)``,
    ``positions (..., seq)``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs      # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """GQA: ``q (b, sq, H, d)`` against ``k, v (b, skv, KV, d)``; query head
    ``h`` reads KV head ``h // (H/KV)`` (the reference's repeat order)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: int | None = None) -> torch.Tensor:
    """One-token decode: ``q (b, 1, H, d)`` against a ``(b, S, KV, d)``
    cache; slots ``>= cache_len`` (``(b,)`` or ``(1,)``) are masked.  Scores
    and softmax in fp32, probabilities rounded to ``q``'s dtype before the
    value product, as the reference does."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache).to(torch.float32) \
        * (1.0 / math.sqrt(d))
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    kpos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    valid = kpos < cache_len[:, None]                               # (b, S)
    if window is not None:
        valid &= kpos >= cache_len[:, None] - window
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v_cache).reshape(b, 1, h, d)


def act_fn(activation: str = "silu"):
    """SiLU, or GELU with ``jax.nn.gelu``'s default tanh approximation."""
    return (lambda t: F.gelu(t, approximate="tanh")) if activation == "gelu" else F.silu


def glu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU."""
    return (act_fn(activation)(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
        b_out: torch.Tensor) -> torch.Tensor:
    """The biased GELU MLP (Whisper's), ``jax.nn.gelu``'s tanh approximation."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out
