"""The port's config-driven decoder stack (``repro/models/transformer.py``).

Families ported: ``dense`` (GQA + RoPE + GLU, optional QKV bias, qk-norm,
sliding window), ``ssm`` (Mamba-2 SSD blocks) and ``hybrid`` (attention and
SSD heads in parallel on one input, Hymba-style).  ``moe``, ``audio`` and
``vlm`` raise ``NotImplementedError``.

Each decoder layer is an ``nn.Module``; weights keep the reference's
``(d_in, d_out)`` layout and names, so a state dict key is the reference's
pytree path with the stacked layer axis written out
(``layers.3.attn.wq``).  Entry points:

  ``forward_train``    full-sequence causal-LM loss, differentiable in the
                       weights (``model(tokens)`` gives the fp32 logits)
  ``forward_prefill``  full sequence -> last-position logits + decode cache
  ``forward_decode``   one token + cache -> logits; the cache is updated in
                       place (the reference returns a new one)

Training runs attention through the flash kernels' autograd function and
the SSD block through the SSD kernels' (``ops._SSDChunk``): one forward
and one backward launch a layer each, on the card as on the CPU.

The cache keeps the reference's layout, one stacked tensor per leaf with a
leading layer axis: ``{"attn": {"k", "v": (L, b, S, KV, d)}, "ssm":
{"state": (L, b, h, p, n) fp32, "conv": (L, b, k-1, channels)}}`` (an
SSM model's leaves sit under ``"ssm"`` too; the reference keeps them at
the top level).  A
sliding-window cache is a ring of ``S = min(W, budget)`` slots holding
position ``p`` at slot ``p % W``, after prefill as after decode, whatever
the prompt length.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1, \"The rest of the zoo, served\": the MoE family (granite, grok)",
    "audio": "ROADMAP Queue 1, \"The rest of the zoo, served\": the audio family (whisper)",
    "vlm": "ROADMAP Queue 1, \"The rest of the zoo, served\": the VLM family (internvl2)",
}


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.arch_type in _NOT_PORTED or cfg.is_moe:
        family = "moe" if cfg.is_moe else cfg.arch_type
        raise NotImplementedError(f"{cfg.name}: {family} models are not ported "
                                  f"yet ({_NOT_PORTED[family]})")
    if cfg.arch_type not in ("dense", "ssm", "hybrid"):
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


# ==========================================================================
# Parameter specs
# ==========================================================================

@dataclass(frozen=True)
class Spec:
    """One parameter: its shape as the reference declares it (layer weights
    with the leading stacked ``layers`` axis), its init scale (``None``:
    fan-in) and dtype; for the LoRA mapping table (``models/lora.py``) its
    leading batch ``axes`` (``("layers",)`` for a stacked weight) and the
    port's parameter ``names`` it covers, one a layer.  Layouts are the
    reference's (``perm`` None)."""
    shape: tuple[int, ...]
    scale: float | None
    dtype: torch.dtype
    axes: tuple[str, ...] = ()
    names: tuple[str, ...] = ()
    perm = None


def _attn_specs(cfg: ArchConfig, n: int, dt) -> dict[str, Spec]:
    d, hd, H, KV = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    s = {"wq": Spec((n, d, H * hd), None, dt), "wk": Spec((n, d, KV * hd), None, dt),
         "wv": Spec((n, d, KV * hd), None, dt), "wo": Spec((n, H * hd, d), None, dt)}
    if cfg.qkv_bias:
        s.update(bq=Spec((n, H * hd), 0.0, dt), bk=Spec((n, KV * hd), 0.0, dt),
                 bv=Spec((n, KV * hd), 0.0, dt))
    if cfg.qk_norm:
        s.update(q_norm=Spec((n, hd), 0.0, dt), k_norm=Spec((n, hd), 0.0, dt))
    return s


def _ssm_specs(cfg: ArchConfig, n_layers: int, dt) -> dict[str, Spec]:
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "in_proj": Spec((n_layers, d, 2 * di + 2 * n + h), None, dt),
        "conv_w": Spec((n_layers, cfg.conv_kernel, conv_dim), 0.5, dt),
        "conv_b": Spec((n_layers, conv_dim), 0.0, dt),
        "A_log": Spec((n_layers, h), 1.0, dt),
        "D": Spec((n_layers, h), 1.0, dt),
        "dt_bias": Spec((n_layers, h), 0.0, dt),
        "norm": Spec((n_layers, di), 0.0, dt),
        "out_proj": Spec((n_layers, di, d), None, dt),
    }


def param_specs(cfg: ArchConfig) -> dict[str, Spec]:
    """Flat ``{state-dict path with the layer index left out: Spec}``, in
    the reference's order (``transformer.py::param_specs``); ``layers.*``
    specs carry the stacked layer axis."""
    _check_ported(cfg)
    dt, f32 = cfg.torch_dtype(), torch.float32
    d, n = cfg.d_model, cfg.n_layers
    specs = {"embed": Spec((cfg.vocab, d), 1.0 / math.sqrt(d), dt),
             "final_norm": Spec((d,), 0.0, f32)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, cfg.vocab), None, dt)
    lay = {"norm1": Spec((n, d), 0.0, f32)}
    if cfg.arch_type == "ssm":
        lay.update({f"ssm.{k}": v for k, v in _ssm_specs(cfg, n, dt).items()})
    else:
        lay["norm2"] = Spec((n, d), 0.0, f32)
        lay.update({f"attn.{k}": v for k, v in _attn_specs(cfg, n, dt).items()})
        if cfg.arch_type == "hybrid":
            lay.update({f"ssm.{k}": v for k, v in _ssm_specs(cfg, n, dt).items()})
            lay["mix_attn"] = Spec((n, d), 0.0, f32)
            lay["mix_ssm"] = Spec((n, d), 0.0, f32)
        f = cfg.d_ff
        lay.update({"mlp.w_gate": Spec((n, d, f), None, dt),
                    "mlp.w_up": Spec((n, d, f), None, dt),
                    "mlp.w_down": Spec((n, f, d), None, dt)})
    specs = {k: replace(v, names=(k,)) for k, v in specs.items()}
    specs.update({f"layers.{k}": replace(v, axes=("layers",),
                                         names=tuple(f"layers.{i}.{k}" for i in range(n)))
                  for k, v in lay.items()})
    return specs


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for s in param_specs(cfg).values())


def adapter_mapping(cfg: ArchConfig, rank: int, alpha: float | None = None) -> dict:
    """The LoRA mapping table over this architecture's specs
    (``models/lora.py``), keyed like the reference's by ``/``-joined path."""
    from repro_torch.models import lora
    return lora.build_mapping(param_specs(cfg), rank, alpha)


def _init_leaf(spec: Spec, generator: torch.Generator, device) -> torch.Tensor:
    """The reference's rule (``layers.py::LogicalParam.init``) on the shape
    it declares: fan-in scale ``1/sqrt(shape[0])`` -- for a stacked layer
    weight that is the layer count, as in the reference -- zeros for scale
    0, ones for a 1-D spec with scale 1, else ``normal * scale``."""
    scale = spec.scale
    if scale is None:
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else 1
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    if scale == 0.0:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if scale == 1.0 and len(spec.shape) == 1:
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(spec.dtype)


# ==========================================================================
# Modules
# ==========================================================================

class _Params(nn.Module):
    """A module whose parameters are named tensors of given shapes.  They
    carry no gradient: training differentiates a dict of them
    (``forward_train(model, batch, params)``)."""

    def __init__(self, shapes: dict[str, tuple[tuple[int, ...], torch.dtype]], device):
        super().__init__()
        for name, (shape, dtype) in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device), requires_grad=False))


class Attention(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
                mode: str, cache: dict | None = None) -> torch.Tensor:
        """Train attends over the full sequence with no cache; prefill also
        writes the layer's K/V into ``cache`` (ring-buffer slots for a
        sliding window); decode writes one slot and attends over the
        cache.  ``positions``: ``(b, s)`` for train and prefill, ``(b,)``
        for decode."""
        b, s, _ = x.shape
        hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k, v = q.reshape(b, s, H, hd), k.reshape(b, s, KV, hd), v.reshape(b, s, KV, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, self.q_norm, cfg.norm_eps)
            k = L.rms_norm(k, self.k_norm, cfg.norm_eps)
        W = cfg.sliding_window
        if mode in ("train", "prefill"):
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            out = L.gqa_attention(q, k, v, causal=True, window=W)
            if cache is not None:
                start = max(0, s - W) if W is not None else 0
                slots = torch.arange(start, s, device=x.device)
                if W is not None:
                    slots = slots % W
                cache["k"][:, slots] = k[:, start:].to(cache["k"].dtype)
                cache["v"][:, slots] = v[:, start:].to(cache["v"].dtype)
        elif mode == "decode":
            pos = positions.reshape(b)
            q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
            k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
            slot = pos % W if W is not None else pos
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            cache_len = torch.clamp(pos + 1, max=cache["k"].shape[1])
            out = L.decode_attention(q, cache["k"], cache["v"], cache_len)
        else:
            raise ValueError(mode)
        return out.reshape(b, s, H * hd) @ self.wo


class SSMBlock(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, *, mode: str,
                cache: dict | None = None) -> torch.Tensor:
        """Mamba-2 block.  Train runs the chunked scan with no cache;
        prefill also writes the final state and conv tail into ``cache``;
        decode advances them in place."""
        b, s, _ = x.shape
        di, n, h, pd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        proj = x @ self.in_proj
        z, xs, Bc, Cc, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
        tail = cache["conv"] if mode == "decode" else None
        conv_out, new_tail = ssm_lib.causal_conv1d(torch.cat([xs, Bc, Cc], dim=-1),
                                                   self.conv_w, self.conv_b, tail)
        xs, Bc, Cc = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
        dt = torch.logaddexp(dt.to(torch.float32) + self.dt_bias.to(torch.float32),
                             torch.zeros((), device=x.device))          # softplus
        A = -torch.exp(self.A_log.to(torch.float32))
        xh = xs.reshape(b, s, h, pd)
        if mode == "decode":
            y, state = ssm_lib.ssd_decode_step(xh[:, 0], dt[:, 0], A, Bc[:, 0],
                                               Cc[:, 0], self.D, cache["state"])
            y = y[:, None]
        else:
            y, state = ssm_lib.ssd_chunked(xh, dt, A, Bc, Cc, self.D, cfg.ssm_chunk)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv"].copy_(new_tail)
        y = y.reshape(b, s, di)
        y = L.rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), self.norm, cfg.norm_eps)
        return y @ self.out_proj


class MLP(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
        return L.glu_mlp(x, self.w_gate, self.w_up, self.w_down, cfg.activation)


def _sub(specs: dict[str, Spec], prefix: str) -> dict[str, tuple]:
    """Per-layer shapes of the specs under ``prefix`` (stacked axis dropped)."""
    return {k[len(prefix):]: (v.shape[1:], v.dtype) for k, v in specs.items()
            if k.startswith(prefix)}


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, specs: dict[str, Spec], device):
        super().__init__()
        self.cfg = cfg
        for name in ("norm1", "norm2", "mix_attn", "mix_ssm"):
            if f"layers.{name}" in specs:
                sp = specs[f"layers.{name}"]
                self.register_parameter(name, nn.Parameter(
                    torch.empty(sp.shape[1:], dtype=sp.dtype, device=device),
                    requires_grad=False))
        if cfg.has_attention:
            self.attn = Attention(_sub(specs, "layers.attn."), device)
            self.mlp = MLP(_sub(specs, "layers.mlp."), device)
        if cfg.has_ssm:
            self.ssm = SSMBlock(_sub(specs, "layers.ssm."), device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, mode: str,
                cache: dict | None) -> torch.Tensor:
        cfg, cache = self.cfg, cache or {}
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if cfg.arch_type == "ssm":
            return x + self.ssm(cfg, h, mode=mode, cache=cache.get("ssm"))
        a_out = self.attn(cfg, h, positions, mode=mode, cache=cache.get("attn"))
        if cfg.arch_type == "hybrid":
            s_out = self.ssm(cfg, h, mode=mode, cache=cache.get("ssm"))
            ga = 0.5 * (1.0 + self.mix_attn.to(torch.float32))
            gs = 0.5 * (1.0 + self.mix_ssm.to(torch.float32))
            out = (ga * a_out.to(torch.float32) + gs * s_out.to(torch.float32)).to(x.dtype)
        else:
            out = a_out
        x = x + out
        return x + self.mlp(cfg, L.rms_norm(x, self.norm2, cfg.norm_eps))


class Transformer(nn.Module):
    """The decoder stack.  Build with ``init_model`` (random weights from a
    generator) or construct and ``load_state_dict`` (e.g. weights converted
    from the reference by ``repro_torch.convert.transformer_params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        specs = param_specs(cfg)
        self.cfg = cfg
        for name in ("embed", "final_norm", "lm_head"):
            if name in specs:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(specs[name].shape, dtype=specs[name].dtype, device=device),
                    requires_grad=False))
        self.layers = nn.ModuleList(DecoderLayer(cfg, specs, device)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Train mode: ``tokens (b, s)`` -> fp32 logits ``(b, s, vocab)`` of
        every position, no cache (the reference's ``_embed_inputs``, the
        layer stack, then ``_lm_head``)."""
        b, s = tokens.shape
        h = _embed(self, tokens)
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        for layer in self.layers:
            h = layer(h, positions, mode="train", cache=None)
        return _lm_head(self, h)


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None) -> Transformer:
    """A model with the reference's init rule drawn from ``generator``
    (which must live on ``device``), one stacked draw per spec."""
    model = Transformer(cfg, device=device)
    params = dict(model.named_parameters())
    for name, spec in param_specs(cfg).items():
        leaf = _init_leaf(spec, generator, device)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                params[f"layers.{i}.{rest}"].copy_(leaf[i])
        else:
            params[name].copy_(leaf)
    return model


# ==========================================================================
# Cache and forward passes
# ==========================================================================

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device=None) -> dict:
    """Zero decode cache with a leading layer axis (``transformer.py::
    init_cache``); a sliding window keeps ``min(W, max_len)`` slots."""
    _check_ported(cfg)
    dt = cfg.torch_dtype()
    n, b = cfg.n_layers, batch_size
    cache: dict = {}
    if cfg.has_attention:
        S = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
        shape = (n, b, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["attn"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                         "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.has_ssm:
        cache["ssm"] = {
            "state": torch.zeros(n, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros(n, b, cfg.conv_kernel - 1,
                                cfg.ssm_inner + 2 * cfg.ssm_state, dtype=dt, device=device)}
    return cache


def _layer_cache(cache: dict, i: int) -> dict:
    """Views of layer ``i``'s slice of every cache leaf."""
    return {blk: {k: t[i] for k, t in leaves.items()} for blk, leaves in cache.items()}


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    h = model.embed[tokens].to(cfg.torch_dtype())
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _lm_head(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    h = L.rms_norm(h, model.final_norm, cfg.norm_eps)
    w = model.embed.t() if cfg.tie_embeddings else model.lm_head
    return (h @ w).to(torch.float32)


def train_params(model: Transformer) -> dict[str, torch.Tensor]:
    """The model's weights as a flat dict of tensors sharing its storage
    (``layers.3.attn.wq`` ...): what the training steps differentiate and
    update in place."""
    return {name: p.detach() for name, p in model.named_parameters()}


def forward_train(model: Transformer, batch: dict,
                  params: dict[str, torch.Tensor] | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss: the mean next-token NLL of ``batch["labels"]`` under
    the fp32 logits of ``batch["tokens"]`` (both ``(b, s)``).  ``params``
    (state-dict names -> tensors, e.g. ones that require grad, or LoRA-
    merged weights) stand in for the model's own through
    ``torch.func.functional_call``.  Returns ``(loss, {"loss", "aux"})``;
    ``aux`` is 0 (no ported family is MoE)."""
    tokens = batch["tokens"]
    logits = model(tokens) if params is None else \
        torch.func.functional_call(model, params, (tokens,))
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long())
    return loss, {"loss": loss, "aux": torch.zeros((), device=loss.device)}


@torch.no_grad()
def forward_prefill(model: Transformer, batch: dict, pad_to: int | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill: last-position logits ``(b, 1, vocab)`` fp32
    and the populated cache.  ``pad_to`` is the decode budget (prompt plus
    new tokens): full-attention caches get that many slots, sliding-window
    rings ``min(W, pad_to)`` (``W`` without a budget)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    if pad_to is not None and pad_to < s:
        raise ValueError(f"pad_to={pad_to} is shorter than the prompt ({s})")
    if pad_to is not None:
        budget = pad_to
    else:
        budget = cfg.sliding_window if cfg.sliding_window is not None else s
    cache = init_cache(cfg, b, budget, device=tokens.device)
    h = _embed(model, tokens)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    for i, layer in enumerate(model.layers):
        h = layer(h, positions, mode="prefill", cache=_layer_cache(cache, i))
    return _lm_head(model, h[:, -1:]), cache


@torch.no_grad()
def forward_decode(model: Transformer, batch: dict, cache: dict
                   ) -> tuple[torch.Tensor, dict]:
    """One-token decode: ``tokens (b, 1)``, ``positions (b,)`` absolute.
    Returns logits ``(b, 1, vocab)`` fp32 and ``cache``, updated in place."""
    h = _embed(model, batch["tokens"])
    positions = batch["positions"]
    for i, layer in enumerate(model.layers):
        h = layer(h, positions, mode="decode", cache=_layer_cache(cache, i))
    return _lm_head(model, h), cache
