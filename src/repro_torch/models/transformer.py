"""The port's config-driven transformer stack (``repro/models/transformer.py``).

One ``ArchConfig`` covers the zoo's six families:

  dense   GQA + RoPE + GLU (optional QKV bias, qk-norm, sliding window)
  moe     dense attention + a token-choice top-k mixture of GLU experts
          (``models/moe.py``)
  ssm     attention-free Mamba-2 SSD blocks
  hybrid  attention and SSD heads in parallel on one input (Hymba-style)
  vlm     a dense decoder reading stub vision embeddings ahead of the text
          (InternVL2-style)
  audio   an encoder over stub frame embeddings and a decoder that
          cross-attends to it; LayerNorm, learned positions, a biased GELU
          MLP (Whisper-style)

Each layer is an ``nn.Module``; weights keep the reference's ``(d_in,
d_out)`` layout and names, so a state dict key is the reference's pytree
path with the stacked layer axis written out (``layers.3.attn.wq``,
``encoder.1.mlp.w_in``, ``layers.0.xattn.wk``, ``layers.2.moe.w_gate``).
Entry points:

  ``forward_train``    full-sequence causal-LM loss, differentiable in the
                       weights (``model(tokens)`` gives the fp32 logits)
  ``forward_prefill``  full sequence -> last-position logits + decode cache
  ``forward_decode``   one token + cache -> logits; the cache is updated in
                       place (the reference returns a new one)

``forward_train(..., par=TensorParallel(...))`` trains a model
tensor-parallel over a model axis: the attention, the GLU MLP, the
embedding and the head take their weights through a ``par`` hook
(``Whole``, the default: the whole weights), which runs one part a
position over its shards and joins the parts with the model axis's
collectives (``launch/model_axis.py``); the layer bodies are the same.
The MoE runs expert-parallel and the SSM block by its pieces' splits
through the hook's ``moe`` and ``ssm``.

Every attention -- causal self-attention, the encoder's non-causal one and
the decoder's cross-attention, in decode too -- runs through the flash
kernel (``layers.gqa_attention``), except decode's self-attention over the
cache (``layers.decode_attention``).  Training runs attention through the
flash kernels' autograd function and the SSD block through the SSD
kernels' (``ops._SSDChunk``).

The cache keeps the reference's layout, one stacked tensor per leaf with a
leading layer axis: ``{"attn": {"k", "v": (L, b, S, KV, d)}, "ssm":
{"state": (L, b, h, p, n) fp32, "conv": (L, b, k-1, channels)}}`` (an
SSM model's leaves sit under ``"ssm"`` too; the reference keeps them at
the top level).  An audio model's prefill also stores the encoder's output
as ``cache["enc_out"] (b, S_src, d)``, which decode cross-attends to (the
reference's decode takes it in the batch).  A sliding-window cache is a
ring of ``S = min(W, budget)`` slots holding position ``p`` at slot ``p %
W``, after prefill as after decode, whatever the prompt length.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, replace

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# learned positions' rows when the caller gives no ``max_seq``
MAX_SEQ = 4096


def _check_arch(cfg: ArchConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The audio encoder's layers: a dense, non-MoE copy of the config."""
    return replace(cfg, arch_type="dense", n_experts=0)


# ==========================================================================
# Parameter specs
# ==========================================================================

@dataclass(frozen=True)
class Spec:
    """One parameter: its shape as the reference declares it (layer weights
    with the leading stacked ``layers`` axis), its init scale (``None``:
    fan-in) and dtype; for the LoRA mapping table (``models/lora.py``) its
    leading batch ``axes`` (``("layers",)`` for a stacked weight,
    ``("layers", "expert")`` for an expert's) and the port's parameter
    ``names`` it covers, one a layer; ``logical``, the logical axis name of
    every dimension (the reference's ``LogicalParam.axes``), is what the
    sharding rules read (``launch/sharding.py``).  Layouts are the
    reference's (``perm`` None)."""
    shape: tuple[int, ...]
    scale: float | None
    dtype: torch.dtype
    axes: tuple[str, ...] = ()
    names: tuple[str, ...] = ()
    logical: tuple[str, ...] = ()
    perm = None


def _lp(shape: tuple[int, ...], logical: tuple[str, ...], scale, dt, **kw) -> Spec:
    """A stacked layer weight: ``shape`` and ``logical`` lead with the
    layer axis."""
    return Spec(shape, scale, dt, logical=("layers",) + logical, **kw)


def _attn_specs(cfg: ArchConfig, n: int, dt) -> dict[str, Spec]:
    d, hd, H, KV = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    s = {"wq": _lp((n, d, H * hd), ("embed", "heads"), None, dt),
         "wk": _lp((n, d, KV * hd), ("embed", "kv_heads"), None, dt),
         "wv": _lp((n, d, KV * hd), ("embed", "kv_heads"), None, dt),
         "wo": _lp((n, H * hd, d), ("heads", "embed"), None, dt)}
    if cfg.qkv_bias:
        s.update(bq=_lp((n, H * hd), ("heads",), 0.0, dt),
                 bk=_lp((n, KV * hd), ("kv_heads",), 0.0, dt),
                 bv=_lp((n, KV * hd), ("kv_heads",), 0.0, dt))
    if cfg.qk_norm:
        s.update(q_norm=_lp((n, hd), ("head_dim",), 0.0, dt),
                 k_norm=_lp((n, hd), ("head_dim",), 0.0, dt))
    return s


def _mlp_specs(cfg: ArchConfig, n: int, dt) -> dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.norm == "ln":                       # Whisper's biased GELU MLP
        return {"w_in": _lp((n, d, f), ("embed", "mlp"), None, dt),
                "b_in": _lp((n, f), ("mlp",), 0.0, dt),
                "w_out": _lp((n, f, d), ("mlp", "embed"), None, dt),
                "b_out": _lp((n, d), ("embed",), 0.0, dt)}
    return {"w_gate": _lp((n, d, f), ("embed", "mlp"), None, dt),
            "w_up": _lp((n, d, f), ("embed", "mlp"), None, dt),
            "w_down": _lp((n, f, d), ("mlp", "embed"), None, dt)}


def _moe_specs(cfg: ArchConfig, n: int, dt) -> dict[str, Spec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ex = ("layers", "expert")
    return {"router": _lp((n, d, E), ("embed", "expert"), None, torch.float32),
            "w_gate": _lp((n, E, d, f), ("expert", "embed", "mlp"), None, dt, axes=ex),
            "w_up": _lp((n, E, d, f), ("expert", "embed", "mlp"), None, dt, axes=ex),
            "w_down": _lp((n, E, f, d), ("expert", "mlp", "embed"), None, dt, axes=ex)}


def _ssm_specs(cfg: ArchConfig, n_layers: int, dt) -> dict[str, Spec]:
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    nl = n_layers
    return {
        "in_proj": _lp((nl, d, 2 * di + 2 * n + h), ("embed", "ssm_proj"), None, dt),
        "conv_w": _lp((nl, cfg.conv_kernel, conv_dim), ("conv", "ssm_conv"), 0.5, dt),
        "conv_b": _lp((nl, conv_dim), ("ssm_conv",), 0.0, dt),
        "A_log": _lp((nl, h), ("ssm_heads",), 1.0, dt),
        "D": _lp((nl, h), ("ssm_heads",), 1.0, dt),
        "dt_bias": _lp((nl, h), ("ssm_heads",), 0.0, dt),
        "norm": _lp((nl, di), ("ssm_inner",), 0.0, dt),
        "out_proj": _lp((nl, di, d), ("ssm_inner", "embed"), None, dt),
    }


def _norm_specs(cfg: ArchConfig, shape: tuple[int, ...], names: list[str]) -> dict:
    """fp32 norm scales (zeros at init), each with a ``_b`` bias under LN;
    ``shape`` is ``(d,)`` or stacked ``(layers, d)``."""
    logical = ("layers", "embed")[-len(shape):]
    out = {}
    for nm in names:
        out[nm] = Spec(shape, 0.0, torch.float32, logical=logical)
        if cfg.norm == "ln":
            out[nm + "_b"] = Spec(shape, 0.0, torch.float32, logical=logical)
    return out


def _layer_specs(cfg: ArchConfig, n: int, dt, cross_attention: bool = False) -> dict:
    """One stack's per-layer specs, keyed without the stack's prefix
    (``transformer.py::_decoder_layer_specs``)."""
    d = cfg.d_model
    if cfg.arch_type == "ssm":
        lay = _norm_specs(cfg, (n, d), ["norm1"])
        lay.update({f"ssm.{k}": v for k, v in _ssm_specs(cfg, n, dt).items()})
        return lay
    lay = _norm_specs(cfg, (n, d), ["norm1", "norm2"])
    lay.update({f"attn.{k}": v for k, v in _attn_specs(cfg, n, dt).items()})
    if cfg.arch_type == "hybrid":
        lay.update({f"ssm.{k}": v for k, v in _ssm_specs(cfg, n, dt).items()})
        lay["mix_attn"] = _lp((n, d), ("embed",), 0.0, torch.float32)
        lay["mix_ssm"] = _lp((n, d), ("embed",), 0.0, torch.float32)
    if cross_attention:
        lay.update(_norm_specs(cfg, (n, d), ["norm_x"]))
        lay.update({f"xattn.{k}": v for k, v in _attn_specs(cfg, n, dt).items()})
    if cfg.is_moe:
        lay.update({f"moe.{k}": v for k, v in _moe_specs(cfg, n, dt).items()})
    else:
        lay.update({f"mlp.{k}": v for k, v in _mlp_specs(cfg, n, dt).items()})
    return lay


def _stacked(prefix: str, lay: dict, n: int) -> dict[str, Spec]:
    return {f"{prefix}.{k}": replace(v, axes=v.axes or ("layers",),
                                     names=tuple(f"{prefix}.{i}.{k}" for i in range(n)))
            for k, v in lay.items()}


def param_specs(cfg: ArchConfig, max_seq: int = MAX_SEQ) -> dict[str, Spec]:
    """Flat ``{state-dict path with the layer index left out: Spec}``, in
    the reference's order (``transformer.py::param_specs``); ``layers.*``
    and ``encoder.*`` specs carry the stacked layer axis.  ``max_seq``
    sizes learned positions."""
    _check_arch(cfg)
    dt = cfg.torch_dtype()
    d, n = cfg.d_model, cfg.n_layers
    specs = {"embed": Spec((cfg.vocab, d), 1.0 / math.sqrt(d), dt,
                           logical=("vocab", "embed"))}
    specs.update(_norm_specs(cfg, (d,), ["final_norm"]))
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, cfg.vocab), None, dt, logical=("embed", "vocab"))
    if cfg.pos == "learned":
        specs["pos_embed"] = Spec((max_seq, d), 0.02, dt, logical=("pos", "embed"))
    if cfg.arch_type == "audio":
        specs["enc_pos"] = Spec((cfg.source_positions, d), 0.02, dt, logical=("pos", "embed"))
    specs = {k: replace(v, names=(k,)) for k, v in specs.items()}
    if cfg.arch_type == "audio":
        ne = cfg.encoder_layers
        specs.update(_stacked("encoder", _layer_specs(_encoder_cfg(cfg), ne, dt), ne))
        specs.update({k: replace(v, names=(k,)) for k, v in
                      _norm_specs(replace(cfg, norm="ln"), (d,), ["enc_final_norm"]).items()})
    specs.update(_stacked("layers", _layer_specs(cfg, n, dt,
                                                 cross_attention=cfg.arch_type == "audio"), n))
    return specs


def param_count(cfg: ArchConfig, max_seq: int = MAX_SEQ) -> int:
    return sum(math.prod(s.shape) for s in param_specs(cfg, max_seq).values())


def active_param_count(cfg: ArchConfig, max_seq: int = MAX_SEQ) -> int:
    """Params touched per token (MoE: ``top_k`` of the ``n_experts``
    experts' weights), as the reference counts them."""
    total = param_count(cfg, max_seq)
    if not cfg.is_moe:
        return total
    expert_leaf = cfg.n_layers * 3 * cfg.d_model * cfg.d_ff
    return total - expert_leaf * cfg.n_experts + expert_leaf * cfg.top_k


def adapter_mapping(cfg: ArchConfig, rank: int, alpha: float | None = None,
                    max_seq: int = MAX_SEQ) -> dict:
    """The LoRA mapping table over this architecture's specs
    (``models/lora.py``), keyed like the reference's by ``/``-joined path;
    the expert axis batches the factorization as the layer axis does."""
    from repro_torch.models import lora
    return lora.build_mapping(param_specs(cfg, max_seq), rank, alpha)


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


class Whole:
    """How a layer reaches its weights (the ``par`` hook): here the
    module's own, or those ``functional_call`` binds, whole.
    ``parts(module, x)`` lists ``(input, weight getter)`` for each part of
    the layer's work -- one here -- and ``reduce`` sums the parts' outputs;
    ``embed`` and ``logits`` are the embedding lookup and the fp32 head;
    ``experts`` gives the MoE's expert shards, and ``columns``, ``conv``,
    ``scan`` and ``gated_out`` are the Mamba-2 block's pieces."""

    def parts(self, module: nn.Module, x: torch.Tensor) -> list:
        return [(x, lambda n: getattr(module, n))]

    def reduce(self, outs: list[torch.Tensor]) -> torch.Tensor:
        return outs[0]

    def embed(self, model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        return model.embed[tokens]

    def logits(self, model: nn.Module, h: torch.Tensor) -> torch.Tensor:
        w = model.embed.t() if model.cfg.tie_embeddings else model.lm_head
        return (h @ w).to(torch.float32)

    def experts(self, module: nn.Module, x: torch.Tensor) -> tuple[list, tuple]:
        """The MoE's ``_EXPERT_LEAVES`` as lists of shards, one a position
        that computes experts, and those positions' devices: one, whole,
        on ``x``'s device."""
        return [[getattr(module, n)] for n in _EXPERT_LEAVES], (x.device,)

    # the Mamba-2 block's pieces (``SSMBlock``)
    def columns(self, module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ getattr(module, name)

    def conv(self, block: nn.Module, xbc: torch.Tensor, tail: torch.Tensor | None = None):
        return ssm_lib.causal_conv1d(xbc, block.conv_w, block.conv_b, tail)

    def scan(self, block: nn.Module, cfg: ArchConfig, xh, dt, Bc, Cc):
        return _scan(cfg, xh, dt, Bc, Cc, block.dt_bias, block.A_log, block.D)

    def gated_out(self, block: nn.Module, cfg: ArchConfig, y: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(ssm_lib.gate(y, z), block.norm, cfg.norm_eps) @ block.out_proj


WHOLE = Whole()
_EXPERT_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _scan(cfg: ArchConfig, xh, dt, Bc, Cc, dt_bias, A_log, D):
    """The chunked SSD scan over the heads ``dt_bias``, ``A_log`` and ``D``
    hold: ``(y, final state)``."""
    dt, A = ssm_lib.dt_and_A(dt, dt_bias, A_log)
    return ssm_lib.ssd_chunked(xh, dt, A, Bc, Cc, D, cfg.ssm_chunk)


def _project(x: torch.Tensor, w: torch.Tensor, heads: int, hd: int,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    if bias is not None:
        y = y + bias
    return y.reshape(x.shape[0], x.shape[1], heads, hd)


class Attention(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
                mode: str, cache: dict | None = None, causal: bool = True,
                par: Whole = WHOLE) -> torch.Tensor:
        """Train attends over the full sequence with no cache (``causal``
        False: the audio encoder); prefill also writes the layer's K/V into
        ``cache`` (ring-buffer slots for a sliding window); decode writes
        one slot and attends over the cache.  ``positions``: ``(b, s)`` for
        train and prefill, ``(b,)`` for decode; RoPE only under ``pos ==
        "rope"``.  Each of ``par``'s parts attends over the heads its
        weights hold (all of them for ``WHOLE``); their outputs through
        ``wo`` are summed."""
        b, s, _ = x.shape
        hd, bias = cfg.resolved_head_dim, cfg.qkv_bias
        rope = cfg.pos == "rope"
        W = cfg.sliding_window
        outs = []
        for xp, w in par.parts(self, x):
            q = _project(xp, w("wq"), -1, hd, w("bq") if bias else None)
            k = _project(xp, w("wk"), -1, hd, w("bk") if bias else None)
            v = _project(xp, w("wv"), -1, hd, w("bv") if bias else None)
            if cfg.qk_norm:
                q = L.rms_norm(q, w("q_norm"), cfg.norm_eps)
                k = L.rms_norm(k, w("k_norm"), cfg.norm_eps)
            if mode in ("train", "prefill"):
                if rope:
                    pos = positions.to(xp.device)
                    q = L.apply_rope(q, pos, cfg.rope_theta)
                    k = L.apply_rope(k, pos, cfg.rope_theta)
                out = L.gqa_attention(q, k, v, causal=causal, window=W)
                if cache is not None:
                    start = max(0, s - W) if W is not None else 0
                    slots = torch.arange(start, s, device=x.device)
                    if W is not None:
                        slots = slots % W
                    cache["k"][:, slots] = k[:, start:].to(cache["k"].dtype)
                    cache["v"][:, slots] = v[:, start:].to(cache["v"].dtype)
            elif mode == "decode":
                pos = positions.reshape(b)
                if rope:
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
            outs.append(out.reshape(b, s, -1) @ w("wo"))
        return par.reduce(outs)


class CrossAttention(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """The decoder's queries against the encoder's output, non-causal,
        no cache: K and V are projected from ``enc_out`` on every call, in
        decode too (``transformer.py::cross_attn_block``; no bias, no
        RoPE, no qk-norm)."""
        b, s, _ = x.shape
        hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        q = _project(x, self.wq, H, hd)
        k = _project(enc_out, self.wk, KV, hd)
        v = _project(enc_out, self.wv, KV, hd)
        out = L.gqa_attention(q, k, v, causal=False)
        return out.reshape(b, s, H * hd) @ self.wo


class SSMBlock(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, *, mode: str,
                cache: dict | None = None, par: Whole = WHOLE) -> torch.Tensor:
        """Mamba-2 block.  Train runs the chunked scan with no cache;
        prefill also writes the final state and conv tail into ``cache``;
        decode advances them in place.  ``in_proj``, the conv, the scan and
        the gated norm with ``out_proj`` go through ``par``'s hooks
        (``TensorParallel`` splits each in training)."""
        b, s, _ = x.shape
        di, n, h, pd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        proj = par.columns(self, "in_proj", x)
        z, xs, Bc, Cc, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
        tail = cache["conv"] if mode == "decode" else None
        conv_out, new_tail = par.conv(self, torch.cat([xs, Bc, Cc], dim=-1), tail)
        xs, Bc, Cc = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
        xh = xs.reshape(b, s, h, pd)
        if mode == "decode":
            dt, A = ssm_lib.dt_and_A(dt, self.dt_bias, self.A_log)
            y, state = ssm_lib.ssd_decode_step(xh[:, 0], dt[:, 0], A, Bc[:, 0],
                                               Cc[:, 0], self.D, cache["state"])
            y = y[:, None]
        else:
            y, state = par.scan(self, cfg, xh, dt, Bc, Cc)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv"].copy_(new_tail)
        return par.gated_out(self, cfg, y.reshape(b, s, di), z)


class MLP(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, par: Whole = WHOLE) -> torch.Tensor:
        """The GLU MLP (``par``'s parts each over its slice of ``d_ff``,
        summed), or under LayerNorm Whisper's biased GELU MLP."""
        if cfg.norm == "ln":
            return L.mlp(x, self.w_in, self.b_in, self.w_out, self.b_out)
        return par.reduce([L.glu_mlp(xp, w("w_gate"), w("w_up"), w("w_down"), cfg.activation)
                           for xp, w in par.parts(self, x)])


class MoE(_Params):
    def forward(self, cfg: ArchConfig, x: torch.Tensor, par: Whole = WHOLE
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The mixture of GLU experts: ``(out, aux)``, its experts over the
        positions ``par`` gives them (one; over a model axis
        expert-parallel)."""
        shards, devices = par.experts(self, x)
        return moe_lib.moe_glu_sharded(x, *shards, devices, top_k=cfg.top_k,
                                       group_size=cfg.moe_group,
                                       capacity_factor=cfg.capacity_factor,
                                       activation=cfg.activation)


def _sub(specs: dict[str, Spec], prefix: str) -> dict[str, tuple]:
    """Per-layer shapes of the specs under ``prefix`` (stacked axis dropped)."""
    return {k[len(prefix):]: (v.shape[1:], v.dtype) for k, v in specs.items()
            if k.startswith(prefix)}


def _norm(cfg: ArchConfig, x: torch.Tensor, owner: nn.Module, name: str) -> torch.Tensor:
    if cfg.norm == "ln":
        return L.layer_norm(x, getattr(owner, name), getattr(owner, name + "_b"), cfg.norm_eps)
    return L.rms_norm(x, getattr(owner, name), cfg.norm_eps)


class DecoderLayer(nn.Module):
    """One layer of a stack (``transformer.py::decoder_layer``): the
    decoder's, the audio encoder's (built from its dense config), with
    cross-attention in an audio decoder.  ``prefix`` names the stack."""

    _NORMS = ("norm1", "norm1_b", "norm2", "norm2_b", "norm_x", "norm_x_b",
              "mix_attn", "mix_ssm")

    def __init__(self, cfg: ArchConfig, specs: dict[str, Spec], device,
                 prefix: str = "layers"):
        super().__init__()
        self.cfg = cfg
        for name in self._NORMS:
            if f"{prefix}.{name}" in specs:
                sp = specs[f"{prefix}.{name}"]
                self.register_parameter(name, nn.Parameter(
                    torch.empty(sp.shape[1:], dtype=sp.dtype, device=device),
                    requires_grad=False))
        for name, cls in (("attn", Attention), ("xattn", CrossAttention),
                          ("ssm", SSMBlock), ("mlp", MLP), ("moe", MoE)):
            shapes = _sub(specs, f"{prefix}.{name}.")
            if shapes:
                setattr(self, name, cls(shapes, device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, mode: str,
                cache: dict | None, enc_out: torch.Tensor | None = None,
                causal: bool = True, par: Whole = WHOLE) -> tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)``: the layer's output and its MoE load-balance term
        (0 without experts); the norms and residuals whole."""
        cfg, cache = self.cfg, cache or {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = _norm(cfg, x, self, "norm1")
        if cfg.arch_type == "ssm":
            return x + self.ssm(cfg, h, mode=mode, cache=cache.get("ssm"), par=par), aux
        a_out = self.attn(cfg, h, positions, mode=mode, cache=cache.get("attn"),
                          causal=causal, par=par)
        if cfg.arch_type == "hybrid":
            s_out = self.ssm(cfg, h, mode=mode, cache=cache.get("ssm"), par=par)
            ga = 0.5 * (1.0 + self.mix_attn.to(torch.float32))
            gs = 0.5 * (1.0 + self.mix_ssm.to(torch.float32))
            out = (ga * a_out.to(torch.float32) + gs * s_out.to(torch.float32)).to(x.dtype)
        else:
            out = a_out
        x = x + out
        if enc_out is not None:
            x = x + self.xattn(cfg, _norm(cfg, x, self, "norm_x"), enc_out)
        h = _norm(cfg, x, self, "norm2")
        if cfg.is_moe:
            out, aux = self.moe(cfg, h, par)
        else:
            out = self.mlp(cfg, h, par)
        return x + out, aux


class Transformer(nn.Module):
    """The model.  Build with ``init_model`` (random weights from a
    generator) or construct and ``load_state_dict`` (e.g. weights converted
    from the reference by ``repro_torch.convert.transformer_params_from_jax``).
    ``max_seq`` sizes learned positions (the longest sequence the model
    takes, decode included)."""

    _TOP = ("embed", "final_norm", "final_norm_b", "lm_head", "pos_embed", "enc_pos",
            "enc_final_norm", "enc_final_norm_b")

    def __init__(self, cfg: ArchConfig, device=None, max_seq: int = MAX_SEQ):
        super().__init__()
        specs = param_specs(cfg, max_seq)
        self.cfg, self.max_seq = cfg, max_seq
        for name in self._TOP:
            if name in specs:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(specs[name].shape, dtype=specs[name].dtype, device=device),
                    requires_grad=False))
        if cfg.arch_type == "audio":
            enc = _encoder_cfg(cfg)
            self.encoder = nn.ModuleList(DecoderLayer(enc, specs, device, "encoder")
                                         for _ in range(cfg.encoder_layers))
        self.layers = nn.ModuleList(DecoderLayer(cfg, specs, device)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor, vision_embeds: torch.Tensor | None = None,
                enc_feats: torch.Tensor | None = None, *, with_aux: bool = False,
                par: Whole = WHOLE):
        """Train mode: ``tokens (b, s)`` -> fp32 logits ``(b, s, vocab)`` of
        every text position, no cache (``_embed_inputs``, the layer stack,
        then ``_lm_head``; a VLM's vision span is left out, as the
        reference's loss leaves it).  ``with_aux``: ``(logits, aux)``, aux
        the MoE load-balance terms summed over the layers.  The vision span
        left out is the one given: ``vision_embeds.shape[1]`` positions,
        ``cfg.vision_tokens`` or fewer (``configs.token_split`` gives a
        sequence shorter than twice the vision tokens half of it; the
        reference slices ``cfg.vision_tokens`` there and keeps no text).
        ``par``: how the layers reach their weights (``Whole``)."""
        cfg = self.cfg
        enc_out = _run_encoder(self, enc_feats) if cfg.arch_type == "audio" else None
        h, positions = _embed_inputs(self, tokens, vision_embeds, par)
        h, aux = _run_layers(self, h, positions, mode="train", cache=None, enc_out=enc_out,
                             par=par)
        if cfg.arch_type == "vlm":
            h = h[:, vision_embeds.shape[1]:]
        logits = _lm_head(self, h, par)
        return (logits, aux) if with_aux else logits


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None,
               max_seq: int = MAX_SEQ) -> Transformer:
    """A model with the reference's init rule drawn from ``generator``
    (which must live on ``device``), one stacked draw per spec."""
    model = Transformer(cfg, device=device, max_seq=max_seq)
    params = dict(model.named_parameters())
    for name, spec in param_specs(cfg, max_seq).items():
        leaf = _init_leaf(spec, generator, device)
        if len(spec.names) == 1 and spec.names[0] == name:
            params[name].copy_(leaf)
        else:
            for i, n in enumerate(spec.names):
                params[n].copy_(leaf[i])
    return model


# ==========================================================================
# Cache and forward passes
# ==========================================================================

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device=None) -> dict:
    """Zero decode cache with a leading layer axis (``transformer.py::
    init_cache``); a sliding window keeps ``min(W, max_len)`` slots."""
    _check_arch(cfg)
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


def _layer_cache(cache: dict | None, i: int) -> dict | None:
    """Views of layer ``i``'s slice of every stacked cache leaf."""
    if cache is None:
        return None
    return {blk: {k: t[i] for k, t in leaves.items()} for blk, leaves in cache.items()
            if isinstance(leaves, dict)}


def _check_positions(model: Transformer, last: int) -> None:
    """Learned positions have ``max_seq`` rows: a later position raises
    (the reference would index past them)."""
    if model.cfg.pos == "learned" and last >= model.pos_embed.shape[0]:
        raise ValueError(f"position {last} is past the model's {model.pos_embed.shape[0]} "
                         f"learned positions (max_seq)")


def _embed_tokens(model: Transformer, tokens: torch.Tensor, par: Whole = WHOLE
                  ) -> torch.Tensor:
    cfg = model.cfg
    h = par.embed(model, tokens).to(cfg.torch_dtype())
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _embed_inputs(model: Transformer, tokens: torch.Tensor,
                  vision_embeds: torch.Tensor | None = None, par: Whole = WHOLE
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings, a VLM's vision embeddings prepended, learned
    positions added (``transformer.py::_embed_inputs``) -> ``(h,
    positions (b, s))``."""
    cfg = model.cfg
    h = _embed_tokens(model, tokens, par)
    if cfg.arch_type == "vlm":
        if vision_embeds is None:
            raise ValueError(f"{cfg.name} takes vision_embeds (b, vision tokens, d)")
        h = torch.cat([vision_embeds.to(h.dtype), h], dim=1)
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    if cfg.pos == "learned":
        _check_positions(model, s - 1)
        h = h + model.pos_embed[:s].to(h.dtype)
    return h, positions


def _run_encoder(model: Transformer, enc_feats: torch.Tensor | None) -> torch.Tensor:
    """The audio encoder over stub frame embeddings ``(b, S_src, d)``: its
    learned positions, the dense layers without a causal mask, a final
    LayerNorm (``transformer.py::_run_encoder``)."""
    cfg = model.cfg
    if enc_feats is None:
        raise ValueError(f"{cfg.name} takes enc_feats (b, source positions, d)")
    h = enc_feats.to(cfg.torch_dtype())
    b, s = h.shape[:2]
    if s > model.enc_pos.shape[0]:
        raise ValueError(f"{s} source frames, the encoder has {model.enc_pos.shape[0]}")
    h = h + model.enc_pos[:s].to(h.dtype)
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for layer in model.encoder:
        h, _ = _call_layer(cfg, layer, h, positions, mode="train", cache=None,
                           causal=False)
    return L.layer_norm(h, model.enc_final_norm, model.enc_final_norm_b, cfg.norm_eps)


def _call_layer(cfg, layer, h, positions, **kw):
    """One layer's call; in a training step under ``cfg.remat`` (the
    reference's ``jax.checkpoint`` of each layer) it is checkpointed: the
    step keeps only the layer's input, and the backward runs the layer's
    forward again -- its kernels included, whose saved tensors (the flash
    forward's log-sum-exp, the MoE dispatch's inverse index) then come from
    that recompute.  The layer's weights are handed to the checkpoint as
    inputs and bound again for the recompute: under ``forward_train``'s
    ``functional_call`` they are the caller's tensors, which the layer no
    longer holds when the backward runs.  The layers draw no random
    numbers, so no generator state is saved."""
    if not (cfg.remat and kw["mode"] == "train" and torch.is_grad_enabled()):
        return layer(h, positions, **kw)
    names = [name for name, _ in layer.named_parameters()]

    def run(h, positions, *weights):
        return torch.func.functional_call(layer, dict(zip(names, weights)), (h, positions), kw)

    return torch.utils.checkpoint.checkpoint(
        run, h, positions, *(w for _, w in layer.named_parameters()),
        use_reentrant=False, preserve_rng_state=False)


def _run_layers(model: Transformer, h: torch.Tensor, positions: torch.Tensor, *,
                mode: str, cache: dict | None, enc_out: torch.Tensor | None,
                par: Whole = WHOLE) -> tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, layer in enumerate(model.layers):
        h, a = _call_layer(model.cfg, layer, h, positions, mode=mode,
                           cache=_layer_cache(cache, i), enc_out=enc_out, par=par)
        aux = aux + a
    return h, aux


def _lm_head(model: Transformer, h: torch.Tensor, par: Whole = WHOLE) -> torch.Tensor:
    return par.logits(model, _norm(model.cfg, h, model, "final_norm"))


def train_params(model: Transformer) -> dict[str, torch.Tensor]:
    """The model's weights as a flat dict of tensors sharing its storage
    (``layers.3.attn.wq`` ...): what the training steps differentiate and
    update in place."""
    return {name: p.detach() for name, p in model.named_parameters()}


def forward_train(model: Transformer, batch: dict,
                  params: dict[str, torch.Tensor] | None = None,
                  par: TensorParallel | None = None) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss: the mean next-token NLL of ``batch["labels"]`` under
    the fp32 logits of ``batch["tokens"]`` (both ``(b, s)``; a VLM's
    ``vision_embeds`` and an audio model's ``enc_feats`` from the batch
    too), plus ``0.01 * aux`` for MoE.  ``params`` (state-dict names ->
    tensors, e.g. ones that require grad, or LoRA-merged weights) stand in
    for the model's own through ``torch.func.functional_call``.  Returns
    ``(loss, {"loss", "aux"})``, ``aux`` the MoE load-balance terms summed
    over the layers (0 without experts).  With ``par`` (a model over a
    model axis) ``params`` is a tree of shards (``TensorParallel``); it
    runs a decoder from tokens alone, as a round's batch holds them, so an
    audio model's frames or a VLM's vision embeddings raise (without them
    the model raises for them, as without ``par``)."""
    args = (batch["tokens"], batch.get("vision_embeds"), batch.get("enc_feats"))
    kw = {"with_aux": True}
    if par is not None:
        if args[1] is not None or args[2] is not None:
            raise ValueError(f"{model.cfg.name}: the tensor-parallel forward runs the "
                             f"decoder from tokens alone; the audio encoder and the "
                             f"vision span have no tensor-parallel path")
        params, kw["par"] = par.bind(params)
    logits, aux = model(*args, **kw) if params is None else \
        torch.func.functional_call(model, params, args, kw)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long().to(logits.device))
    if model.cfg.is_moe:
        loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux": aux}


@torch.no_grad()
def forward_prefill(model: Transformer, batch: dict, pad_to: int | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill of ``batch["tokens"]`` (a VLM's
    ``vision_embeds`` ahead of them, an audio model's ``enc_feats`` through
    the encoder): last-position logits ``(b, 1, vocab)`` fp32 and the
    populated cache (an audio model's with ``"enc_out"``).  ``pad_to`` is
    the decode budget (the whole prefilled sequence, vision tokens
    included, plus new tokens): full-attention caches get that many slots,
    sliding-window rings ``min(W, pad_to)`` (``W`` without a budget)."""
    cfg = model.cfg
    enc_out = _run_encoder(model, batch.get("enc_feats")) if cfg.arch_type == "audio" \
        else None
    h, positions = _embed_inputs(model, batch["tokens"], batch.get("vision_embeds"))
    b, s = h.shape[:2]
    if pad_to is not None and pad_to < s:
        raise ValueError(f"pad_to={pad_to} is shorter than the prefilled sequence ({s})")
    if pad_to is not None:
        budget = pad_to
        _check_positions(model, pad_to - 1)
    else:
        budget = cfg.sliding_window if cfg.sliding_window is not None else s
    cache = init_cache(cfg, b, budget, device=h.device)
    h, _ = _run_layers(model, h, positions, mode="prefill", cache=cache, enc_out=enc_out)
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return _lm_head(model, h[:, -1:]), cache


@torch.no_grad()
def forward_decode(model: Transformer, batch: dict, cache: dict
                   ) -> tuple[torch.Tensor, dict]:
    """One-token decode: ``tokens (b, 1)``, ``positions (b,)`` absolute (a
    VLM's count its vision tokens).  An audio model cross-attends to
    ``batch["enc_out"]`` if given, else to the cache's.  Returns logits
    ``(b, 1, vocab)`` fp32 and ``cache``, updated in place."""
    cfg = model.cfg
    h = _embed_tokens(model, batch["tokens"])
    positions = batch["positions"]
    if cfg.pos == "learned":
        if positions.device.type != "meta":    # a shape-only run has no values
            _check_positions(model, int(positions.max()))
        h = h + model.pos_embed[positions][:, None].to(h.dtype)
    enc_out = batch.get("enc_out", cache.get("enc_out")) if cfg.arch_type == "audio" \
        else None
    h, _ = _run_layers(model, h, positions, mode="decode", cache=cache, enc_out=enc_out)
    return _lm_head(model, h), cache


# ==========================================================================
# Tensor parallelism over a model axis (training)
# ==========================================================================

# the families a tensor-parallel round covers: every family the round
# trains from tokens alone (an audio model's frames and a VLM's vision
# embeddings are no part of a round's batch, in the reference's too)
TP_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_tp(cfg: ArchConfig, dims: dict, t: int) -> None:
    """Raise a ``ValueError`` naming ``cfg`` where the tensor-parallel
    forward cannot serve its placements ``dims`` over ``t`` positions:
    attention whose query heads split but whose GQA groups do not line up
    with them, or whose KV groups are fewer than the positions where the
    query heads do not split; experts split along another axis than the
    expert axis.  An audio model or a VLM passes (its round raises for its
    missing input, as at ``t = 1``)."""
    if cfg.arch_type not in TP_FAMILIES:
        return
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.has_attention and dims.get("layers.0.attn.wq") is not None:
        if H % t == 0:
            hj, g = H // t, H // KV
            kv_split = KV % t == 0 and dims["layers.0.attn.wk"] is not None
            if not kv_split and hj % g and g % hj:
                raise ValueError(f"{cfg.name}: {hj} query heads a position do not line "
                                 f"up with GQA groups of {g}")
        elif KV < t:
            raise ValueError(f"{cfg.name}: {H}:{KV} heads split over {t} positions "
                             f"cut a head, and {KV} KV groups cannot give each position "
                             f"whole ones")
    if cfg.is_moe:
        got = (dims["layers.0.moe.router"], dims["layers.0.moe.w_gate"],
               dims["layers.0.moe.w_up"], dims["layers.0.moe.w_down"])
        if got not in ((1, 0, 0, 0), (None,) * 4):
            raise ValueError(f"{cfg.name}: its {cfg.n_experts} experts split over {t} "
                             f"positions along {got} (router, w_gate, w_up, w_down), not "
                             f"the expert axis")


def kv_groups(n_kv: int, t: int) -> list[tuple[int, int]]:
    """``[k0, k1)`` for each of ``t`` positions: whole KV groups, as even
    as they go, the first positions one more (25:5 heads at ``t = 2``:
    3 and 2 groups, 15:3 and 10:2 heads)."""
    out, k0 = [], 0
    for j in range(t):
        k1 = k0 + n_kv // t + (1 if j < n_kv % t else 0)
        out.append((k0, k1))
        k0 = k1
    return out


class TensorParallel(Whole):
    """The ``par`` hook over a model axis of ``t = len(devices)`` positions
    (Megatron's layout): ``dims[name]`` the dimension a weight is stored
    split along (None: whole on every position;
    ``launch/sharding.py::placements``, the reference's), ``home`` the
    device of the whole activations.  ``bind(tree)`` reads a tree holding
    ``model_axis.shard_key(name, j)`` for position ``j``'s shard of a split
    weight and ``name`` for a whole one.  Each position computes only along
    a dimension the layer's maths separates on; where the stored split cuts
    through such a unit the position gathers the weight and narrows it
    (``model_axis.gather_narrow``), or runs a column-parallel product and
    the activation is gathered.

    * Attention: position ``j`` gets the layer's input (``to_positions``:
      the input gradient all-reduced backward) and attends over its query
      heads -- ``H / t`` of them where the heads split evenly, the KV
      weights gathered and narrowed to the heads they read where the KV
      heads do not split (MQA's one head), else whole KV groups
      (``kv_groups``: hymba's 25:5 as 15:3 and 10:2 at ``t = 2``), each
      weight gathered and narrowed to them; ``wo`` row-parallel, the parts
      all-reduced (``reduce``).
    * The GLU MLP by ``d_ff`` (``w_down`` row-parallel).
    * MoE expert-parallel (``experts``: each position's shards for
      ``moe_lib.moe_glu_sharded``).
    * SSM (``columns``, ``conv``, ``scan``, ``gated_out``): ``in_proj``
      column-parallel and its output gathered, the depthwise conv by
      channels and gathered, the SSD scan by heads (with B and C whole) or
      once on ``home`` where the heads stay whole, the gated RMS norm by
      the stored split of ``d_inner`` with its sum of squares all-reduced
      in fp32, ``out_proj`` row-parallel.
    * The vocabulary-split embedding is all-reduced; the vocabulary-split
      head's logits are gathered whole on ``home``."""

    def __init__(self, model: Transformer, dims: dict, devices, home):
        check_tp(model.cfg, dims, len(devices))
        self.cfg, self.dims, self.tree = model.cfg, dims, None
        self.devices = tuple(torch.device(d) for d in devices)
        self.home = torch.device(home)
        self._paths = {m: n for n, m in model.named_modules()}

    @property
    def t(self) -> int:
        return len(self.devices)

    def bind(self, tree: dict) -> tuple[dict, TensorParallel]:
        """``(the whole weights to bind by name, this hook reading tree)``."""
        out = copy.copy(self)
        out.tree = tree
        return {k: v for k, v in tree.items() if k in self.dims and self.dims[k] is None}, out

    def _split(self, module: nn.Module, name: str) -> bool:
        return self.dims[f"{self._paths[module]}.{name}"] is not None

    def _part(self, module: nn.Module, name: str, j: int) -> torch.Tensor:
        from repro_torch.launch.model_axis import shard_key
        path = f"{self._paths[module]}.{name}" if self._paths[module] else name
        if self.dims[path] is None:
            return getattr(module, name).to(self.devices[j])
        return self.tree[shard_key(path, j)]

    def _parts(self, module: nn.Module, name: str) -> list[torch.Tensor]:
        return [self._part(module, name, j) for j in range(self.t)]

    def _narrowed(self, module: nn.Module, name: str, j: int, along: int, start: int,
                  length: int) -> torch.Tensor:
        """Position ``j``'s ``[start, start + length)`` along ``along`` of
        weight ``name``, gathered from its shards (or whole)."""
        from repro_torch.launch import model_axis
        key = f"{self._paths[module]}.{name}"
        dim = self.dims[key]
        shards = [getattr(module, name)] if dim is None else \
            [self.tree[model_axis.shard_key(key, i)] for i in range(self.t)]
        return model_axis.gather_narrow(shards, dim, self.devices[j], along, start, length)

    def _kv_narrow(self, module: nn.Module, j: int):
        """Where the query heads split evenly but the KV heads do not (MQA's
        one head, say), position ``j``'s getter of a KV weight: whole
        (gathered), narrowed to the KV heads its query heads read (query
        head ``h`` reads KV head ``h // (H / KV)``); None where the KV
        heads split too."""
        cfg, t = self.cfg, self.t
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        hj, g = H // t, H // KV
        if KV % t == 0 and self._split(module, "wk"):
            return None
        first, last = j * hj // g, ((j + 1) * hj - 1) // g + 1
        return lambda name: self._narrowed(module, name, j, -1, first * hd, (last - first) * hd)

    def _group_getter(self, module: nn.Module, j: int, k0: int, k1: int):
        """Position ``j``'s getter over whole KV groups ``[k0, k1)`` (the
        query heads that read them): every head-split weight gathered and
        narrowed, ``wo`` by rows."""
        hd, g = self.cfg.resolved_head_dim, self.cfg.n_heads // self.cfg.n_kv_heads
        q = (k0 * g * hd, (k1 - k0) * g * hd)
        kv = (k0 * hd, (k1 - k0) * hd)
        spans = {"wq": (-1,) + q, "bq": (-1,) + q, "wo": (0,) + q,
                 "wk": (-1,) + kv, "wv": (-1,) + kv, "bk": (-1,) + kv, "bv": (-1,) + kv}

        def get(name):
            if name in spans:
                return self._narrowed(module, name, j, *spans[name])
            return self._part(module, name, j)
        return get

    def parts(self, module: nn.Module, x: torch.Tensor) -> list:
        from repro_torch.launch import model_axis
        attn = isinstance(module, Attention)
        if not self._split(module, "wq" if attn else "w_gate"):
            return super().parts(module, x)
        xs = model_axis.to_positions(x, self.devices)
        if attn and self.cfg.n_heads % self.t:
            return [(xj, self._group_getter(module, j, k0, k1))
                    for j, (xj, (k0, k1)) in enumerate(
                        zip(xs, kv_groups(self.cfg.n_kv_heads, self.t)))]
        out = []
        for j, xj in enumerate(xs):
            kv = self._kv_narrow(module, j) if attn else None

            def get(n, j=j, kv=kv):
                if kv is not None and n in ("wk", "wv", "bk", "bv"):
                    return kv(n)
                return self._part(module, n, j)
            out.append((xj, get))
        return out

    def reduce(self, outs: list[torch.Tensor]) -> torch.Tensor:
        from repro_torch.launch import model_axis
        return outs[0] if len(outs) == 1 else \
            model_axis.reduce_from_positions(outs, self.home)

    def experts(self, module: nn.Module, x: torch.Tensor) -> tuple[list, tuple]:
        """Position ``j``'s shards of the experts (``check_tp``: all four
        leaves split along the expert axis, or none)."""
        if not self._split(module, "w_gate"):
            return super().experts(module, x)
        return [self._parts(module, n) for n in _EXPERT_LEAVES], self.devices

    def columns(self, module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x @ weight`` column-parallel over its shards, the outputs
        gathered on ``home`` (``in_proj``: a split cuts through its packed
        ``[z | x | B | C | dt]``)."""
        from repro_torch.launch import model_axis as MA
        if not self._split(module, name):
            return super().columns(module, name, x)
        return MA.gather_from_positions(
            [xj @ w for xj, w in zip(MA.to_positions(x, self.devices),
                                     self._parts(module, name))], -1, self.home)

    def conv(self, block: nn.Module, xbc: torch.Tensor, tail: torch.Tensor | None = None):
        """The depthwise conv by its channel shards (exact), gathered; in
        training (no tail)."""
        from repro_torch.launch import model_axis as MA
        if not self._split(block, "conv_w"):
            return super().conv(block, xbc, tail)
        outs = [ssm_lib.causal_conv1d(c, w, cb)[0] for c, w, cb in zip(
            MA.scatter_to_positions(xbc, -1, self.devices), self._parts(block, "conv_w"),
            self._parts(block, "conv_b"))]
        return MA.gather_from_positions(outs, -1, self.home), None

    def scan(self, block: nn.Module, cfg: ArchConfig, xh, dt, Bc, Cc):
        """The scan by SSD heads, B and C whole on every position, gathered;
        once on ``home`` where the heads stay whole."""
        from repro_torch.launch import model_axis as MA
        if not self._split(block, "A_log"):
            return super().scan(block, cfg, xh, dt, Bc, Cc)
        devs = self.devices
        ys = [_scan(cfg, *a)[0] for a in zip(
            MA.scatter_to_positions(xh, 2, devs), MA.scatter_to_positions(dt, -1, devs),
            MA.to_positions(Bc, devs), MA.to_positions(Cc, devs),
            self._parts(block, "dt_bias"), self._parts(block, "A_log"), self._parts(block, "D"))]
        return MA.gather_from_positions(ys, 2, self.home), None

    def gated_out(self, block: nn.Module, cfg: ArchConfig, y: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
        """The gate and RMS norm by the stored split of ``d_inner``, each
        position's fp32 sum of squares all-reduced (the whole row's
        statistics), ``out_proj`` row-parallel and all-reduced."""
        from repro_torch.launch import model_axis as MA
        if not self._split(block, "norm"):
            return super().gated_out(block, cfg, y, z)
        devs = self.devices
        gated = [ssm_lib.gate(yj, zj) for yj, zj in zip(MA.scatter_to_positions(y, -1, devs),
                                                          MA.scatter_to_positions(z, -1, devs))]
        var = MA.reduce_from_positions(
            [g.to(torch.float32).square().sum(-1, keepdim=True) for g in gated],
            self.home) / y.shape[-1]
        return MA.reduce_from_positions(
            [L.rms_norm(g, w, cfg.norm_eps, var=v) @ wo for g, v, w, wo in zip(
                gated, MA.to_positions(var, devs), self._parts(block, "norm"),
                self._parts(block, "out_proj"))], self.home)

    def embed(self, model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
        """Each position looks up the tokens in its rows (zero elsewhere);
        the positions' rows all-reduced, so each row arrives exactly."""
        if self.dims["embed"] is None:
            return super().embed(model, tokens)
        parts = []
        for j, dev in enumerate(self.devices):
            w = self._part(model, "embed", j)
            rows = w.shape[0]
            local = tokens.to(dev) - j * rows
            inside = (local >= 0) & (local < rows)
            got = w[local.clamp(0, rows - 1)]
            parts.append(torch.where(inside[..., None], got,
                                     torch.zeros((), dtype=got.dtype, device=dev)))
        return self.reduce(parts)

    def logits(self, model: nn.Module, h: torch.Tensor) -> torch.Tensor:
        from repro_torch.launch import model_axis
        tied = self.cfg.tie_embeddings
        name = "embed" if tied else "lm_head"
        if self.dims[name] is None:
            return super().logits(model, h)
        parts = []
        for j, x in enumerate(model_axis.to_positions(h, self.devices)):
            w = self._part(model, name, j)
            parts.append((x @ (w.t() if tied else w)).to(torch.float32))
        return model_axis.gather_from_positions(parts, -1, self.home)
