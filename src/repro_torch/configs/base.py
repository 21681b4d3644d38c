"""``ArchConfig``, the CPU smoke reduction, and the input shapes and
smoke batches of the zoo, as plain Python."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|vlm|audio|hybrid
    n_layers: int
    d_model: int
    n_heads: int                         # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1e4
    # mlp
    activation: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_group: int = 512
    capacity_factor: float = 1.25
    moe_token_parallel: bool = False
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_kernel: int = 4
    # enc-dec (audio)
    encoder_layers: int = 0
    source_positions: int = 1536
    # vlm
    vision_tokens: int = 0
    # misc
    norm: str = "rms"                    # rms | ln
    pos: str = "rope"                    # rope | learned
    tie_embeddings: bool = False
    embed_scale: bool = False            # embeddings * sqrt(d)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    blockwise_train: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        return self.arch_type == "ssm" or self.sliding_window is not None

    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def reduced(cfg: ArchConfig, d_model: int = 256) -> ArchConfig:
    """The CPU smoke variant: 2 layers, d_model<=512, <=4 experts -- same
    family (``repro/configs/base.py::reduced``)."""
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, n_heads) if n_heads else 0
    upd = dict(
        n_layers=2, d_model=d_model,
        n_heads=n_heads, n_kv_heads=max(kv, 1) if n_heads else 0,
        head_dim=64 if cfg.n_heads else None,
        d_ff=max(cfg.d_ff // 16, 64) if not cfg.is_moe else 128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
        moe_group=64,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_head_dim=32 if cfg.ssm_heads else cfg.ssm_head_dim,
        encoder_layers=2 if cfg.encoder_layers else 0,
        source_positions=64 if cfg.encoder_layers else cfg.source_positions,
        vision_tokens=16 if cfg.vision_tokens else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        dtype="float32", remat=False,
        name=cfg.name + "-smoke",
    )
    return dataclasses.replace(cfg, **upd)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode (the port's batches: train)


def token_split(cfg: ArchConfig, seq_len: int) -> tuple[int, int]:
    """(text tokens, modality tokens) of a sequence of ``seq_len``: a VLM
    spends ``min(vision_tokens, seq_len // 2)`` on its stub vision tokens
    (``repro/configs/base.py::_token_split``)."""
    if cfg.arch_type == "vlm":
        v = min(cfg.vision_tokens, seq_len // 2)
        return seq_len - v, v
    return seq_len, 0


def make_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0, device=None) -> dict:
    """A training batch of ``shape`` (``repro/configs/base.py::make_batch``):
    ``{"batch": {"tokens", "labels"}}`` over the text span, labels equal to
    the tokens as the reference fills them (a trainer shifts them), plus a
    VLM's ``vision_embeds (B, vision, d)`` and an audio model's ``enc_feats
    (B, source_positions, d)`` in the model's dtype, filled with 0.01 as the
    reference fills its stub frontends' outputs.  Tokens are uniform over
    the vocab from a generator seeded with ``seed`` (the reference draws
    them with ``jax.random``).  The serving paths build their own prompts
    and caches."""
    if shape.kind != "train":
        raise ValueError(f"the port makes train batches only, not {shape.kind!r}")
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    text, vis = token_split(cfg, shape.seq_len)
    B, dt = shape.global_batch, cfg.torch_dtype()
    tokens = torch.randint(0, cfg.vocab, (B, text), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.full((B, vis, cfg.d_model), 0.01, dtype=dt, device=dev)
    if cfg.arch_type == "audio":
        batch["enc_feats"] = torch.full((B, cfg.source_positions, cfg.d_model), 0.01,
                                        dtype=dt, device=dev)
    return {"batch": batch}


# the reference's four input shapes (``repro/configs/base.py::INPUT_SHAPES``)
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ArchConfig, shape: InputShape) -> str | None:
    """Why the dry run leaves ``(cfg, shape)`` out, or None
    (``repro/launch/dryrun.py::skip_reason``)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention architecture without a sliding-window/SSM "
                "variant: 524k dense decode is intentionally N/A (DESIGN.md)")
    return None


def input_specs(cfg: ArchConfig, shape: InputShape, device="meta", batch: int | None = None
                ) -> dict:
    """Every model input of ``(cfg, shape)`` as empty tensors on ``device``
    (meta by default: no memory, no data), the reference's shapes and
    dtypes (``repro/configs/base.py::input_specs``): ``{"batch": ...}``,
    and for decode also ``"cache"`` (``transformer.init_cache``'s layout,
    ``seq_len`` deep).  ``batch`` replaces ``shape.global_batch`` (the rows
    one data shard holds).  Tokens are int32 as in the reference; nothing
    is drawn."""
    B = shape.global_batch if batch is None else batch
    dt, i32 = cfg.torch_dtype(), torch.int32
    text, vis = token_split(cfg, shape.seq_len)

    def empty(*size, dtype=dt):
        return torch.empty(size, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": empty(B, text, dtype=i32)}
        if shape.kind == "train":
            out["labels"] = empty(B, text, dtype=i32)
        if cfg.arch_type == "vlm":
            out["vision_embeds"] = empty(B, vis, cfg.d_model)
        if cfg.arch_type == "audio":
            out["enc_feats"] = empty(B, cfg.source_positions, cfg.d_model)
        return {"batch": out}
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    from repro_torch.models.transformer import init_cache
    out = {"tokens": empty(B, 1, dtype=i32), "positions": empty(B, dtype=i32)}
    if cfg.arch_type == "audio":
        out["enc_out"] = empty(B, cfg.source_positions, cfg.d_model)
    return {"batch": out, "cache": init_cache(cfg, B, shape.seq_len, device=device)}
