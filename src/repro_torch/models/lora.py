"""Per-tensor LoRA adapter mapping tables (``repro/models/lora.py``).

The backbone ``W`` is frozen on every participant, each weight tensor gets
a rank-``r`` adapter, and only the adapter state crosses the WAN.  One
mapping entry per backbone tensor path records how its adapter is shaped,
initialized, merged and costed:

* ``factorized``: a tensor with a ``(din, dout)`` matmul shape and ``rank <
  min(din, dout)``.  ``A (batch..., din, rank)`` is frozen and derived from
  a shared seed (never on the wire); the trainable state is ``B (batch...,
  rank, dout)``, zero at round 0.  Merge: ``W + (alpha / rank) * (A @
  B).reshape(W.shape)``, in fp32, cast back to ``W``'s dtype.
* ``dense``: 1-D tensors after the batch axes, or ``rank >= min(din,
  dout)``.  The state entry is the effective tensor itself (a copy of the
  backbone value at round 0), merged by pass-through, so at full rank the
  round is the full-delta round bit for bit.

``rank=0`` gives an empty mapping: nothing trains, nothing is exchanged.

The adapter trees keep the reference's layout, so the WAN bytes equal the
reference's by construction: flat dicts keyed by the ``/``-joined path of
the reference's parameter pytree (``layers/attn/wq``, ``conv1/w``), in its
sorted order, with leading ``BATCH_AXES`` batching the factorization
(``A (L, d, r)``, ``B (L, r, h)``) and each tensor in the reference's
layout (a conv ``(kh, kw, cin, cout)``, a dense ``(din, dout)``).  Where
the port's weights differ -- one module per layer (``layers.3.attn.wq``),
a conv's ``(cout, cin, kh, kw)``, an ``nn.Linear``'s ``(dout, din)`` --
the model's ``param_specs`` say how: each spec gives the port's parameter
names it covers (one per batch slice) and the permutation from the
reference's layout to the port's.  ``merge_params`` forms each update in
the reference's layout, then slices and permutes it onto the port's
weights; a dense entry's state stays in the reference's layout.
``MergedModel`` trains a model through the adapter state.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import torch

# the seed the launchers derive the frozen-A stream from (the reference
# folds the same salt into its key)
A_SALT = 0x10AA
# leading logical axes that batch the factorization instead of folding
# into din (stacked decoder layers; the reference's MoE experts)
BATCH_AXES = ("layers", "expert")


def path_of(spec_name: str) -> str:
    """``param_specs`` name (``layers.attn.wq``) -> mapping path
    (``layers/attn/wq``); a path (``conv1/w``) stays as it is."""
    return spec_name.replace(".", "/")


@dataclass(frozen=True)
class LoraEntry:
    """One mapping-table row: how tensor ``path`` is adapted, and which of
    the port's parameters it covers (``names``, one per batch slice) in
    which layout (``perm`` takes the reference's to the port's)."""
    path: str
    shape: tuple            # full backbone tensor shape (the reference's)
    batch_shape: tuple      # leading batch dims
    batch_axes: tuple       # their axis names
    din: int                # prod(non-batch dims except the last); 0 for 1-D
    dout: int               # last dim
    rank: int
    alpha: float
    kind: str               # "factorized" | "dense"
    names: tuple = ()       # the port's parameter names
    perm: tuple | None = None

    @property
    def state_shape(self) -> tuple:
        if self.kind == "dense":
            return self.shape
        return self.batch_shape + (self.rank, self.dout)

    @property
    def a_shape(self) -> tuple:
        if self.kind != "factorized":
            raise ValueError(f"{self.path}: a dense entry has no A")
        return self.batch_shape + (self.din, self.rank)

    @property
    def state_params(self) -> int:
        return math.prod(self.state_shape)


def _split(spec) -> tuple[tuple, tuple, tuple]:
    """(batch axes, batch shape, rest) of a spec: its leading axes named in
    ``BATCH_AXES`` batch the factorization."""
    nb = 0
    while nb < len(spec.axes) and spec.axes[nb] in BATCH_AXES:
        nb += 1
    shape = tuple(spec.shape)
    return tuple(spec.axes[:nb]), shape[:nb], shape[nb:]


def build_mapping(specs: dict, rank: int, alpha: float | None = None
                  ) -> dict[str, LoraEntry]:
    """Adapter mapping table from a model's ``param_specs`` (each spec with
    ``shape``, ``axes``, ``names`` and ``perm``).  ``alpha=None`` is
    ``alpha=rank`` (merge scale 1); ``rank=0`` is the empty mapping."""
    if rank < 0:
        raise ValueError(f"lora rank must be >= 0, got {rank}")
    if rank == 0:
        return {}
    mapping: dict[str, LoraEntry] = {}
    for name in sorted(specs, key=path_of):
        spec = specs[name]
        batch_axes, batch_shape, rest = _split(spec)
        dout = int(rest[-1]) if rest else 0
        din = math.prod(rest[:-1]) if len(rest) > 1 else 0
        if len(rest) < 2 or rank >= min(din, dout):
            kind, r_eff = "dense", 0
        else:
            kind, r_eff = "factorized", rank
        path = path_of(name)
        mapping[path] = LoraEntry(
            path=path, shape=tuple(spec.shape), batch_shape=batch_shape,
            batch_axes=batch_axes, din=din, dout=dout, rank=r_eff,
            alpha=float(alpha) if alpha is not None else float(rank), kind=kind,
            names=tuple(spec.names), perm=spec.perm)
    return mapping


def full_rank(specs: dict) -> int:
    """Smallest rank at which every entry is dense (the full-delta round,
    bit for bit)."""
    need = 1
    for spec in specs.values():
        _, _, rest = _split(spec)
        if len(rest) >= 2:
            need = max(need, min(math.prod(rest[:-1]), int(rest[-1])))
    return need


def _to_port(t: torch.Tensor, perm) -> torch.Tensor:
    """A slice in the reference's layout, in the port's."""
    return t if perm is None else t.permute(perm).contiguous()


def _to_reference(t: torch.Tensor, perm) -> torch.Tensor:
    """A port weight in the reference's layout."""
    if perm is None:
        return t
    inverse = [0] * len(perm)
    for i, p in enumerate(perm):
        inverse[p] = i
    return t.permute(inverse).contiguous()


def init_adapter_A(seed: int, mapping: dict[str, LoraEntry], device=None) -> dict:
    """The frozen factor bases ``{path: A}`` of the factorized entries:
    standard normal over ``sqrt(din)``, fp32, each from its own
    ``torch.Generator`` seeded by ``seed`` and the CRC32 of its path, so
    both ends of the WAN regenerate the same basis.  (The reference draws
    its A with ``jax.random``; the parity tests inject those.)"""
    dev = torch.device("cpu" if device is None else device)
    out = {}
    for path, e in mapping.items():
        if e.kind != "factorized":
            continue
        crc = zlib.crc32(path.encode()) & 0x7FFFFFFF
        gen = torch.Generator(device=dev).manual_seed(((int(seed) & 0x7FFFFFFF) << 31) | crc)
        a = torch.randn(e.a_shape, generator=gen, dtype=torch.float32, device=dev)
        out[path] = a / math.sqrt(e.din)
    return out


def init_adapter_state(mapping: dict[str, LoraEntry],
                       backbone: dict[str, torch.Tensor]) -> dict:
    """Round-0 adapter state: zero fp32 ``B`` for factorized entries, a copy
    of the backbone value (stacked over the batch slices, in the
    reference's layout) for dense ones."""
    out = {}
    for path, e in mapping.items():
        if e.kind == "dense":
            missing = [n for n in e.names if n not in backbone]
            if missing:
                raise KeyError(f"mapping entry {path!r} not found in the backbone "
                               f"({missing[0]!r})")
            parts = [_to_reference(backbone[n], e.perm) for n in e.names]
            out[path] = torch.stack(parts) if e.batch_shape else parts[0].clone()
        else:
            dev = backbone[e.names[0]].device
            out[path] = torch.zeros(e.state_shape, dtype=torch.float32, device=dev)
    return out


def merge_params(backbone: dict[str, torch.Tensor], a_tree: dict, state: dict,
                 mapping: dict[str, LoraEntry]) -> dict[str, torch.Tensor]:
    """Effective weights, keyed like ``backbone`` (the port's parameter
    names): dense entries pass the state through (batch slice ``i`` of a
    stacked entry), factorized ones add the scaled ``A @ B`` in fp32 and
    cast back to the backbone's dtype; each slice is permuted into the
    port's layout; tensors with no entry stay frozen.  Differentiable in
    ``state``."""
    out = dict(backbone)
    for path, e in mapping.items():
        if e.kind == "dense":
            full = state[path]
        else:
            full = (e.alpha / e.rank) * torch.matmul(a_tree[path], state[path]).reshape(e.shape)
        # one batch slice each: ``unbind``, whose gradient stacks the
        # slices' in one op (indexing would scatter each into a zero copy
        # of the whole stacked tensor)
        parts = full.unbind(0) if e.batch_shape else (full,)
        for n, part in zip(e.names, parts):
            w, part = backbone[n], _to_port(part, e.perm)
            out[n] = part.to(w.dtype) if e.kind == "dense" \
                else (w.to(torch.float32) + part).to(w.dtype)
    return out


def flat_layout(mapping: dict[str, LoraEntry], state: dict, backbone: dict):
    """The flat row buffer's layout (``kernels.ops.FlatLayout``) over an
    adapter ``state``: each entry at the place of the port weight it covers
    (the ``backbone``'s order), a dense entry stored in the port's layout.
    At full rank every column then lies where the full-delta round's does,
    so Eq. 6 -- even a plain version whose sum depends on a column's
    position, as a vectorized ``sum(0)``'s last columns do -- gives the
    same bits."""
    from repro_torch.kernels.ops import FlatLayout
    where = {n: i for i, n in enumerate(backbone)}
    order = sorted(state, key=lambda p: where[mapping[p].names[0]])
    return FlatLayout({p: state[p] for p in order},
                      {p: e.perm for p, e in mapping.items()
                       if e.kind == "dense" and e.perm is not None})


def merge_shards(backbone: dict[str, torch.Tensor], a_tree: dict, state: dict,
                 mapping: dict[str, LoraEntry], dims: dict[str, int | None],
                 t: int) -> dict[str, torch.Tensor]:
    """``merge_params`` onto a backbone split over a model axis of ``t``
    (``models/cnn.py::shard_key(name, j)`` for column ``j``'s shard of a
    leaf that ``dims`` splits, the name itself for a whole leaf): each
    entry's update is formed whole, as ``merge_params`` forms it, and its
    slice along the leaf's split dimension added to each shard, so a
    shard's merged weight is the same bits as the same slice of
    ``merge_params``' weight.  The backbone is never gathered."""
    from repro_torch.launch.model_axis import shard_key
    out = dict(backbone)
    for path, e in mapping.items():
        if e.kind == "dense":
            full = state[path]
        else:
            full = (e.alpha / e.rank) * torch.matmul(a_tree[path], state[path]).reshape(e.shape)
        parts = full.unbind(0) if e.batch_shape else (full,)
        for n, part in zip(e.names, parts):
            part, dim = _to_port(part, e.perm), dims[n]
            keys = [n] if dim is None else [shard_key(n, j) for j in range(t)]
            size = part.shape[dim] // t if dim is not None else None
            for j, key in enumerate(keys):
                w = backbone[key]
                piece = part if dim is None else part.narrow(dim, j * size, size)
                piece = piece.to(w.device)
                out[key] = piece.to(w.dtype) if e.kind == "dense" \
                    else (w.to(torch.float32) + piece).to(w.dtype)
    return out


class MergedModel:
    """``model`` trained through a LoRA adapter state: ``apply(state, ...)``
    merges ``state`` into the frozen ``backbone`` with the frozen A bases
    (``merge_params``; with ``dims`` and ``t``, into a backbone split over
    a model axis, ``merge_shards``) and applies ``model`` to the merged
    weights -- the reference's ``dc_replace(model, apply=...merge_params...)``.
    Every other attribute is the model's."""

    def __init__(self, model, backbone: dict, a_tree: dict,
                 mapping: dict[str, LoraEntry], *, dims: dict | None = None,
                 t: int = 1):
        self.model, self.backbone, self.a_tree, self.mapping = \
            model, backbone, a_tree, mapping
        self.dims, self.t = dims, t

    def apply(self, state: dict, *args, **kwargs):
        if self.dims is None:
            merged = merge_params(self.backbone, self.a_tree, state, self.mapping)
        else:
            merged = merge_shards(self.backbone, self.a_tree, state, self.mapping,
                                  self.dims, self.t)
        return self.model.apply(merged, *args, **kwargs)

    def __getattr__(self, name):
        if "model" not in self.__dict__:        # mid-copy: not built yet
            raise AttributeError(name)
        return getattr(self.model, name)


def exchange_nbytes(mapping: dict[str, LoraEntry], bytes_per_param: int = 4) -> int:
    """Bytes of one model-exchange leg: the state only (A is seed-derived
    on both ends, never on the wire)."""
    return num_trainable_params(mapping) * bytes_per_param


def num_trainable_params(mapping: dict[str, LoraEntry]) -> int:
    return sum(e.state_params for e in mapping.values())
