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
the reference's parameter pytree (``layers/attn/wq``), in its sorted order,
with the stacked ``layers`` axis as the batch axis (``A (L, d, r)``, ``B
(L, r, h)``).  The port's weights are one module per layer
(``layers.3.attn.wq``); ``merge_params`` maps between the two.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import torch

# the seed the launchers derive the frozen-A stream from (the reference
# folds the same salt into its key)
A_SALT = 0x10AA


def path_of(spec_name: str) -> str:
    """``param_specs`` name (``layers.attn.wq``) -> mapping path
    (``layers/attn/wq``)."""
    return spec_name.replace(".", "/")


@dataclass(frozen=True)
class LoraEntry:
    """One mapping-table row: how tensor ``path`` is adapted."""
    path: str
    shape: tuple            # full backbone tensor shape (stacked layers)
    batch_shape: tuple      # leading batch dims
    batch_axes: tuple       # their axis names
    din: int                # prod(non-batch dims except the last); 0 for 1-D
    dout: int               # last dim
    rank: int
    alpha: float
    kind: str               # "factorized" | "dense"

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


def _split(name: str, shape: tuple) -> tuple[tuple, tuple, tuple]:
    """(batch axes, batch shape, rest) of a spec: a stacked layer weight
    batches over its leading ``layers`` axis (the reference also batches
    over MoE experts, a family the port does not run)."""
    if name.startswith("layers."):
        return ("layers",), tuple(shape[:1]), tuple(shape[1:])
    return (), (), tuple(shape)


def build_mapping(specs: dict, rank: int, alpha: float | None = None
                  ) -> dict[str, LoraEntry]:
    """Adapter mapping table from ``transformer.param_specs``.  ``alpha=None``
    is ``alpha=rank`` (merge scale 1); ``rank=0`` is the empty mapping."""
    if rank < 0:
        raise ValueError(f"lora rank must be >= 0, got {rank}")
    if rank == 0:
        return {}
    mapping: dict[str, LoraEntry] = {}
    for name in sorted(specs, key=path_of):
        shape = tuple(specs[name].shape)
        batch_axes, batch_shape, rest = _split(name, shape)
        dout = int(rest[-1]) if rest else 0
        din = math.prod(rest[:-1]) if len(rest) > 1 else 0
        if len(rest) < 2 or rank >= min(din, dout):
            kind, r_eff = "dense", 0
        else:
            kind, r_eff = "factorized", rank
        path = path_of(name)
        mapping[path] = LoraEntry(
            path=path, shape=shape, batch_shape=batch_shape, batch_axes=batch_axes,
            din=din, dout=dout, rank=r_eff,
            alpha=float(alpha) if alpha is not None else float(rank), kind=kind)
    return mapping


def full_rank(specs: dict) -> int:
    """Smallest rank at which every entry is dense (the full-delta round,
    bit for bit)."""
    need = 1
    for name, spec in specs.items():
        _, _, rest = _split(name, tuple(spec.shape))
        if len(rest) >= 2:
            need = max(need, min(math.prod(rest[:-1]), int(rest[-1])))
    return need


def _layer_names(e: LoraEntry) -> list[str]:
    """The port's parameter names an entry covers: one per stacked layer,
    or the one top-level tensor."""
    name = e.path.replace("/", ".")
    if not e.batch_shape:
        return [name]
    rest = name[len("layers."):]
    return [f"layers.{i}.{rest}" for i in range(e.batch_shape[0])]


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
    of the backbone value (stacked over layers) for dense ones."""
    out = {}
    for path, e in mapping.items():
        if e.kind == "dense":
            names = _layer_names(e)
            missing = [n for n in names if n not in backbone]
            if missing:
                raise KeyError(f"mapping entry {path!r} not found in the backbone "
                               f"({missing[0]!r})")
            out[path] = torch.stack([backbone[n] for n in names]) if e.batch_shape \
                else backbone[names[0]].clone()
        else:
            dev = backbone[_layer_names(e)[0]].device
            out[path] = torch.zeros(e.state_shape, dtype=torch.float32, device=dev)
    return out


def merge_params(backbone: dict[str, torch.Tensor], a_tree: dict, state: dict,
                 mapping: dict[str, LoraEntry]) -> dict[str, torch.Tensor]:
    """Effective weights, keyed like ``backbone`` (the port's parameter
    names): dense entries pass the state through (layer ``i``'s slice of a
    stacked entry), factorized ones add the scaled ``A @ B`` in fp32 and
    cast back to the backbone's dtype; tensors with no entry stay frozen.
    Differentiable in ``state``."""
    out = dict(backbone)
    for path, e in mapping.items():
        names = _layer_names(e)
        if e.kind == "dense":
            full = state[path]
        else:
            full = (e.alpha / e.rank) * torch.matmul(a_tree[path], state[path]).reshape(e.shape)
        # one layer's slice each: ``unbind``, whose gradient stacks the
        # slices' in one op (indexing would scatter each into a zero copy
        # of the whole stacked tensor)
        parts = full.unbind(0) if e.batch_shape else (full,)
        for n, part in zip(names, parts):
            w = backbone[n]
            out[n] = part.to(w.dtype) if e.kind == "dense" \
                else (w.to(torch.float32) + part).to(w.dtype)
    return out


def exchange_nbytes(mapping: dict[str, LoraEntry], bytes_per_param: int = 4) -> int:
    """Bytes of one model-exchange leg: the state only (A is seed-derived
    on both ends, never on the wire)."""
    return num_trainable_params(mapping) * bytes_per_param


def num_trainable_params(mapping: dict[str, LoraEntry]) -> int:
    return sum(e.state_params for e in mapping.values())
