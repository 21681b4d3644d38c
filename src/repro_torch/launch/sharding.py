"""Logical-axis -> mesh-axis sharding rules (``repro/launch/sharding.py``),
over a mesh given as axis names and sizes (``launch/mesh.py``).

Every parameter of the zoo names the logical axis of each dimension
(``models/transformer.py::Spec.logical``).  A rule table maps each logical
axis to an ordered list of candidate mesh axes (a name, or a tuple of
names sharding one dimension together); the first candidate whose size
divides the dimension and is not already used by the same parameter wins,
else the dimension is replicated.  A placement is a tuple with one entry a
dimension -- ``None``, a mesh axis, or a tuple of them -- trailing
``None`` dropped, as ``jax.sharding.PartitionSpec`` holds it.

  TRAIN_RULES  FSDP x TP: "embed" shards over the data axes, the wide
               dimensions over "model".
  INFER_RULES  the same (big checkpoints shard their weights at inference
               too); decode caches shard their batch over the data axes.

Each ``*_shardings`` function returns a ``Sharding`` per leaf: its
placement and the shape one device holds.  No device or process group is
needed; mapping a placement onto a live ``DeviceMesh`` waits for the
distributed runtime (``launch/mesh.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import AbstractMesh, data_axes, model_axis_size

TRAIN_RULES: dict[str, list] = {
    "vocab": ["model"],
    "embed": [("pod", "data"), "data"],   # FSDP/ZeRO-3 style weight sharding
    "heads": ["model"],
    "kv_heads": ["model"],
    "head_dim": [],
    "mlp": ["model"],
    "expert": ["model"],
    "layers": [],
    "ssm_proj": ["model"],
    "ssm_conv": ["model"],
    "ssm_inner": ["model"],
    "ssm_heads": ["model"],
    "conv": [],
    "pos": [],
}

INFER_RULES = dict(TRAIN_RULES)


def model_only_rules(rules: dict[str, list] | None = None) -> dict[str, list]:
    """Every candidate but ``"model"`` stripped from a rule table: federated
    replicas diverge during a round, so their weights never shard over the
    mediator / data axes."""
    rules = rules or TRAIN_RULES
    return {k: [a for a in v if a == "model"] for k, v in rules.items()}


@dataclass(frozen=True)
class Sharding:
    """One leaf's placement (``PartitionSpec``-like tuple) and the shape of
    the shard each device holds."""
    spec: tuple
    shard_shape: tuple[int, ...]

    def nbytes(self, dtype: torch.dtype) -> int:
        """Bytes one device holds of this leaf in ``dtype``."""
        return math.prod(self.shard_shape) * dtype.itemsize


def _axes_of(entry) -> tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh: AbstractMesh) -> tuple[int, ...]:
    sizes = mesh.shape
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in _axes_of(p)) for d, p in zip(shape, spec))


def _sharding(shape, spec: tuple, mesh: AbstractMesh) -> Sharding:
    return Sharding(spec, shard_shape(tuple(shape), spec, mesh))


def spec_for(shape: tuple[int, ...], axes: tuple[str, ...], mesh: AbstractMesh,
             rules: dict[str, list]) -> tuple:
    """The placement of one parameter under the rule table."""
    sizes = mesh.shape
    used: set[str] = set()
    parts: list = []
    for dim, logical in zip(shape, axes):
        chosen = None
        for cand in rules.get(logical, []):
            cand_t = cand if isinstance(cand, tuple) else (cand,)
            if any(a not in sizes or a in used for a in cand_t):
                continue
            size = math.prod(sizes[a] for a in cand_t)
            if dim % size == 0 and dim >= size:
                chosen = cand_t if len(cand_t) > 1 else cand_t[0]
                used.update(cand_t)
                break
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_shardings(specs: dict, mesh: AbstractMesh,
                    rules: dict[str, list] | None = None) -> dict[str, Sharding]:
    """``{name: Sharding}`` for ``transformer.param_specs``' specs (each
    with ``shape`` and ``logical``)."""
    rules = rules or TRAIN_RULES
    return {k: _sharding(sp.shape, spec_for(sp.shape, sp.logical, mesh, rules), mesh)
            for k, sp in specs.items()}


def per_parameter(specs: dict, shards: dict[str, Sharding]) -> dict[str, Sharding]:
    """``param_shardings``' result keyed by the port's parameter names
    (``Spec.names``: ``layers.3.attn.wq``): a stacked spec's slice drops
    its leading layer axis, which no rule table shards."""
    out = {}
    for k, sp in specs.items():
        sh = shards[k]
        if len(sp.names) == 1 and sp.names[0] == k:
            out[k] = sh
            continue
        if sh.spec and sh.spec[0] is not None:
            raise ValueError(f"{k}: its layer axis is sharded ({sh.spec})")
        one = Sharding(sh.spec[1:], sh.shard_shape[1:])
        out.update({name: one for name in sp.names})
    return out


def adapter_shardings(mapping: dict, specs: dict, mesh: AbstractMesh,
                      rules: dict[str, list] | None = None
                      ) -> tuple[dict[str, Sharding], dict[str, Sharding]]:
    """``(state, A)`` shardings of a LoRA mapping table
    (``models/lora.py``) over the model's ``specs`` (their ``logical``
    axes).  A dense entry takes its backbone tensor's placement; a
    factorized one keeps the batch axes' rules, puts the backbone's last
    logical axis on B's ``dout`` and ``"lora_din"`` on A's ``din``, and
    its rank ``"lora_rank"`` -- in no table, so replicated."""
    rules = rules or TRAIN_RULES
    logical = {k.replace(".", "/"): sp.logical for k, sp in specs.items()}
    state, a = {}, {}
    for path, e in mapping.items():
        axes = logical[path]
        if e.kind == "dense":
            state[path] = _sharding(e.shape, spec_for(e.shape, axes, mesh, rules), mesh)
            continue
        state[path] = _sharding(e.state_shape, spec_for(
            e.state_shape, e.batch_axes + ("lora_rank", axes[-1]), mesh, rules), mesh)
        a[path] = _sharding(e.a_shape, spec_for(
            e.a_shape, e.batch_axes + ("lora_din", "lora_rank"), mesh, rules), mesh)
    return state, a


def _data_size(mesh: AbstractMesh) -> tuple[str | tuple[str, ...], int]:
    """The data axes as one placement entry (a lone axis by its name, as
    ``PartitionSpec`` keeps it) and their size."""
    daxes = data_axes(mesh)
    return daxes[0] if len(daxes) == 1 else daxes, math.prod(mesh.shape[a] for a in daxes)


def batch_shardings(batch: dict, mesh: AbstractMesh) -> dict[str, Sharding]:
    """The leading (batch) dimension of every input over the data axes,
    where it divides; else replicated."""
    daxes, dsize = _data_size(mesh)

    def leaf(t):
        if t.dim() and t.shape[0] % dsize == 0 and t.shape[0] >= dsize:
            return _sharding(t.shape, (daxes,), mesh)
        return _sharding(t.shape, (), mesh)
    return {k: leaf(t) for k, t in batch.items()}


def cache_shardings(cache: dict, mesh: AbstractMesh) -> dict:
    """Decode caches ``(layers, batch, ...)``: the batch (axis 1) over the
    data axes, and the KV-head axis of an attention cache ``(L, b, S, KV,
    d)`` (axis 3) or the head axis of an SSM state ``(L, b, h, p, n)``
    (axis 2) over ``model``, where they divide.  Nested like ``cache``."""
    daxes, dsize = _data_size(mesh)
    msize = model_axis_size(mesh)

    def leaf(t):
        shape = tuple(t.shape)
        parts: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dsize == 0 and shape[1] >= dsize:
            parts[1] = daxes
        for ax in (3, 2):
            if len(shape) > ax + 1 and parts[ax] is None \
                    and shape[ax] % msize == 0 and shape[ax] >= msize:
                parts[ax] = "model"
                break
        while parts and parts[-1] is None:
            parts.pop()
        return _sharding(shape, tuple(parts), mesh)
    return {k: cache_shardings(v, mesh) if isinstance(v, dict) else leaf(v)
            for k, v in cache.items()}


def replicated(shape, mesh: AbstractMesh) -> Sharding:
    return _sharding(shape, (), mesh)


def opt_state_shardings(opt_state: dict, param_shards: dict[str, Sharding],
                        mesh: AbstractMesh) -> dict:
    """Optimizer state (``optim/optimizers.py``: ``{"step": int, "mu": {name:
    tensor}, ...}``): each moment dict mirrors its parameters' shardings
    (``param_shards`` keyed by parameter name, ``per_parameter``), the
    step and any other leaf is replicated."""
    out: dict = {}
    for k, v in opt_state.items():
        if isinstance(v, dict):
            out[k] = {name: param_shards[name] for name in v}
        else:
            out[k] = replicated(getattr(v, "shape", ()), mesh)
    return out
