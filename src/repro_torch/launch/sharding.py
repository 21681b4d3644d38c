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
needed for them.  On live tensors (the model axis, ``launch/mesh.py``):
``placements`` gives the dimension of each port parameter that the rules
split over ``model`` (None: replicated), ``shard_params`` cuts a dict of
parameters into its shards on the mesh's positions (``ModelShards``,
``launch/model_axis.py::split``), and ``gather_params`` puts them back
together, bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch import model_axis
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


# ---------------------------------------------------------------------------
# live tensors on the model axis
# ---------------------------------------------------------------------------

def _model_dim(spec: tuple) -> int | None:
    """The dimension a placement puts on ``"model"`` (None: none)."""
    for i, entry in enumerate(spec):
        if "model" in _axes_of(entry):
            if _axes_of(entry) != ("model",):
                raise ValueError(f"placement {spec}: dimension {i} shards over "
                                 f"{entry}, not the model axis alone")
            return i
    return None


def placements(specs: dict, mesh: AbstractMesh,
               rules: dict[str, list] | None = None) -> dict[str, int | None]:
    """``{port parameter name: the dimension the rules split over model, or
    None}`` for a model's specs: a transformer's (``Spec.logical``, a
    stacked layer axis that no table shards, dropped for each layer's
    parameter) or a CNN's (``models/cnn.py::ParamSpec``: ``axes`` in the
    reference's layout, ``perm`` to the port's).  The placement of each is
    ``spec_for``'s, the reference's (``model_only_rules()`` by default)."""
    rules = rules if rules is not None else model_only_rules()
    out: dict[str, int | None] = {}
    for k, sp in specs.items():
        logical = getattr(sp, "logical", ())
        if logical:
            dim = _model_dim(spec_for(sp.shape, logical, mesh, rules))
            if len(sp.names) == 1 and sp.names[0] == k:
                out[k] = dim
                continue
            if dim == 0:
                raise ValueError(f"{k}: its layer axis is sharded")
            out.update({name: None if dim is None else dim - 1 for name in sp.names})
            continue
        dim = _model_dim(spec_for(sp.shape, sp.axes, mesh, rules))
        if dim is not None and sp.perm is not None:
            dim = sp.perm.index(dim)
        out.update({name: dim for name in sp.names})
    return out


@dataclass
class ModelShards:
    """A dict of parameters split over a mesh's model axis: ``positions[p]``
    the shards position ``p`` (row-major, ``launch/mesh.py``) holds -- model
    column ``p % t``'s slice of every split leaf, and every replicated leaf
    whole.  Positions of one column on one device share its tensors;
    another device holds its own copy (the mediator axis replicates)."""
    dims: dict[str, int | None]
    t: int
    positions: list[dict[str, torch.Tensor]]

    def column(self, j: int) -> dict[str, torch.Tensor]:
        """Model column ``j``'s shards (mediator row 0's)."""
        return self.positions[j]

    def position_bytes(self, p: int = 0) -> int:
        """Bytes of parameters position ``p`` holds."""
        return sum(v.nbytes for v in self.positions[p].values())


def shard_params(params: dict[str, torch.Tensor], dims: dict[str, int | None],
                 mesh: AbstractMesh) -> ModelShards:
    """``params`` split over ``mesh``'s model axis by ``dims``
    (``placements``) and replicated over its mediator rows, each shard on
    its position's device."""
    if mesh.devices is None:
        raise ValueError(f"mesh {mesh.shape} carries no devices")
    if set(params) != set(dims):
        raise ValueError(f"params {sorted(set(params) ^ set(dims))} have no placement")
    t = model_axis_size(mesh)
    col_devices = mesh.devices[:t]
    cols: list[dict[str, torch.Tensor]] = [{} for _ in range(t)]
    for k, v in params.items():
        for j, shard in enumerate(model_axis.split(v, dims[k], col_devices)):
            cols[j][k] = shard
    positions = []
    for p, dev in enumerate(mesh.devices):
        col = cols[p % t]
        positions.append({k: v if v.device == dev else model_axis.split(v, None, (dev,))[0]
                          for k, v in col.items()})
    return ModelShards(dict(dims), t, positions)


def fold_shards(shards: ModelShards, agg: dict[str, torch.Tensor], add: bool) -> ModelShards:
    """New shards from whole leaves ``agg``: each shard takes its slice of
    its leaf's aggregate (``add``: plus its own values), on its device, so
    the whole weights are never formed.  Positions that shared a tensor
    share its successor.  Elementwise, so the result is bit for bit the
    split of ``gather + agg`` (or of ``agg``)."""
    done: dict[int, torch.Tensor] = {}
    positions = []
    for p, pos in enumerate(shards.positions):
        j, new = p % shards.t, {}
        for k, v in pos.items():
            if id(v) not in done:
                dim, piece = shards.dims[k], agg[k]
                if dim is not None:
                    piece = piece.narrow(dim, j * v.shape[dim], v.shape[dim])
                done[id(v)] = v + piece.to(v.device) if add \
                    else model_axis.split(piece, None, (v.device,))[0]
            new[k] = done[id(v)]
        positions.append(new)
    return ModelShards(shards.dims, shards.t, positions)


def gather_params(shards: ModelShards, device: torch.device) -> dict[str, torch.Tensor]:
    """The whole parameters on ``device``: every leaf all-gathered from
    mediator row 0's columns, in shard order (exact bytes)."""
    return {k: model_axis.all_gather([shards.positions[j][k] for j in range(shards.t)],
                                     dim, device)
            for k, dim in shards.dims.items()}

