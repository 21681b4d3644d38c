"""The model axis's collectives, inside one process.

The reference keeps every collective of its ``model`` mesh axis inside one
process (``repro/launch/mesh.py``: processes exchange host payloads only),
and so does the port.  A model-axis position is a place for a shard: a
``torch.device`` of the mesh (``launch/mesh.py``), several of which may
name one card.  Between positions on one device a collective is a device
copy; between two cards it is a peer copy.  Nothing runs on another stream
or in another process.

* ``split``: shard ``i`` of a tensor is its ``narrow`` along the rule
  table's dimension (``launch/sharding.py``), made contiguous on position
  ``i``'s device; ``dim=None`` (a dimension the rules leave replicated)
  keeps the whole tensor on every position.
* ``all_gather``: a ``torch.cat`` of the shards on the target device, in
  shard order.  It moves exact bytes, so a split then a gather gives the
  tensor back bit for bit.
* ``all_reduce``: the partials summed in shard order, ``0`` to ``t - 1``,
  on one device.

For tensor-parallel compute (the CNN engine's ``tp_rows``,
``launch/steps.py::make_fl_round`` on a model axis) four autograd
functions pair the collectives with their gradients, Megatron's ``f`` and
``g``: ``to_positions`` (forward a copy to each position, backward the
all-reduce of the positions' gradients), ``reduce_from_positions``
(forward the all-reduce, backward a copy of the gradient to each position),
``gather_from_positions`` (forward the all-gather, backward each
position's slice of the gradient) and ``scatter_to_positions`` (forward
each position's slice, backward the all-gather of the slices' gradients).
They run under ``torch.func`` (their vmap rule is generated), so the
lockstep rows of the CNN engine can use them.  ``gather_narrow`` is a
weight's all-gather narrowed to the units a position computes (whole heads
or KV groups where the stored split cuts through one).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch


def shard_key(name: str, j: int) -> str:
    """The key of model column ``j``'s shard of parameter ``name`` in a
    tree of shards (what TP rows and the tensor-parallel round train)."""
    return f"{name}@{j}"


def _contiguous_on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that shares no storage with
    it (a peer copy when the devices differ)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def split(t: torch.Tensor, dim: int | None, devices: Sequence[torch.device]
          ) -> list[torch.Tensor]:
    """``len(devices)`` shards of ``t``: shard ``i`` the ``i``-th equal
    slice along ``dim`` on ``devices[i]``, or with ``dim=None`` the whole
    tensor on each.  Each shard is a fresh contiguous tensor."""
    n = len(devices)
    if dim is None:
        return [_contiguous_on(t, d) for d in devices]
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                         f"into {n} shards")
    size = t.shape[dim] // n
    return [_contiguous_on(t.narrow(dim, i * size, size), d)
            for i, d in enumerate(devices)]


def split_tree(params: dict[str, torch.Tensor], dims: dict[str, int | None],
               devices: Sequence[torch.device]) -> dict[str, torch.Tensor]:
    """``params`` as one tree of shards (what a tensor-parallel forward
    reads): a leaf ``dims`` splits as ``split`` cuts it, position ``j``'s
    shard under ``shard_key(name, j)``; a whole leaf under its name, as
    it is."""
    tree = {}
    for k, p in params.items():
        if dims[k] is None:
            tree[k] = p
        else:
            for j, shard in enumerate(split(p, dims[k], devices)):
                tree[shard_key(k, j)] = shard
    return tree


def all_gather(shards: Sequence[torch.Tensor], dim: int | None,
               device: torch.device) -> torch.Tensor:
    """The tensor ``split`` cut, whole on ``device``: the shards
    concatenated along ``dim`` in shard order (``dim=None``: shard 0's
    copy)."""
    if dim is None:
        return _contiguous_on(shards[0], device)
    return torch.cat([s.to(device) for s in shards], dim)


def all_reduce(partials: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of ``partials`` on ``device``, added in shard order."""
    out = _contiguous_on(partials[0], device)
    for p in partials[1:]:
        out = out + p.to(device)
    return out


def _ordered_sum(grads, device) -> torch.Tensor:
    out = grads[0].to(device)
    for g in grads[1:]:
        out = out + g.to(device)
    return out


class _ToPositions(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, devices):
        return tuple(x.view_as(x) if torch.device(d) == x.device else x.to(d)
                     for d in devices)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.device = inputs[0].device

    @staticmethod
    def backward(ctx, *grads):
        return _ordered_sum(grads, ctx.device), None


class _ReduceFromPositions(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(device, *partials):
        return _ordered_sum(partials, device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.devices = tuple(p.device for p in inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(grad.to(d) for d in ctx.devices)


class _GatherFromPositions(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(dim, device, *shards):
        return torch.cat([s.to(device) for s in shards], dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dim, _, *shards = inputs
        ctx.dim = dim
        ctx.parts = tuple((s.shape[dim], s.device) for s in shards)

    @staticmethod
    def backward(ctx, grad):
        out, off = [], 0
        for size, dev in ctx.parts:
            out.append(grad.narrow(ctx.dim, off, size).to(dev))
            off += size
        return (None, None) + tuple(out)


class _ScatterToPositions(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, dim, devices):
        size = x.shape[dim] // len(devices)
        return tuple(_contiguous_on(x.narrow(dim, i * size, size), d)
                     for i, d in enumerate(devices))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.device = inputs[1], inputs[0].device

    @staticmethod
    def backward(ctx, *grads):
        return torch.cat([g.to(ctx.device) for g in grads], ctx.dim), None, None


def to_positions(x: torch.Tensor, devices: Sequence[torch.device]) -> tuple:
    """``x`` on every position (forward), the positions' gradients summed
    in order back on ``x``'s device (backward)."""
    return _ToPositions.apply(x, tuple(torch.device(d) for d in devices))


def reduce_from_positions(partials: Sequence[torch.Tensor],
                          device: torch.device) -> torch.Tensor:
    """The all-reduce of ``partials`` on ``device`` (forward); the gradient
    copied to every position (backward)."""
    return _ReduceFromPositions.apply(torch.device(device), *partials)


def scatter_to_positions(x: torch.Tensor, dim: int,
                         devices: Sequence[torch.device]) -> tuple:
    """Position ``i`` gets the ``i``-th equal slice of ``x`` along ``dim``
    (forward, ``split``'s cut); the slices' gradients concatenated back on
    ``x``'s device (backward)."""
    devices = tuple(torch.device(d) for d in devices)
    if x.shape[dim] % len(devices):
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                         f"into {len(devices)} slices")
    return _ScatterToPositions.apply(x, dim, devices)


def gather_narrow(shards: Sequence[torch.Tensor], dim: int | None, device: torch.device,
                  along: int, start: int, length: int) -> torch.Tensor:
    """A weight stored as ``shards`` (``split`` along ``dim``; ``dim=None``:
    one whole copy in ``shards[0]``), all-gathered on ``device`` and
    narrowed along ``along`` to ``[start, start + length)``: the units one
    position computes where the stored split cuts through them.  Backward:
    the narrowed slice's gradient back in the shards it came from (zero in
    the rest)."""
    if dim is None:
        whole = shards[0].to(device)
    else:
        whole = gather_from_positions(shards, dim, device)
    return whole.narrow(along, start, length)


def gather_from_positions(shards: Sequence[torch.Tensor], dim: int,
                          device: torch.device) -> torch.Tensor:
    """The all-gather of ``shards`` along ``dim`` on ``device`` (forward);
    each position's slice of the gradient (backward)."""
    return _GatherFromPositions.apply(dim, torch.device(device), *shards)
