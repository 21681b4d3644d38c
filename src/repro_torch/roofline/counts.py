"""Count what one call of the program does, from its aten ops and its
kernels' analytic costs (the torch counterpart of ``repro/roofline/hlo.py``).

``step_costs(fn, *args)`` runs ``fn(*args)`` under a ``TorchDispatchMode``
and returns a ``StepCosts``:

* ``flops``: the matrix products' FLOPs by ``torch.utils.flop_counter``'s
  formula registry (mm, bmm, addmm, convolution, ...; elementwise work is
  not counted), plus every hand-written kernel's analytic FLOPs;
* ``bytes``: each aten op's input and output tensor bytes -- an unfused
  proxy: what the op would move if nothing stayed in a cache or fused with
  a neighbour (views and allocations move none) -- plus each kernel's
  analytic bytes;
* ``by_op``: calls, FLOPs and bytes per aten op;
* ``kernels``: launches, FLOPs and bytes per kernel.  Each ``kernels/ops.py``
  wrapper's kernel call (``ops._charged``) is handed to ``run``, which charges the kernel by its cost
  in ``roofline/model.py`` on every device and leaves the call's own
  tensor ops uncounted: on the CPU those are the plain version's, which
  would count, for attention, the whole masked square;
* ``collective_bytes``: None -- one process on one device moves nothing
  between devices, and nothing here can count what a sharded program
  would;
* ``peak_bytes``: the most bytes of meta tensors alive at once during the
  call, the arguments' included (``start_bytes``): on meta, where nothing
  is allocated, the memory the call would hold, before the allocator's
  rounding and caching.

While the counter is active (``ops.COUNTER``) meta inputs take the
wrappers' shape-only branch, so a model built on the meta device runs a
step that computes nothing.
"""
from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.roofline import model as M

aten = torch.ops.aten
# ops that move no data: allocations and aliases
_NO_DATA = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
            aten._unsafe_view}


def _flash_fwd_cost(q, k, v, causal, window, q_offset, with_lse=False):
    b, sq, h, d = q.shape
    return M.flash_attention_cost(b, h, sq, k.shape[1], d, q.element_size())


def _flash_bwd_cost(q, k, v, out, dout, lse, causal, window, q_offset):
    b, sq, h, d = q.shape
    return M.flash_attention_bwd_cost(b, h, k.shape[2], sq, k.shape[1], d, q.element_size(),
                                      causal, window, q_offset)


def _ssd_cost(x, dt, A, B, C):
    return M.ssd_chunk_cost(*x.shape, B.shape[-1], x.element_size())


def _ssd_bwd_cost(x, dt, A, B, C, *grads):
    return M.ssd_chunk_bwd_cost(*x.shape, B.shape[-1])


# each wrapper's cost from the arguments it hands to ``run``
KERNEL_COSTS = {
    "fedavg_agg": lambda d, w: M.fedavg_agg_cost(*d.shape, d.element_size(), d.element_size()),
    "kld_greedy_picks": lambda counts, gamma: M.greedy_cost(*counts.shape),
    "kld_score": lambda med, cand: M.score_cost(1, *cand.shape),
    "kld_score_matrix": lambda meds, cand: M.score_cost(meds.shape[0], *cand.shape),
    "affine_warp": lambda img, mats, trans: M.affine_warp_cost(*img.shape, img.element_size()),
    "flash_attention": _flash_fwd_cost,
    "flash_attention_bwd": _flash_bwd_cost,
    "ssd_chunk": _ssd_cost,
    "ssd_chunk_bwd": _ssd_bwd_cost,
}


@dataclass
class StepCosts:
    flops: float = 0.0
    bytes: float = 0.0
    by_op: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    collective_bytes: float | None = None
    peak_bytes: int = 0
    start_bytes: int = 0
    result: Any = None

    @property
    def launches(self) -> dict[str, int]:
        """Kernel calls by name."""
        return {k: v["launches"] for k, v in self.kernels.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``step_costs``; ``ops.COUNTER`` while
    active."""

    def __init__(self, costs: StepCosts):
        super().__init__()
        self.costs = costs
        self.by_op = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.kernels = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.depth = 0                      # inside a kernel wrapper's call
        self.live: dict[int, tuple] = {}    # id(storage) -> (weakref, bytes)
        self.live_bytes = 0

    # ---- live meta bytes ------------------------------------------------
    def track(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            nbytes = st.nbytes()
            self.live[key] = (weakref.ref(st, lambda _, key=key: self._freed(key)), nbytes)
            self.live_bytes += nbytes
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.live_bytes)

    def _freed(self, key: int) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    # ---- counting --------------------------------------------------------
    def run(self, name: str, fn, *args, **kwargs):
        """One kernel wrapper's call: ``fn(*args, **kwargs)`` with its tensor
        ops uncounted, the kernel charged by its analytic cost."""
        cost = KERNEL_COSTS[name](*args, **kwargs)
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        row = self.kernels[name]
        row[0] += 1
        row[1] += cost.flops
        row[2] += cost.bytes_accessed
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = tree_flatten(out)[0]
        self.track(outs)
        if self.depth == 0:
            packet = func._overloadpacket
            flops = 0.0
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            nbytes = 0
            if not (func.is_view or packet in _NO_DATA):
                ins = tree_flatten((args, kwargs))[0]
                nbytes = sum(_nbytes(t) for t in ins + outs if isinstance(t, torch.Tensor))
            row = self.by_op[str(packet)]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out


def step_costs(fn, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` under the counter (``ops.COUNTER``: meta
    inputs take the wrappers' shape-only branch) and return its ``StepCosts``, ``fn``'s return value in ``result``.
    Tensors in ``args`` / ``kwargs`` count as alive from the start."""
    if ops.COUNTER is not None:
        raise RuntimeError("step_costs does not nest")
    costs = StepCosts()
    mode = _Counter(costs)
    mode.track(tree_flatten((args, kwargs))[0])
    costs.start_bytes = mode.live_bytes
    ops.COUNTER = mode
    try:
        with mode:
            costs.result = fn(*args, **kwargs)
    finally:
        ops.COUNTER = None
    costs.by_op = {k: {"calls": c, "flops": f, "bytes": b}
                   for k, (c, f, b) in sorted(mode.by_op.items())}
    costs.kernels = {k: {"launches": c, "flops": f, "bytes": b}
                     for k, (c, f, b) in sorted(mode.kernels.items())}
    costs.flops = sum(v["flops"] for v in costs.by_op.values()) \
        + sum(v["flops"] for v in costs.kernels.values())
    costs.bytes = sum(v["bytes"] for v in costs.by_op.values()) \
        + sum(v["bytes"] for v in costs.kernels.values())
    return costs
