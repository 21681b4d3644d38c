"""Mixture-of-Experts FFN of the port's model zoo (``repro/models/moe.py``).

Token-choice top-k routing with a per-group expert capacity, GLU experts.
Tokens are routed in groups of ``group_size``; inside a group each
expert's queue fills slot-major (every token's first choice before any
second choice), and a (token, slot) past the expert's capacity is dropped
(the residual stream carries it).  The router's math is fp32, the experts
run in the model's dtype.

The reference forms dispatch and combine as one-hot ``(g, E, C)`` tensors
and moves tokens with einsums over them.  The port dispatches by index:
each ``(expert, group, queue position)`` row of the expert buffer gathers
its token (a zero row where no token sits), the three expert products run
as batched matmuls over the experts, and each token gathers its ``top_k``
outputs and adds them with its gate weights; no step waits on the host.  The same values, without the
``(n, g, k, E, C)`` one-hot (1.3 GB a layer at granite-moe-3b-a800m's
4 x 2,048 prefill).  ``moe_glu(..., onehot=True)`` is the reference's
formulation, which the tests hold the index form to.

``moe_glu_sharded`` runs the index form with its experts over the
positions of a model axis, expert-parallel (``moe_glu`` is its one
position): the router's column shards (``d x E`` fp32, small) are
gathered and the routing runs once on the whole softmax, from the same
logits as one position's, so the top-k, queue positions, drops and
``aux`` are one position's bit for bit (logits from column slices are not:
a one-column slice runs another BLAS path and moves gates by an ulp), and
each position fills the buffer rows of its own experts, runs their three
products and gathers its (token, slot) outputs; over several positions
each position's weighted partial of the output is formed in fp32 and the
partials are summed in fp32 and rounded once, as the one-position ``bmm``
over the k slots rounds once.

Both gathers carry their own backward (``_Dispatch``, ``_Combine``), a
gather by the inverse index: a token's gradient is the sum of its
``top_k`` buffer rows' gradients in fp32, rounded once, and a buffer
row's gradient is the one (token, slot)'s that sits there (zero for an
empty row).  Autograd's backward of ``index_select`` would scatter-add
with atomics instead: in bf16 each of a token's up to ``top_k`` adds would
round, in no fixed order.  So the gradients are the same bits on every
run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_capacity(group_size: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Queue slots per expert in a group: ``ceil(g k cf / E)`` rounded up to
    a multiple of 4, at least 4."""
    return max(_round_up(math.ceil(group_size * top_k * capacity_factor / n_experts), 4), 4)


def _route(probs: torch.Tensor, top_k: int, capacity: int):
    """The router after its softmax, over ``probs (..., g, E)`` fp32: the
    renormalized top-k ``gates`` and their ``experts (..., g, k)``, each
    (token, slot)'s queue position ``pos`` (slot-major cumsum) and ``keep =
    pos < capacity``, and the Switch load-balance term ``aux (...)``."""
    n_experts, g = probs.shape[-1], probs.shape[-2]
    gates, experts = torch.topk(probs, top_k, dim=-1)                 # (..., g, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(experts, n_experts).to(torch.float32)         # (..., g, k, E)
    # each expert's queue in slot-major order (every token's first choice,
    # then every second choice): an exclusive running count over (k, g),
    # scanned along the last axis (whole numbers, exact in fp32)
    by_expert = onehot.movedim(-1, -3).transpose(-1, -2)             # (..., E, k, g)
    lead = by_expert.shape[:-3]
    flat = by_expert.reshape(*lead, n_experts, top_k * g)
    queue = (torch.cumsum(flat, dim=-1) - flat).reshape(by_expert.shape)
    pos = (queue.transpose(-1, -2).movedim(-3, -1) * onehot).sum(-1)  # (..., g, k)
    keep = pos < capacity
    frac_tokens = onehot[..., 0, :].mean(-2)          # top-1 assignment share
    aux = n_experts * (frac_tokens * probs.mean(-2)).sum(-1)
    return gates, experts, pos.to(torch.long), keep, aux


def _softmax(router_logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(router_logits.to(torch.float32), dim=-1)


def route_topk_from_probs(probs: torch.Tensor, top_k: int, capacity: int):
    """``route_topk`` from the router's softmax ``probs (..., g, E)``."""
    gates, experts, pos, keep, aux = _route(probs, top_k, capacity)
    onehot = F.one_hot(experts, probs.shape[-1]).to(torch.float32)   # (..., g, k, E)
    # a dropped slot's position is past the queue: its one-hot row is zero
    pos_oh = F.one_hot(torch.where(keep, pos, 0), capacity).to(torch.float32) \
        * keep[..., None]                                            # (..., g, k, C)
    disp_k = onehot[..., :, None] * pos_oh[..., None, :]             # (..., g, k, E, C)
    dispatch = disp_k.sum(-3)
    combine = (disp_k * gates[..., None, None]).sum(-3)
    return dispatch, combine, aux


def route_topk(router_logits: torch.Tensor, top_k: int, capacity: int):
    """The reference's ``route_topk`` over ``router_logits (..., g, E)``:
    ``dispatch (..., g, E, C)`` (1 where a kept (token, slot) sits),
    ``combine`` (its fp32 gate weight there) and ``aux (...)``."""
    return route_topk_from_probs(_softmax(router_logits), top_k, capacity)


class _Dispatch(torch.autograd.Function):
    """The expert buffer: row ``r`` of ``x (tokens, d)`` gathered by ``src
    (slots,)``, the index ``tokens`` reading a zero row.  Backward: a
    token's gradient is the sum of its ``top_k`` buffer rows' (``place
    (tokens * top_k,)``, ``slots`` for a dropped slot), in fp32 (or a wider
    dtype) in slot order, rounded once."""

    @staticmethod
    def forward(ctx, x, src, place, top_k):
        ctx.save_for_backward(place)
        ctx.top_k = top_k
        return torch.cat([x, x.new_zeros(1, x.shape[1])]).index_select(0, src)

    @staticmethod
    def backward(ctx, grad):
        (place,) = ctx.saved_tensors
        d = grad.shape[1]
        rows = torch.cat([grad, grad.new_zeros(1, d)]).index_select(0, place)
        acc = torch.promote_types(grad.dtype, torch.float32)
        return rows.view(-1, ctx.top_k, d).sum(1, dtype=acc).to(grad.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """Each (token, slot)'s buffer row: ``out (slots, d)`` gathered by ``row
    (tokens * top_k,)``, a dropped slot reading a live row (its gate weight
    is 0).  Backward: a buffer row's gradient is the one kept (token,
    slot)'s that sits there (``place``: each (token, slot)'s row, ``slots``
    for a dropped one), zero for an empty row; a dropped slot's gives none."""

    @staticmethod
    def forward(ctx, out, row, place):
        ctx.save_for_backward(place)
        ctx.slots = out.shape[0]
        return out.index_select(0, row)

    @staticmethod
    def backward(ctx, grad):
        (place,) = ctx.saved_tensors
        picks, d = grad.shape
        # each row's (token, slot), the zero row past them for an empty one
        # (the dropped slots all land on the spare entry, which is cut)
        pick = torch.full((ctx.slots + 1,), picks, dtype=torch.long, device=grad.device)
        pick.scatter_(0, place, torch.arange(picks, device=grad.device))
        rows = torch.cat([grad, grad.new_zeros(1, d)]).index_select(0, pick[:ctx.slots])
        return rows, None, None


def _token_rows(n: int, g: int, top_k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (group, token, slot)'s group index and flat token index."""
    group = torch.arange(n, device=device)[:, None, None]
    token = torch.arange(n * g, device=device).view(n, g, 1).expand(n, g, top_k)
    return group, token


def moe_glu(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            group_size: int = 512, capacity_factor: float = 1.25,
            activation: str = "silu", onehot: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with GLU experts: ``x (b, s, d)``, ``router_w
    (d, E)``, ``w_gate``/``w_up (E, d, f)``, ``w_down (E, f, d)`` ->
    ``(y (b, s, d), aux)``, ``aux`` the fp32 load-balance term averaged
    over the groups.  ``b * s`` must be a multiple of the group (``min(
    group_size, b * s)``).  Dispatch by index (``moe_glu_sharded`` with
    one position), or with ``onehot`` by the reference's one-hot einsums;
    the gate weights are cast to ``x``'s dtype before they weight the
    experts' outputs, as the reference casts its combine tensor.
    Differentiable in ``x`` and the weights."""
    kw = dict(top_k=top_k, group_size=group_size, capacity_factor=capacity_factor,
              activation=activation)
    if not onehot:
        return moe_glu_sharded(x, [router_w], [w_gate], [w_up], [w_down], (x.device,), **kw)
    b, s, d = x.shape
    n, g, capacity = _groups(b * s, group_size, top_k, router_w.shape[-1], capacity_factor)
    xg = x.reshape(n, g, d)
    logits = xg.to(torch.float32) @ router_w.to(torch.float32)       # (n, g, E)
    act = act_fn(activation)
    dispatch, combine, aux = route_topk(logits, top_k, capacity)
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)
    h = act(torch.einsum("necd,edf->necf", expert_in, w_gate)) \
        * torch.einsum("necd,edf->necf", expert_in, w_up)
    expert_out = torch.einsum("necf,efd->necd", h, w_down)
    y = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), expert_out)
    return y.reshape(b, s, d), aux.mean()


def _groups(tokens: int, group_size: int, top_k: int, n_experts: int,
            capacity_factor: float) -> tuple[int, int, int]:
    """``(groups, group, capacity)`` for ``tokens`` routed in groups."""
    g = min(group_size, tokens)
    if tokens % g:
        raise ValueError(f"tokens {tokens} not divisible by the MoE group {g}")
    return tokens // g, g, moe_capacity(g, top_k, n_experts, capacity_factor)


def routes(x32: torch.Tensor, routers, *, top_k: int, capacity: int, n: int, g: int):
    """The routing of ``x32 (n * g, d)`` fp32: the router's column shards
    ``routers[j] (d, E/t)`` gathered on ``x32``'s device (their gradient
    back to the shards), the fp32 logits and ``_route`` on their softmax,
    as one position computes them.  Returns ``_route``'s ``(gates,
    experts, pos, keep, aux)``."""
    from repro_torch.launch import model_axis
    router = model_axis.gather_from_positions([r.to(torch.float32) for r in routers], -1,
                                              x32.device)
    return _route(_softmax(x32.view(n, g, -1) @ router), top_k, capacity)


def moe_glu_sharded(x: torch.Tensor, routers, w_gates, w_ups, w_downs, devices, *,
                    top_k: int, group_size: int = 512, capacity_factor: float = 1.25,
                    activation: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """The index-dispatched MoE with its experts over ``t = len(devices)``
    positions: ``routers[j] (d, E/t)``, ``w_gates[j]``/``w_ups[j] (E/t, d,
    f)`` and ``w_downs[j] (E/t, f, d)`` position ``j``'s shards of experts
    ``[j E/t, (j + 1) E/t)`` on ``devices[j]``; ``x`` and the result on
    one device.  ``moe_glu`` is ``t = 1``.  The routes are one position's
    (``routes``); each position fills its experts' buffer rows, runs their
    three products and gathers its (token, slot) outputs, weighted by their
    gates in ``x``'s dtype.  Over several positions the token copies and
    the weighted partials are fp32, the partials all-reduced in order and
    rounded once to ``x``'s dtype (as one position's ``bmm`` over the k
    slots rounds once).  Differentiable in ``x`` and every shard."""
    from repro_torch.launch import model_axis
    b, s, d = x.shape
    t = len(devices)
    n_local = w_gates[0].shape[0]
    n, g, capacity = _groups(b * s, group_size, top_k, n_local * t, capacity_factor)
    flat = x.reshape(n * g, d)
    x32 = flat.to(torch.float32)
    gates, experts, pos, keep, aux = routes(x32, routers, top_k=top_k, capacity=capacity,
                                            n=n, g=g)
    # over several positions the token copies are fp32, so a token's
    # gradient is summed over the positions and the router in fp32 and
    # rounded once
    acc = x.dtype if t == 1 else torch.float32
    xs = model_axis.to_positions(flat if t == 1 else x32, devices)
    act = act_fn(activation)
    slots = n_local * n * capacity
    partials = []
    for j, dev in enumerate(devices):
        e0 = j * n_local
        ex, ps, kp = experts.to(dev), pos.to(dev), keep.to(dev)
        mine = kp & (ex >= e0) & (ex < e0 + n_local)
        group, token = _token_rows(n, g, top_k, dev)
        # each of this position's kept (group, token, slot)s' row of its
        # (E/t, n, C) expert buffer; another position's or a dropped one
        # points at a spare row past them
        row = ((ex - e0).clamp(0, n_local - 1) * n + group) * capacity + torch.where(mine, ps, 0)
        place = torch.where(mine, row, slots).flatten()        # (token, slot) -> row
        # the buffer row's token: an empty row reads the zero row past the
        # tokens (scatters and gathers by index: no host sync)
        src = torch.full((slots + 1,), n * g, dtype=torch.long, device=dev)
        src.scatter_(0, place, token.flatten())
        buf = _Dispatch.apply(xs[j], src[:slots], place, top_k).to(x.dtype)
        buf = buf.view(n_local, n * capacity, d)
        h = act(torch.bmm(buf, w_gates[j])) * torch.bmm(buf, w_ups[j])
        out = torch.bmm(h, w_downs[j]).view(slots, d)
        # each token's top_k outputs, weighted by its gates and summed
        # (fp32 accumulation, one rounding); a slot not kept here reads a
        # live row with weight 0, and its place gets no gradient back
        weight = torch.where(mine, gates.to(dev).to(x.dtype), 0).view(n * g, 1, top_k)
        picked = _Combine.apply(out, row.flatten(), place).view(n * g, top_k, d)
        partials.append(torch.bmm(weight.to(acc), picked.to(acc)))
    y = model_axis.reduce_from_positions(partials, x.device).to(x.dtype)
    return y.reshape(b, s, d), aux.mean()
