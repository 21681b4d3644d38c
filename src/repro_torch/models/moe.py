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


def moe_glu(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            group_size: int = 512, capacity_factor: float = 1.25,
            activation: str = "silu", onehot: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with GLU experts: ``x (b, s, d)``, ``router_w
    (d, E)``, ``w_gate``/``w_up (E, d, f)``, ``w_down (E, f, d)`` ->
    ``(y (b, s, d), aux)``, ``aux`` the fp32 load-balance term averaged
    over the groups.  ``b * s`` must be a multiple of the group (``min(
    group_size, b * s)``).  Dispatch by index, or with ``onehot`` by the
    reference's one-hot einsums; the gate weights are cast to ``x``'s dtype
    before they weight the experts' outputs, as the reference casts its
    combine tensor.  Differentiable in ``x`` and the weights."""
    b, s, d = x.shape
    n_experts = router_w.shape[-1]
    tokens = b * s
    g = min(group_size, tokens)
    if tokens % g:
        raise ValueError(f"tokens {tokens} not divisible by the MoE group {g}")
    n = tokens // g
    capacity = moe_capacity(g, top_k, n_experts, capacity_factor)
    xg = x.reshape(n, g, d)
    logits = xg.to(torch.float32) @ router_w.to(torch.float32)       # (n, g, E)
    act = act_fn(activation)
    if onehot:
        dispatch, combine, aux = route_topk(logits, top_k, capacity)
        expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)
        h = act(torch.einsum("necd,edf->necf", expert_in, w_gate)) \
            * torch.einsum("necd,edf->necf", expert_in, w_up)
        expert_out = torch.einsum("necf,efd->necd", h, w_down)
        y = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), expert_out)
        return y.reshape(b, s, d), aux.mean()
    gates, experts, pos, keep, aux = _route(_softmax(logits), top_k, capacity)
    # each kept (group, token, slot)'s row of the (E, n, C) expert buffer;
    # a dropped one points at a spare row past it
    slots = n_experts * n * capacity
    group = torch.arange(n, device=x.device)[:, None, None]
    row = (experts * n + group) * capacity + torch.where(keep, pos, 0)
    # the buffer row's token: an empty row reads the zero row past the
    # tokens (scatters and gathers by index: no host sync)
    token = torch.arange(n * g, device=x.device).view(n, g, 1).expand(n, g, top_k)
    place = torch.where(keep, row, slots).flatten()        # (token, slot) -> row
    src = torch.full((slots + 1,), n * g, dtype=torch.long, device=x.device)
    src.scatter_(0, place, token.flatten())
    buf = _Dispatch.apply(x.reshape(n * g, d), src[:slots], place, top_k)
    buf = buf.view(n_experts, n * capacity, d)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down).view(slots, d)
    # each token's top_k outputs, weighted by its gates in x's dtype and
    # summed (fp32 accumulation, one rounding); a dropped slot reads a live
    # row with weight 0, and its place gets no gradient back
    weight = torch.where(keep, gates.to(x.dtype), 0).view(n * g, 1, top_k)
    picked = _Combine.apply(out, row.flatten(), place).view(n * g, top_k, d)
    y = torch.bmm(weight, picked)
    return y.reshape(b, s, d), aux.mean()
