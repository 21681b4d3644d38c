"""Public wrappers around the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then

* for CPU tensors, returns the plain PyTorch version (``kernels/ref.py``);
* for CUDA tensors, launches its kernel on the current stream and adds one
  to ``LAUNCHES[name]`` -- or raises.  Nothing routes a CUDA tensor around
  its kernel;
* for meta tensors while a step-cost counter is active (``COUNTER``, set
  by ``roofline.counts.step_costs``, which the dry run runs under), makes
  the card's checks and returns empty meta outputs of the kernel's
  shapes, computing nothing.  Without a counter a meta input raises, as
  any other device does.

With a counter active every kernel call (``_charged``), on any device,
goes through ``COUNTER.run``, which charges the kernel's analytic cost and
leaves the call's own tensor ops (a plain version's, an output's
allocation) uncounted.  Without one that costs a ``None`` check.

The kernel library is built on the first CUDA call (``kernels/build.py``).
"""
from __future__ import annotations

import functools
import math
import threading

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset, per kernel (main-path evidence)
LAUNCHES: dict[str, int] = {"fedavg_agg": 0, "kld_greedy_picks": 0,
                            "kld_score": 0, "kld_score_matrix": 0,
                            "affine_warp": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "ssd_chunk": 0,
                            "ssd_chunk_bwd": 0}

# mediators the matrix grid's y axis holds (65,535 tiles of 8; a call
# tiles by 4 only at a few thousand pairs, see kld_score_matrix_plan)
SCORE_MAX_M = 524_280

# (device index, K, C) -> floats of global scratch the greedy pass's plan
# needs: 0 where every CTA's per-candidate state and mediator fit in its
# shared memory
_GREEDY_SCRATCH: dict[tuple[int, int, int], int] = {}

# head dims the flash kernel is instantiated for (Hymba 64, danube 80,
# qwen3 128, gemma 256); the plain version takes any
FLASH_HEAD_DIMS = (64, 80, 128, 256)
# mediator rows Eq. 6 takes (its CTAs keep the normalized weights in 48 KB
# of shared memory)
FEDAVG_MAX_M = 12_288
# a block's dynamic shared memory on Hopper (the SSD block keeps B, C, x,
# the (L, L) decay matrix beside W, and (L,) vectors there, fp32)
MAX_SMEM_BYTES = 232_448


# the step-cost counter of the running ``roofline.counts.step_costs``, or
# None; while it is set, meta inputs take the wrappers' shape-only branch
COUNTER = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _charged(name: str):
    """Hand each call of the decorated kernel call to the active step-cost
    counter (``COUNTER.run``), which charges ``name``'s analytic cost."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if COUNTER is None:
                return fn(*args, **kwargs)
            return COUNTER.run(name, fn, *args, **kwargs)
        return call
    return wrap


def _route(*tensors: torch.Tensor) -> str:
    """``"cpu"``, ``"cuda"``, or ``"meta"`` for meta inputs while a
    step-cost counter is active; raises on anything else or on a mix of devices.  A
    card's (and a meta) input must be contiguous."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda" and not (dev.type == "meta" and COUNTER is not None):
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")
    return dev.type


# the device each host thread's launches last bound (``_launch``)
_BOUND = threading.local()


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call ``entry`` on ``device``'s current stream.  The raw stream and
    device queries skip ``torch.cuda``'s Python layer (host cost per call);
    the device context is entered only when ``device`` is not current.  A
    thread's first launch on a device binds its primary context there
    (``repro_bind_device``): autograd runs a backward on a thread of its
    own, where nothing may have made it current yet."""
    lib = build.library()
    fn = getattr(lib, entry)
    index = device.index
    if getattr(_BOUND, "device", None) != index:
        build.check(lib.repro_bind_device(index), "repro_bind_device")
        _BOUND.device = index
    if index == torch._C._cuda_getDevice():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    build.check(code, entry)
    LAUNCHES[name] += 1


def fedavg_agg(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6: ``deltas (M, N)`` f32 or bf16, raw ``weights (M,)`` ->
    ``(N,)`` in ``deltas``' dtype, fp32 accumulate.  The weights are
    normalized (``w / max(sum w, 1e-12)``) inside the one launch, so
    zero-weight rows are exact no-ops; on the card they must be float32."""
    if deltas.dim() != 2 or weights.shape != (deltas.shape[0],):
        raise ValueError(f"expected deltas (M, N) and weights (M,), got "
                         f"{tuple(deltas.shape)} and {tuple(weights.shape)}")
    if deltas.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deltas must be float32 or bfloat16, got {deltas.dtype}")
    return _fedavg_agg(deltas, weights)


@_charged("fedavg_agg")
def _fedavg_agg(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    where = _route(deltas, weights)
    if where == "cpu":
        return ref.fedavg_agg(deltas, weights)
    m, n = deltas.shape
    if weights.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 weights, got {weights.dtype}")
    if not 1 <= m <= FEDAVG_MAX_M:
        raise ValueError(f"the kernel takes 1 <= M <= {FEDAVG_MAX_M} rows, got M={m}")
    out = deltas.new_empty(n)
    if where == "meta":
        return out
    entry = "fedavg_agg_f32" if deltas.dtype == torch.float32 else "fedavg_agg_bf16"
    _launch("fedavg_agg", entry, deltas.device, deltas.data_ptr(),
            weights.data_ptr(), out.data_ptr(), m, n)
    return out


def fedavg_agg_tree(deltas: dict[str, torch.Tensor],
                    weights: torch.Tensor) -> dict[str, torch.Tensor]:
    """Eq. 6 over a dict of stacked ``(M, ...)`` leaves: each dtype group is
    flattened into one ``(M, total)`` buffer and aggregated by one call.
    Columns are reduced independently, so the result equals one call per
    leaf bit for bit."""
    if not deltas:
        return {}
    m = next(iter(deltas.values())).shape[0]
    groups: dict[torch.dtype, list[str]] = {}
    for name, leaf in deltas.items():
        groups.setdefault(leaf.dtype, []).append(name)
    out: dict[str, torch.Tensor] = {}
    for names in groups.values():
        flat = torch.cat([deltas[k].reshape(m, -1) for k in names], dim=1)
        agg = fedavg_agg(flat, weights)
        start = 0
        for k in names:
            shape = deltas[k].shape[1:]
            size = deltas[k][0].numel()
            out[k] = agg[start:start + size].reshape(shape)
            start += size
    return {k: out[k] for k in deltas}


class FlatLayout:
    """Where each leaf of a float32 parameter dict lies in one flat buffer
    of ``total`` columns: leaf ``names[i]`` of shape ``shapes[i]`` at
    columns ``[offsets[i], offsets[i] + numel)``, in the dict's order (the
    order ``fedavg_agg_tree`` concatenates in).  A leaf named in ``perms``
    is stored permuted -- its columns hold ``leaf.permute(perms[name])``,
    row-major -- and viewed back in its own shape."""

    def __init__(self, params: dict[str, torch.Tensor],
                 perms: dict[str, tuple] | None = None):
        for k, v in params.items():
            if v.dtype != torch.float32:
                raise ValueError(f"leaf {k!r} is {v.dtype}; the flat buffer is float32")
        self.names = tuple(params)
        self.shapes = tuple(tuple(v.shape) for v in params.values())
        self.perms = {k: tuple(p) for k, p in (perms or {}).items()}
        sizes = [math.prod(s) for s in self.shapes]
        self.offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
        self.total = sum(sizes)

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """The leaves as views of ``flat (..., total)``: ``(..., *shape)``."""
        lead = flat.shape[:-1]
        out = {}
        for k, s, o in zip(self.names, self.shapes, self.offsets):
            chunk = flat[..., o:o + math.prod(s)]
            perm = self.perms.get(k)
            if perm is None:
                out[k] = chunk.view(*lead, *s)
            else:
                back = [perm.index(i) for i in range(len(perm))]
                nl = len(lead)
                out[k] = chunk.view(*lead, *(s[p] for p in perm)).permute(
                    *range(nl), *(nl + b for b in back))
        return out


def fedavg_agg_flat(rows: torch.Tensor, weights: torch.Tensor,
                    layout: FlatLayout) -> dict[str, torch.Tensor]:
    """Eq. 6 straight from one ``(M, layout.total)`` float32 buffer whose
    row ``m`` holds mediator ``m``'s leaves at ``layout``'s columns: one
    ``fedavg_agg`` call, the leaves returned as views of its ``(total,)``
    result.  Equal bit for bit to ``fedavg_agg_tree`` over the same leaves
    stacked (the same columns, reduced independently).  An empty layout (a
    rank-0 LoRA adapter state) has nothing to average: no launch, ``{}``."""
    if rows.dim() != 2 or rows.shape[1] != layout.total:
        raise ValueError(f"expected rows (M, {layout.total}), got {tuple(rows.shape)}")
    if layout.total == 0:
        return layout.views(rows.new_zeros(0))
    return layout.views(fedavg_agg(rows, weights))


def kld_greedy_picks(client_counts: torch.Tensor, gamma: int) -> torch.Tensor:
    """The whole Alg. 3 pass: ``(K, C)`` float32 histograms -> ``(K,)``
    int32 absorption order (mediator ``i`` holds picks ``[i*gamma,
    (i+1)*gamma)``)."""
    if client_counts.dim() != 2 or client_counts.dtype != torch.float32:
        raise ValueError("client_counts must be a (K, C) float32 tensor")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    return _kld_greedy_picks(client_counts, gamma)


@_charged("kld_greedy_picks")
def _kld_greedy_picks(client_counts: torch.Tensor, gamma: int) -> torch.Tensor:
    where = _route(client_counts)
    if where == "cpu":
        return ref.kld_greedy_picks(client_counts, gamma)
    k, c = client_counts.shape
    if c < 1:
        raise ValueError("client_counts must have at least one class")
    dev = client_counts.device
    picks = torch.empty(k, dtype=torch.int32, device=dev)
    if k == 0 or where == "meta":
        return picks
    key = (dev.index, k, c)
    floats = _GREEDY_SCRATCH.get(key)
    if floats is None:
        floats = _GREEDY_SCRATCH[key] = kld_greedy_plan(k, c, dev)["scratch_floats"]
    # each CTA's per-candidate state and mediator where they do not fit in
    # its shared memory (the kernel initializes what it uses); else none
    scratch = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
    _launch("kld_greedy_picks", "kld_greedy_picks", dev, client_counts.data_ptr(),
            picks.data_ptr(), None if scratch is None else scratch.data_ptr(), k, c,
            int(gamma))
    return picks


def kld_greedy_plan(k: int, c: int, device: torch.device | None = None) -> dict:
    """The cluster launch a ``(k, c)`` greedy pass gets on ``device``: CTAs
    in the cluster, threads per CTA, lanes per candidate, candidate rows
    each CTA keeps in shared memory, its dynamic shared memory in bytes,
    whether the per-candidate state and the open mediator live in shared
    memory (1) or in a global scratch (0), and that scratch's floats (0
    when everything fits).  No launch."""
    import ctypes
    out = [ctypes.c_int() for _ in range(7)] + [ctypes.c_int64()]
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        build.check(build.library().kld_greedy_plan(k, c, *map(ctypes.byref, out)),
                    "kld_greedy_plan")
    return dict(zip(("ctas", "threads", "lanes", "rows_in_smem", "smem_bytes",
                     "state_in_smem", "med_in_smem", "scratch_floats"),
                    (v.value for v in out)))


def _score_inputs(meds: torch.Tensor, cand: torch.Tensor, med_dim: int) -> None:
    if meds.dim() != med_dim or cand.dim() != 2 or meds.shape[-1] != cand.shape[1]:
        lead = "(C,)" if med_dim == 1 else "(M, C)"
        raise ValueError(f"expected mediator counts {lead} and candidates (K, C), "
                         f"got {tuple(meds.shape)} and {tuple(cand.shape)}")
    if meds.dtype != torch.float32 or cand.dtype != torch.float32:
        raise ValueError(f"counts must be float32, got {meds.dtype} and {cand.dtype}")


def kld_score(mediator_counts: torch.Tensor,
              client_counts: torch.Tensor) -> torch.Tensor:
    """Alg. 3 scores of one open mediator: ``(C,)`` and ``(K, C)`` float32
    -> ``(K,)`` float32, ``D_KL(normalize(med + c_k) || U)``, any K and
    C.  The kernel scores with the greedy pass's device function, so its
    bits equal that pass's scores."""
    _score_inputs(mediator_counts, client_counts, 1)
    return _kld_score(mediator_counts, client_counts)


@_charged("kld_score")
def _kld_score(mediator_counts: torch.Tensor, client_counts: torch.Tensor) -> torch.Tensor:
    where = _route(mediator_counts, client_counts)
    if where == "cpu":
        return ref.kld_score(mediator_counts, client_counts)
    k, c = client_counts.shape
    out = torch.empty(k, dtype=torch.float32, device=client_counts.device)
    if k == 0 or where == "meta":
        return out
    _launch("kld_score", "kld_score_f32", client_counts.device,
            mediator_counts.data_ptr(), client_counts.data_ptr(), out.data_ptr(),
            k, c)
    return out


def kld_score_plan(k: int, c: int) -> dict:
    """The launch a ``(k, c)`` ``kld_score`` call makes: lanes per
    candidate row, classes each lane holds in registers (0: the row is
    streamed twice), threads per CTA, CTAs, and whether the mediator is
    staged in shared memory.  No launch."""
    import ctypes
    out = [ctypes.c_int() for _ in range(5)]
    build.check(build.library().kld_score_plan(k, c, *map(ctypes.byref, out)),
                "kld_score_plan")
    return dict(zip(("lanes", "rounds", "threads", "ctas", "med_in_smem"),
                    (v.value for v in out)))


def kld_score_matrix(mediator_counts: torch.Tensor,
                     client_counts: torch.Tensor) -> torch.Tensor:
    """Alg. 3 scores of every (mediator, candidate) pair: ``(M, C)`` and
    ``(K, C)`` float32 -> ``(M, K)`` float32 in one launch, any C.  The
    kernel scores with ``kld_score``'s device function, so row ``i`` equals
    ``kld_score(mediator_counts[i], client_counts)`` bit for bit."""
    _score_inputs(mediator_counts, client_counts, 2)
    return _kld_score_matrix(mediator_counts, client_counts)


@_charged("kld_score_matrix")
def _kld_score_matrix(mediator_counts: torch.Tensor,
                      client_counts: torch.Tensor) -> torch.Tensor:
    where = _route(mediator_counts, client_counts)
    if where == "cpu":
        return ref.kld_score_matrix(mediator_counts, client_counts)
    m, c = mediator_counts.shape
    k = client_counts.shape[0]
    if m > SCORE_MAX_M:
        raise ValueError(f"the scoring kernel takes M <= {SCORE_MAX_M}, got M={m}")
    out = torch.empty(m, k, dtype=torch.float32, device=client_counts.device)
    if m == 0 or k == 0 or where == "meta":
        return out
    _launch("kld_score_matrix", "kld_score_matrix_f32", client_counts.device,
            mediator_counts.data_ptr(), client_counts.data_ptr(), out.data_ptr(),
            m, k, c)
    return out


def kld_score_matrix_plan(m: int, k: int, c: int,
                          mediator_counts: torch.Tensor | None = None,
                          client_counts: torch.Tensor | None = None) -> dict:
    """The launch an ``(m, k, c)`` ``kld_score_matrix`` call makes on the
    tensors' card (the current one without them): lanes per (mediator,
    candidate) pair (from C and from the pairs against the card's SM
    count), classes each lane holds in registers (always 0: every group
    streams its rows), the tile of mediators x candidates a CTA scores,
    threads per CTA, CTAs, whether the tiles are staged in shared memory
    by bulk copies (1) or read from global memory (0: the direct path, for
    tiles past 96 KB or a base pointer that is not 16-byte aligned;
    without the tensors the pointers count as aligned), and the staged
    bytes.  No launch."""
    import ctypes
    ptrs = [None if t is None else t.data_ptr() for t in (mediator_counts, client_counts)]
    out = [ctypes.c_int() for _ in range(4)] + [ctypes.c_int64()] \
        + [ctypes.c_int() for _ in range(2)]
    index = torch.cuda.current_device() if client_counts is None else client_counts.device.index
    with torch.cuda.device(index):
        code = build.library().kld_score_matrix_plan(m, k, c, *ptrs, *map(ctypes.byref, out))
    build.check(code, "kld_score_matrix_plan")
    plan = dict(zip(("lanes", "tile_m", "tile_k", "threads", "ctas", "tiles_in_smem",
                     "smem_bytes"), (v.value for v in out)))
    return {"lanes": plan.pop("lanes"), "rounds": 0, **plan}


def affine_warp(images: torch.Tensor, mats: torch.Tensor,
                trans: torch.Tensor) -> torch.Tensor:
    """Bilinear inverse-affine warp: ``images (B, H, W, C)`` float32,
    ``mats (B, 2, 2)``, ``trans (B, 2)`` -> ``(B, H, W, C)``."""
    if images.dim() != 4:
        raise ValueError(f"images must be (B, H, W, C), got {tuple(images.shape)}")
    b, h, w, c = images.shape
    if mats.shape != (b, 2, 2) or trans.shape != (b, 2):
        raise ValueError(f"expected mats ({b}, 2, 2) and trans ({b}, 2), got "
                         f"{tuple(mats.shape)} and {tuple(trans.shape)}")
    if not all(t.dtype == torch.float32 for t in (images, mats, trans)):
        raise ValueError("affine_warp takes float32 images, mats and trans")
    return _affine_warp(images, mats, trans)


@_charged("affine_warp")
def _affine_warp(images: torch.Tensor, mats: torch.Tensor,
                 trans: torch.Tensor) -> torch.Tensor:
    where = _route(images, mats, trans)
    if where == "cpu":
        return ref.affine_warp(images, mats, trans)
    b, h, w, c = images.shape
    if h * w * c >= 2 ** 31:
        raise ValueError(f"the kernel indexes an image with int32, got {h}x{w}x{c}")
    out = torch.empty_like(images)
    if out.numel() == 0 or where == "meta":
        return out
    _launch("affine_warp", "affine_warp_f32", images.device, images.data_ptr(),
            mats.data_ptr(), trans.data_ptr(), out.data_ptr(), b, h, w, c)
    return out


def affine_warp_stages(images: torch.Tensor, out: torch.Tensor) -> int:
    """The path an ``affine_warp`` call on ``images`` into ``out`` takes:
    the staged path's input stages (2: whole images staged in
    shared memory by bulk copies), or 0 for the direct path (images too
    large for shared memory, or not 16-byte aligned).  No launch."""
    _, h, w, c = images.shape
    return build.library().affine_warp_stages(images.data_ptr(), out.data_ptr(), h, w, c)


def _flash_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, sq, H, d) and k, v (b, skv, KV, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, kv, dk = k.shape
    if k.shape[0] != b or dk != d or kv < 1 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_head_dim(d: int) -> None:
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported on the card; the kernel takes "
                         f"{FLASH_HEAD_DIMS}")


@_charged("flash_attention")
def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   window: int | None, q_offset: int, with_lse: bool = False):
    """The forward launch; with ``with_lse`` also each row's log-sum-exp
    ``(b, H, sq)`` fp32 for the backward (None on the CPU, whose backward
    recomputes the softmax), returned as ``(out, lse)``."""
    where = _route(q, k, v)
    if where == "cpu":
        out = ref.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        return (out, None) if with_lse else out
    b, sq, h, d = q.shape
    _check_head_dim(d)
    if where == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel loads q, k and v by TMA: they must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device) if with_lse else None
    if where == "meta":
        return (out, lse) if with_lse else out
    entry = "flash_attention_f32" if q.dtype == torch.float32 else "flash_attention_bf16"
    _launch("flash_attention", entry, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq,
            k.shape[1], h, k.shape[2], d, int(causal), 0 if window is None else int(window),
            int(q_offset), 1.0 / math.sqrt(d))
    return (out, lse) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel, asked for each
    row's log-sum-exp, and the backward kernel
    (``csrc/flash_attention_bwd.cu``) on the card or
    ``ref.flash_attention_bwd`` on the CPU, from the saved ``q, k, v``, the
    forward's output and its log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _flash_forward(q, k, v, causal, window, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), causal=causal,
                                         window=window, q_offset=q_offset, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention in the model layout: ``q (b, sq, H, d)``, ``k, v
    (b, skv, KV, d)``, ``H % KV == 0``; query head ``h`` reads KV head
    ``h // (H/KV)``.  f32 or bf16, one dtype; fp32 softmax statistics and
    accumulator; returns ``(b, sq, H, d)`` in ``q``'s dtype.  ``window``
    keeps keys with ``qpos - window < kpos``; ``q_offset`` is the absolute
    position of ``q[:, 0]`` against ``k[:, 0]``.  Any head dim on the CPU;
    on the card the head dims of ``FLASH_HEAD_DIMS`` and 16-byte aligned
    inputs, others raise.  Differentiable when an input requires grad
    (``_FlashAttention``: one forward and one backward launch a call)."""
    _flash_args(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _flash_forward(q, k, v, causal, window, q_offset)


# a dK/dV CTA's fixed cost beside its (head, query tile) steps, in steps:
# loading K and V and writing dK and dV (fitted to the split sweeps of
# ``examples/kernel_times.py --only flash_attention_bwd`` on an H100; an
# fp32 step is longer against that cost, on the CUDA cores)
FLASH_BWD_CTA_STEPS = {torch.bfloat16: 2, torch.float32: 1}


def flash_bwd_keys(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Keys per dK/dV CTA of the backward kernel.  bf16: 128 (two
    warpgroups of 64) below head dim 256, 64 at 256 (its warpgroups split
    columns).  fp32: 64, but 32 at head dim 256 (K, V and the query ring
    fill the shared memory) and at 64 (the reduced configs' small layer
    needs CTAs more than large tiles)."""
    if dtype == torch.float32:
        return 32 if d in (64, 256) else 64
    return 64 if d == 256 else 128


def flash_bwd_rows(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Query rows per (Q, dO) tile a dK/dV CTA streams: 64, but in fp32
    as many as its keys (``flash_bwd_keys``)."""
    return flash_bwd_keys(d, dtype) if dtype == torch.float32 else 64


@functools.lru_cache(maxsize=4096)
def flash_bwd_split(b: int, sq: int, skv: int, kv: int, rep: int, n_sm: int, *, d: int,
                    dtype: torch.dtype = torch.bfloat16, causal: bool = True,
                    window: int | None = None, q_offset: int = 0) -> int:
    """How many CTAs share a KV head's ``rep`` query heads in the
    backward's dK/dV pass at head dim ``d`` in ``dtype`` (a divisor of
    ``rep``).  Its CTAs hold ``flash_bwd_keys`` keys and stream
    ``flash_bwd_rows``-row query tiles; a CTA of split ``s`` walks ``rep /
    s`` heads times the query tiles its keys see under the masks, plus
    ``FLASH_BWD_CTA_STEPS[dtype]``; its CTAs run heaviest first on ``n_sm``
    SMs, so the pass takes about the larger of the heaviest CTA and the mean
    load of an SM.  The least split that minimizes that is taken: each split
    past the first writes fp32 partial dK, dV that a second pass sums in
    split order."""
    keys, rows = flash_bwd_keys(d, dtype), flash_bwd_rows(d, dtype)
    tiles = []                              # query tiles each CTA's keys see
    for j0 in range(0, skv, keys):
        lo = max(0, j0 - q_offset) if causal else 0
        hi = min(sq, min(j0 + keys, skv) - 1 + window - q_offset) if window else sq
        tiles.append(-(-(hi - lo // rows * rows) // rows) if hi > lo else 0)
    best, best_cost = 1, math.inf
    for s in (s for s in range(1, rep + 1) if rep % s == 0):
        steps = [rep // s * n + FLASH_BWD_CTA_STEPS[dtype] for n in tiles]
        cost = max(max(steps), b * kv * s * sum(steps) / n_sm)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        lse: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention(q, k, v)`` at its output ``out``
    for the output gradient ``dout``: ``dq, dk, dv`` in the inputs' dtype,
    fp32 accumulation, each KV head's gradient summed over its query heads
    in a fixed order (no atomics: two runs agree bit for bit).

    ``lse``: the forward's ``(b, H, sq)`` fp32 log-sum-exp of each row
    (``ref.flash_attention_lse``; the autograd path passes it); without it
    the forward kernel runs first to write it (one ``flash_attention``
    launch, its output discarded).  The CPU's plain version recomputes the
    softmax and does not read it.  One backward launch: on the card it
    runs dQ (which writes each row's D), dK/dV over ``flash_bwd_split``'s
    head split and, at a split past 1, the partials' sum, on the tensor
    cores in bf16 and on the CUDA cores in fp32
    (``csrc/flash_attention_bwd.cu``).  Head dims as ``flash_attention``;
    q, k, v, out and dout 16-byte aligned."""
    _flash_args(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype} and {tuple(dout.shape)} "
                         f"{dout.dtype}")
    b, sq, h, _ = q.shape
    if lse is not None and (lse.shape != (b, h, sq) or lse.dtype != torch.float32):
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    return _flash_bwd(q, k, v, out, dout, lse, causal, window, q_offset)


@_charged("flash_attention_bwd")
def _flash_bwd(q, k, v, out, dout, lse, causal, window, q_offset):
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tensors = (q, k, v, out, dout) + (() if lse is None else (lse,))
    where = _route(*tensors)
    if where == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, dout, **kw)
    _check_head_dim(q.shape[3])
    if where == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("the kernel loads q, k, v and dout by TMA and out by 16-byte "
                         "loads: they must be 16-byte aligned")
    if lse is None:
        _, lse = _flash_forward(q, k, v, causal, window, q_offset, with_lse=True)
    if where == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _flash_bwd_launch(q, k, v, out, dout, lse, None, **kw)


def _flash_bwd_launch(q, k, v, out, dout, lse, split: int | None, *, causal: bool,
                      window: int | None, q_offset: int):
    """The backward launch on checked card tensors and the forward's lse.
    ``split``: CTAs per KV head's query heads in the dK/dV pass (bf16 and
    fp32), a divisor of ``H / KV`` (None: ``flash_bwd_split``'s choice for
    the dtype's tiles; the split sweep of ``examples/kernel_times.py`` and
    the card tests set it)."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    rep = h // kv
    if split is not None and (split < 1 or rep % split):
        raise ValueError(f"split must divide H / KV = {rep}, got {split}")
    dev = q.device
    if split is None:
        split = flash_bwd_split(b, sq, skv, kv, rep, _sm_count(dev.index), d=d,
                                dtype=q.dtype, causal=causal, window=window,
                                q_offset=q_offset)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty(b * h * sq, dtype=torch.float32, device=dev)
    part = torch.empty(2 * split * b * skv * kv * d, dtype=torch.float32, device=dev) \
        if split > 1 else None
    entry = "flash_attention_bwd_f32" if q.dtype == torch.float32 \
        else "flash_attention_bwd_bf16"
    _launch("flash_attention_bwd", entry, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), None if part is None else part.data_ptr(), b,
            sq, skv, h, kv, d, int(causal), 0 if window is None else int(window),
            int(q_offset), split, 1.0 / math.sqrt(d))
    return dq, dk, dv


def ssd_chunk_smem_bytes(L: int, p: int, n: int) -> int:
    """Dynamic shared memory of one SSD CTA in the kernel's least layout
    (``csrc/ssd_chunk.cu`` ``make_layout`` with one fp32 x stage and C B^T
    recomputed per head; L and n rounded up to 8, p to 4): B, C transposed,
    the (L, L + n) block of the decay matrix and W, x, cum and dt.  A shape
    runs when it fits; ``ssd_chunk_plan`` gives the layout a call takes."""
    lp, np8, pp = -(-L // 8) * 8, -(-n // 8) * 8, -(-p // 4) * 4
    return 4 * (3 * lp * np8 + lp * lp + lp * pp + 2 * lp)


def ssd_chunk_plan(L: int, p: int, n: int, esize: int = 4, xvec: bool = True) -> dict:
    """The layout an SSD call takes (``choose_layout``): the first that fits
    of two x stages (the next head's x prefetched by cp.async, so 16-byte x
    rows only, ``xvec``) with C B^T cached, two stages recomputing C B^T
    per head, one stage cached, one stage recomputing; its bytes and
    threads per CTA.  No launch."""
    import ctypes
    cache, stages, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = ctypes.c_int64()
    build.check(build.library().ssd_chunk_plan(
        L, p, n, esize, int(xvec), *map(ctypes.byref, (cache, stages, threads, nbytes))),
        "ssd_chunk_plan")
    return {"cache_cb": bool(cache.value), "stages": stages.value,
            "smem_bytes": nbytes.value, "threads": threads.value}


def _ssd_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor) -> None:
    if x.dim() != 5 or dt.dim() != 4 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError("expected x (b, nc, L, h, p), dt (b, nc, L, h), A (h,), "
                         f"B, C (b, nc, L, n); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, nc, L, h, p = x.shape
    if dt.shape != (b, nc, L, h) or A.shape != (h,) or B.shape[:3] != (b, nc, L):
        raise ValueError(f"inconsistent shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share float32 or bfloat16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    n = B.shape[-1]
    if ssd_chunk_smem_bytes(L, p, n) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk L={L}, p={p}, n={n} needs "
                         f"{ssd_chunk_smem_bytes(L, p, n)} B of shared memory, "
                         f"over {MAX_SMEM_BYTES}")


def _ssd_bwd_fits(L: int, p: int, n: int) -> None:
    if L > SSD_BWD_MAX_L:
        raise ValueError(f"the SSD backward holds chunks of at most {SSD_BWD_MAX_L} steps, "
                         f"got L={L}")
    if ssd_chunk_bwd_smem_bytes(L, p, n) > MAX_SMEM_BYTES:
        raise ValueError(f"the SSD backward of chunk L={L}, p={p}, n={n} needs "
                         f"{ssd_chunk_bwd_smem_bytes(L, p, n)} B of shared memory, "
                         f"over {MAX_SMEM_BYTES}")


@_charged("ssd_chunk")
def _ssd_forward(x, dt, A, B, C):
    """The forward launch on checked inputs (the plain version on the CPU)."""
    where = _route(x, dt, A, B, C)
    if where == "cpu":
        return ref.ssd_chunk(x, dt, A, B, C)
    b, nc, L, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    S = torch.empty(b, nc, h, n, p, dtype=torch.float32, device=x.device)
    g = torch.empty(b, nc, h, dtype=torch.float32, device=x.device)
    if where == "meta":
        return y, S, g
    entry = "ssd_chunk_f32" if x.dtype == torch.float32 else "ssd_chunk_bf16"
    _launch("ssd_chunk", entry, x.device, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), S.data_ptr(),
            g.data_ptr(), b, nc, L, h, p, n)
    return y, S, g


class _SSDChunk(torch.autograd.Function):
    """The SSD block with a gradient: the forward kernel, then the backward
    kernel (``csrc/ssd_chunk_bwd.cu``) on the card or ``ref.ssd_chunk_bwd``
    on the CPU, from the saved inputs (everything else is recomputed)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        return _ssd_forward(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, dy, dS, dg):
        grads = ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(), dS.contiguous(),
                              dg.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor):
    """Mamba-2 intra-chunk block: ``x (b, nc, L, h, p)``, ``dt (b, nc, L,
    h)``, ``A (h,)``, ``B, C (b, nc, L, n)`` -> ``y_diag (b, nc, L, h, p)``
    in ``x``'s dtype, ``S (b, nc, h, n, p)`` f32, ``g (b, nc, h)`` f32.
    ``x``, ``B``, ``C`` share float32 or bfloat16; ``dt`` and ``A`` are
    float32.  Differentiable when an input requires grad (``_SSDChunk``:
    one forward and one backward launch a call; shapes the backward kernel
    holds, fp32 on the card)."""
    _ssd_args(x, dt, A, B, C)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        _ssd_bwd_fits(x.shape[2], x.shape[4], B.shape[-1])
        if x.device.type != "cpu" and x.dtype != torch.float32:
            raise ValueError(f"the SSD backward kernel takes float32 x, B and C, got "
                             f"{x.dtype}")
        return _SSDChunk.apply(x, dt, A, B, C)
    return _ssd_forward(x, dt, A, B, C)


# (dM' tiles, dW^T tiles) a warp of the SSD backward keeps in registers,
# by kernel variant (0 dW^T tiles: the dB term in shared memory), in the
# order ``csrc/ssd_chunk_bwd.cu`` ``variant_of`` tries them; the card test
# holds this choice and ``ssd_chunk_bwd_smem_bytes`` to the library's plan
# over a grid of shapes
SSD_BWD_VARIANTS = ((3, 1), (3, 8), (3, 16), (12, 0))


def _ssd_bwd_variant(L: int, n: int) -> tuple[int, int] | None:
    """The backward kernel's variant for chunk L and state n (the first
    whose registers hold a warp's share of the m16n8 tiles: its dM' tiles,
    and its dW^T tiles, in super-tiles of 2 x 4 where it keeps 8),
    None past ``SSD_BWD_MAX_L``."""
    lp, lp16, n16 = -(-L // 8) * 8, -(-L // 16) * 16, -(-n // 16) * 16
    tri = (lp16 // 16) * (lp16 // 16 + 1) - (lp16 - lp) // 8
    mt = -(-tri // 8)
    for v_mt, v_mw in SSD_BWD_VARIANTS:
        sr, sc = (2, 4) if v_mw == 8 else (1, 1)
        supertiles = -(-(n16 // 16) // sr) * -(-(lp // 8) // sc)
        if mt <= v_mt and (v_mw == 0 or supertiles <= 8 * (v_mw // (sr * sc))):
            return v_mt, v_mw
    return None


# the longest chunk the backward holds (its dM' tiles fit the widest variant)
SSD_BWD_MAX_L = max(L for L in range(1, 1024) if _ssd_bwd_variant(L, 1) is not None)


def ssd_chunk_bwd_smem_bytes(L: int, p: int, n: int) -> int:
    """Dynamic shared memory of one SSD backward CTA in its least layout
    (``csrc/ssd_chunk_bwd.cu`` ``make_layout`` with one head stage; L, p and
    n rounded up to 8, n to 16 for dS's rows): 1 KB of slack to align the
    stage, the larger of a head's stage (x, dy and dS as TMA lands them,
    dt; 1 KB granules) and a segment's end (dCB, and the dB term where the
    variant keeps it in registers), B and C, P, each warp's cum (fp64) and
    row, column and q partials, dk, the warps' totals, the stages'
    mbarriers, and the dB term where the variant keeps it in shared memory.
    A shape runs when it fits (and L <= ``SSD_BWD_MAX_L``);
    ``ssd_chunk_bwd_plan`` gives the layout a call takes (two stages where
    they fit)."""
    lp, p8, n8 = (-(-v // 8) * 8 for v in (L, p, n))
    n16 = -(-n // 16) * 16
    variant = _ssd_bwd_variant(L, n)
    term_in_smem = variant is None or variant[1] == 0
    head = (2 * lp + n16) * p8 + lp
    seg = lp * lp + (0 if term_in_smem else n16 * lp)
    stage = -(-max(head, seg) // 256) * 256
    return 4 * (256 + stage + 2 * lp * n8 + lp * lp + 40 * lp + lp + 16 + 8
                + (n16 * lp if term_in_smem else 0))


@functools.lru_cache(maxsize=1024)
def _ssd_bwd_plan(index: int, b: int, nc: int, L: int, h: int, p: int, n: int) -> dict:
    import ctypes
    stages, threads, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem, part = ctypes.c_int64(), ctypes.c_int64()
    dm_tiles, dw_tiles, least = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    with torch.cuda.device(index):
        build.check(build.library().ssd_chunk_bwd_plan(
            b, nc, L, h, p, n, *map(ctypes.byref, (stages, threads, ctas, smem, part,
                                                   dm_tiles, dw_tiles, least))),
            "ssd_chunk_bwd_plan")
    return {"stages": stages.value, "threads": threads.value, "ctas": ctas.value,
            "smem_bytes": smem.value, "part_floats": part.value,
            "variant": (dm_tiles.value, dw_tiles.value), "least_smem_bytes": least.value}


def ssd_chunk_bwd_plan(b: int, nc: int, L: int, h: int, p: int, n: int,
                       device: torch.device | None = None) -> dict:
    """The launch an SSD backward call of this shape makes on ``device``
    (the current card without it): head stages (2: the next head's inputs
    loaded while this one computes; 1 where two do not fit), threads per
    CTA, CTAs (the persistent grid: SMs times the CTAs per SM, at most b nc
    h), dynamic shared memory in bytes, and the floats of the per-(CTA,
    (batch, chunk)) partials of dB and dC, the kernel variant (the dM' and
    dW^T tiles a warp keeps, ``SSD_BWD_VARIANTS``) and the bytes of its
    least (one-stage) layout.  No launch."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(_ssd_bwd_plan(index, b, nc, L, h, p, n))


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, dy: torch.Tensor, dS: torch.Tensor, dg: torch.Tensor):
    """The gradient of ``ssd_chunk`` at ``(x, dt, A, B, C)`` for the output
    gradients ``dy`` (like ``x``), ``dS (b, nc, h, n, p)`` and ``dg (b, nc,
    h)``, both float32: ``dx, ddt, dA, dB, dC`` in the inputs' dtypes.  On
    the card fp32 only (a bf16 ``x`` raises) and one launch: the block's
    kernel and a pass summing the per-CTA partials of dB, dC and dA in a
    fixed order (no atomics: two runs agree bit for bit).  Any dtype of
    ``ssd_chunk`` on the CPU (``ref.ssd_chunk_bwd``)."""
    _ssd_args(x, dt, A, B, C)
    b, nc, L, h, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dS.shape != (b, nc, h, n, p) \
            or dg.shape != (b, nc, h) or dS.dtype != torch.float32 \
            or dg.dtype != torch.float32:
        raise ValueError(f"expected dy {tuple(x.shape)} {x.dtype}, dS {(b, nc, h, n, p)} "
                         f"and dg {(b, nc, h)} float32; got {tuple(dy.shape)} {dy.dtype}, "
                         f"{tuple(dS.shape)} {dS.dtype}, {tuple(dg.shape)} {dg.dtype}")
    _ssd_bwd_fits(L, p, n)
    return _ssd_bwd(x, dt, A, B, C, dy, dS, dg)


@_charged("ssd_chunk_bwd")
def _ssd_bwd(x, dt, A, B, C, dy, dS, dg):
    where = _route(x, dt, A, B, C, dy, dS, dg)
    if where == "cpu":
        return ref.ssd_chunk_bwd(x, dt, A, B, C, dy, dS, dg)
    if x.dtype != torch.float32:
        raise ValueError(f"the SSD backward kernel takes float32 x, B and C, got {x.dtype}")
    b, nc, L, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC = torch.empty_like(A), torch.empty_like(B), torch.empty_like(C)
    if where == "meta":
        return dx, ddt, dA, dB, dC
    if b * nc * h == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    plan = _ssd_bwd_plan(dev.index, b, nc, L, h, p, n)
    part = torch.empty(plan["part_floats"], dtype=torch.float32, device=dev)
    dapart = torch.empty(8 * b * nc * h, dtype=torch.float32, device=dev)    # a warp's share
    _launch("ssd_chunk_bwd", "ssd_chunk_bwd_f32", dev, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(), dS.data_ptr(),
            dg.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), part.data_ptr(), dapart.data_ptr(), plan["part_floats"], b, nc,
            L, h, p, n)
    return dx, ddt, dA, dB, dC
