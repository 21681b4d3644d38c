"""Time the port's Eq. 6, bf16 and fp32 flash-attention (forward and
backward), Alg. 2 warp, Alg.
3 greedy-pass, Alg. 3 scorers (``kld_score``, ``kld_score_matrix``) and
Mamba-2 SSD-block wrappers on the card, at the main paths' shapes (and the
zoo's other head dims and SSD widths), for the ``repro_torch`` of any
source tree (to compare two commits in one run):

  python3 src/repro_torch/examples/kernel_times.py [--src TREE/src] [--label NAME] [--out FILE]
      [--only flash_attention,flash_attention_bwd,flash_attention_bwd_cases,ssd_chunk_bwd]
  python3 src/repro_torch/examples/kernel_times.py --profiler-sessions 100
  python3 src/repro_torch/examples/kernel_times.py --ptxas --sass

``--src`` puts that tree's ``src`` first on ``sys.path`` before
``repro_torch`` is imported (its kernels are built into that tree's
``build/``); the default is this file's own tree.  Per shape it prints the
CUDA-event ms per call (host dispatch included), the profiler's device ms
per call, the device kernels per call and the largest error against the
plain version (for the greedy pass: 0 where the picks are equal, else the
score gap at the first divergence, with a digest of the picks to compare
two trees' passes, and the least time the card could take); the warp
rows add ``F.grid_sample``'s event ms on the same inputs, the fp32 flash
rows SDPA's (fp32, explicit mask, KV heads repeated outside the call),
the backward rows SDPA's backward in the same dtype (its forward graph
built once outside the timed call) and, where the tree's wrapper takes
the forward's log-sum-exp, the call with it (the training path), each of
its kernels' device ms and every head split of the dK/dV pass (fp32
too where the tree's fp32 pass splits), and the fp32 backward with the
forward's lse at the card tests' shapes (``flash_attention_bwd_cases``);
the bf16 forward rows the forward writing that log-sum-exp;
the greedy, scoring and SSD rows give the least time the card could take
(the SSD backward's with its products at the split-fp32 tensor-core rate
the kernel runs them at, and beside it the bound at the CUDA cores' fp32
rate), and the plain version's event and device
ms (no one PyTorch call computes that gradient, so they have no library
time),
and the scoring rows the launch plan where the tree has one.  A shape
a tree's wrapper refuses gets a row with its error and no times.
``--only`` times the named kernels' rows alone.  ``chip_smoke.py`` uses
the timing and bound helpers below.
``--profiler-sessions N`` instead counts the device kernels the profiler
records in N sessions of one ``fedavg_agg`` call each (the one-kernel
check of ``tests/test_torch_cuda.py``), to tell a missed record from an
extra kernel.  ``--ptxas`` builds the library once more into a temporary
directory and prints, from its ``-Xptxas=-v`` log, the fp32 flash
(forward and backward), matrix and SSD backward kernels' registers and
spills; ``--sass`` counts the SASS
instructions of the matrix scorer's one-lane kernel in the built library
(``cuobjdump -sass``), and the float instructions among them, and the
issue-rate floors they imply at the matrix rows' shapes.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F



def _peaks():
    """``roofline/model.py``'s ``HW`` (H100 SXM data-sheet peaks, dense, no
    sparsity, at the 700 W limit), loaded from this file's own tree by
    path: ``--src`` points ``repro_torch`` at another tree, which may not
    have it."""
    path = Path(__file__).resolve().parents[1] / "roofline" / "model.py"
    spec = importlib.util.spec_from_file_location("_kernel_times_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.HW()


_HW = _peaks()
HBM_BYTES_PER_S = _HW.hbm_bw
FP32_FLOPS_PER_S = _HW.peak_flops_fp32
BF16_FLOPS_PER_S = _HW.peak_flops
TF32_FLOPS_PER_S = _HW.peak_flops_tf32
# fp32 products on the tensor cores in split fp32: three TF32 products each
SPLIT_FP32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS_PER_S
          ) -> tuple[float, str]:
    """The least ms the card could take for a function that moves
    ``nbytes`` and does ``flops`` operations at ``peak`` per second, and
    which of the two sets it ("bytes" or "operations")."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def greedy_bound(k: int, c: int, gamma: int) -> tuple[float, str]:
    """The greedy pass's bound: its (K, C) counts read once and K picks
    written, and ~8 f32 operations per class (merge, total, divide, clamp,
    log, subtract, multiply, accumulate) for each scoring the pass needs:
    every candidate once against an empty mediator (its static score,
    which each step that opens a mediator, 1 in gamma, takes as it is),
    then the K - s unpicked candidates at every other step s."""
    scorings = k + sum(k - s for s in range(k) if s % gamma)
    return bound(k * c * 4 + k * 4, 8.0 * scorings * c)


def score_bound(m: int, k: int, c: int) -> tuple[float, str]:
    """``kld_score`` (m = 1) and ``kld_score_matrix``: each count read once,
    each score written once; ~8 f32 operations per class and pair (merge,
    total, divide, clamp, log, subtract, multiply, accumulate), the greedy
    pass's rule."""
    return bound((m + k) * c * 4 + m * k * 4, 8.0 * m * k * c)


def ssd_bound(b: int, nc: int, L: int, h: int, p: int, n: int,
              dtype: torch.dtype) -> tuple[float, str]:
    """The SSD block: x read and y written in x's dtype, B and C read in
    it, dt, A, S and g in f32; C.B over n on the lower triangle once per
    (batch, chunk), as B and C have no head axis; per head y_diag over p
    and the decay exp on the lower triangle, the outgoing state, w and the
    cumsum; at the dtype's peak."""
    esize = torch.finfo(dtype).bits // 8
    tiles, tri = b * nc * h, L * (L + 1) // 2
    flops = (b * nc * tri * 2 * n
             + tiles * (tri * (2 * p + 2) + 2 * L * n * p + 3 * L * n + 2 * L))
    x_elems, bc_elems = b * nc * L * h * p, b * nc * L * n
    nbytes = (esize * (2 * x_elems + 2 * bc_elems) + 4 * (b * nc * L * h + h)
              + 4 * (b * nc * h * n * p + b * nc * h))
    return bound(nbytes, flops, BF16_FLOPS_PER_S if dtype == torch.bfloat16
                 else FP32_FLOPS_PER_S)


def ssd_bwd_bound(b: int, nc: int, L: int, h: int, p: int, n: int,
                  peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The SSD backward, fp32: per (batch, chunk, head) dx's P^T dy and dM'
    = dy x^T on the lower triangle (2 p operations an element each) and B
    dS and x dS^T (2 L n p each); per (batch, chunk) C B^T, dC and dB on
    the triangle (2 n each), as B and C have no head axis.  x, dt, A, B, C,
    dy, dS and dg read once, dx, ddt, dA, dB and dC written once.  At the
    CUDA cores' fp32 rate by default; ``ssd_bwd_split_bound`` at the rate
    of the kernel's split-fp32 tensor-core products."""
    tiles, tri = b * nc * h, L * (L + 1) // 2
    flops = tiles * (4 * tri * p + 4 * L * n * p) + b * nc * 6 * tri * n
    x_elems, bc_elems = b * nc * L * h * p, b * nc * L * n
    nbytes = 4 * (3 * x_elems + 2 * b * nc * L * h + 4 * bc_elems + b * nc * h * n * p
                  + b * nc * h + 2 * h)
    return bound(nbytes, flops, peak)


def ssd_bwd_split_bound(b: int, nc: int, L: int, h: int, p: int, n: int) -> tuple[float, str]:
    """``ssd_bwd_bound``'s bytes and operations with the operations at the
    split-fp32 tensor-core rate (three TF32 products for each fp32 product
    at 495 TFLOP/s: 165 TFLOP/s of fp32 work), the rate the kernel's
    products run at."""
    return ssd_bwd_bound(b, nc, L, h, p, n, SPLIT_FP32_FLOPS_PER_S)


def sdpa_mask(mask: torch.Tensor) -> torch.Tensor | None:
    """SDPA's ``attn_mask`` for a boolean ``mask``: None where it keeps
    every key (the same function, and SDPA may then take its flash
    kernel)."""
    return None if bool(mask.all()) else mask


def flash_bound(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor
                ) -> tuple[float, str]:
    """Attention of ``q (b, sq, H, d)`` over ``k, v (b, skv, KV, d)`` under
    ``mask (sq, skv)``: 4d operations per visible (query, key) pair at the
    type's peak (tensor cores for bf16, CUDA cores for fp32); q, k and v
    read once, the output written once."""
    b, _, h, d = q.shape
    pairs = int(mask.sum()) * b * h
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(q.element_size() * (2 * q.numel() + 2 * k.numel()), 4.0 * d * pairs, peak)


def flash_bwd_bound(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor
                    ) -> tuple[float, str]:
    """The attention backward of ``q (b, sq, H, d)`` over ``k, v (b, skv,
    KV, d)`` under ``mask``: five d-long products per visible (query, key)
    pair (S and dO V^T recomputed, then dV, dK and dQ), 2d operations each,
    so half of the full square under a causal mask, at the type's peak; q,
    k, v, out and dout read once, dq, dk and dv written once."""
    b, _, h, d = q.shape
    pairs = int(mask.sum()) * b * h
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(q.element_size() * (4 * q.numel() + 4 * k.numel()), 10.0 * d * pairs, peak)


def sdpa_backward(q, k, v, dout, mask):
    """A callable that runs SDPA's backward (the library's attention
    gradient, the yardstick of ``flash_attention_bwd``) on the same inputs
    and mask, in its ``(b, H, s, d)`` layout with the KV heads repeated:
    the forward graph is built once here, outside the timed call."""
    h, kv = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
              .requires_grad_(True) for t in (k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


def ssd_inputs(b, nc, L, h, p, n, dtype, gen, dev):
    """Random SSD inputs at Mamba-2's scales: softplus steps, A = -exp."""
    x = torch.randn(b, nc, L, h, p, generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn(b, nc, L, h, generator=gen, device=dev) - 1.0)
    A = -torch.exp(torch.randn(h, generator=gen, device=dev))
    B = torch.randn(b, nc, L, n, generator=gen, device=dev).to(dtype)
    C = torch.randn(b, nc, L, n, generator=gen, device=dev).to(dtype)
    return x, dt, A, B, C


def ssd_bwd_inputs(b, nc, L, h, p, n, gen, dev):
    """``ssd_inputs`` in fp32 and random output gradients dy, dS, dg: the
    SSD backward's eight arguments."""
    return ssd_inputs(b, nc, L, h, p, n, torch.float32, gen, dev) + (
        torch.randn(b, nc, L, h, p, generator=gen, device=dev),
        torch.randn(b, nc, h, n, p, generator=gen, device=dev),
        torch.randn(b, nc, h, generator=gen, device=dev))


def time_ms(fn, min_ms: float = 50.0, max_reps: int = 4096) -> float:
    """Mean device time of ``fn`` over enough back-to-back calls to span
    ``min_ms`` (CUDA events), after synchronized warm-up calls spanning 20
    ms (at least one), so the card's clocks have ramped up.  Each warm-up
    call is waited for: a kernel launch returns before the kernel runs."""
    t_end = time.perf_counter() + 0.02
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() >= t_end:
            break
    reps = 1
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end)
        if total >= min_ms or reps >= max_reps:
            return total / reps
        reps = min(max_reps, reps * max(2, int(math.ceil(min_ms / max(total, 1e-3)))))


def kernel_breakdown(fn, event_ms: float) -> dict[str, float]:
    """Mean device ms per call of each kernel ``fn`` launches, by its short
    name (``bwd_dkdv_tc_kernel<128>``), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    calls = max(1, min(20, int(200.0 / max(event_ms, 1e-3))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.key)
            name = (m.group(1) + (m.group(2) or "")) if m else e.key[:60]
            out[name] += getattr(e, "self_device_time_total", 0.0) / calls / 1e3
    return dict(out)


def device_profile(fn, event_ms: float) -> tuple[float | None, float]:
    """Mean device ms per call of the kernels ``fn`` launches, summed, and
    the mean number of device kernels per call, from ``torch.profiler``
    (CUPTI): the kernel work without the host's dispatch cost.  A window
    that records no device kernel at all (the profiler sometimes drops a
    whole window, though ``fn`` launched) is profiled again, up to three
    in all; the ms is None if none records device time."""
    from torch.profiler import ProfilerActivity, profile
    calls = max(1, min(20, int(200.0 / max(event_ms, 1e-3))))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    kernels = sum(e.count for e in events) / calls
    return (total_us / calls / 1e3 if total_us > 0 else None), kernels


def graph_kernel_count(fn) -> int:
    """Device kernels one call of ``fn`` launches, counted without the
    profiler (which drops records now and then): the call is captured in a
    ``torch.cuda.CUDAGraph`` after one warm-up call, and the captured
    graph's kernel nodes are counted through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  A capture records every
    launch on the stream, so a second kernel cannot go unseen; memsets and
    copies are other node types."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0              # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


# (M, N, dtype) of Eq. 6: the EMNIST and CINIC models' widths and a large one
FEDAVG_SHAPES = [(16, 68_873, torch.float32), (16, 68_873, torch.bfloat16),
                 (16, 2_168_362, torch.float32), (16, 2 ** 24, torch.float32)]
# (b, sq, skv, H, KV, d, causal, window), timed in bf16 and fp32: the Hymba
# layer, danube's and qwen3's heads, gemma's layer
FLASH_SHAPES = [(4, 2048, 2048, 25, 5, 64, True, 1024), (1, 2048, 2048, 32, 8, 80, True, 4096),
                (1, 2048, 2048, 32, 8, 128, True, None), (4, 2048, 2048, 8, 1, 256, True, None),
                # granite-moe-3b-a800m's (GQA 24:8) and internvl2-1b's (14:2)
                # prefill layers; whisper-base's encoder layer (non-causal over
                # 1,536 frames) and cross-attention from a 256-token prompt
                # (prefill) and from one token (a decode step)
                (4, 2048, 2048, 24, 8, 64, True, None), (4, 2048, 2048, 14, 2, 64, True, None),
                (4, 1536, 1536, 8, 8, 64, False, None), (4, 256, 1536, 8, 8, 64, False, None),
                (4, 1, 1536, 8, 8, 64, False, None)]
# (b, sq, skv, H, KV, d, window, q_offset) of the attention backward
# (chip_smoke.py phase 3's), timed in bf16 and fp32: qwen3-4b's training
# layer, the reduced configs' layer, danube's head under a window with a
# query offset, gemma's layer
FLASH_BWD_SHAPES = [(4, 128, 128, 32, 8, 128, None, 0), (4, 128, 128, 4, 4, 64, None, 0),
                    (1, 1024, 2048, 32, 8, 80, 512, 1024),
                    (4, 1024, 1024, 8, 1, 256, None, 0)]
# (b, sq, skv, H, KV, d, causal, window, q_offset) of the backward's card
# tests (tests/test_torch_cuda.py BWD_CARD_CASES), timed in fp32 with the
# forward's lse
FLASH_BWD_CARD_CASES = [(2, 64, 64, 4, 4, 64, True, None, 0),
                        (4, 128, 128, 32, 8, 128, True, None, 0),
                        (1, 300, 300, 32, 8, 80, True, 96, 0),
                        (2, 256, 256, 8, 1, 256, True, None, 0),
                        (1, 70, 131, 4, 2, 64, True, 50, 61),
                        (1, 45, 77, 6, 3, 128, False, None, 0),
                        (1, 40, 40, 2, 1, 80, True, 8, 45),
                        (1, 1024, 1024, 8, 1, 256, True, None, 0)]
# (B, H, W, C) of the warp: the EMNIST round's slots (16 clients x 460), the
# CINIC batch of phase 3, a rectangular image
WARP_SHAPES = [(7360, 28, 28, 1), (4096, 32, 32, 3), (7360, 20, 36, 3)]
# (K, C, gamma) of the greedy pass: the FL cohort's size, Path A's pass,
# the large row, and the large row with every step opening a mediator
# (gamma 1: no step scores, so its time per step is the pass's
# synchronization floor)
GREEDY_SHAPES = [(16, 47, 4), (1024, 47, 4), (4096, 47, 4), (4096, 47, 1)]
# (K, C) of the per-step scorer: the CINIC cohort's width, Path A's K at
# its first steps, its largest K, a large K, the widest C held in
# registers, C = 1,100 (the greedy pass's wide row), 2,000, and many
# classes (the error rows show where a sum's rounding drifts with C)
SCORE_SHAPES = [(16, 10), (512, 47), (1024, 47), (4096, 47), (512, 256), (512, 1_100),
                (512, 2_000), (16, 60_000)]
# (M, K, C) of the matrix scorer: the CINIC-size sweep, Path A's sweep
# (256 mediators x 1,024 clients), a large sweep and many classes
MATRIX_SHAPES = [(16, 512, 47), (256, 1024, 47), (256, 4096, 47), (16, 512, 2000)]
# (b, nc, L, h, p, n, dtype) of the SSD block: the Hymba prefill layer in
# f32 and bf16, mamba2-370m's block (32 heads of 64, state 128, chunk 64:
# src/repro/configs/mamba2_370m.py) over one 2,048-token sequence, and the
# fp32 training layers the SSD backward's rows below take (Hymba at 4 x
# 128, mamba2-370m at 4 x 512)
SSD_SHAPES = [(4, 32, 64, 25, 64, 16, torch.float32), (4, 32, 64, 25, 64, 16, torch.bfloat16),
              (1, 32, 64, 32, 64, 128, torch.float32), (4, 2, 64, 25, 64, 16, torch.float32),
              (4, 8, 64, 32, 64, 128, torch.float32)]
# (b, nc, L, h, p, n) of the SSD backward: Hymba's training layer (4 x 128),
# mamba2-370m's (4 x 512), Hymba's serve-length shape and a reduced config's
SSD_BWD_SHAPES = [(4, 2, 64, 25, 64, 16), (4, 8, 64, 32, 64, 128), (4, 32, 64, 25, 64, 16),
                  (1, 1, 64, 4, 32, 16)]


def warp_inputs(b, h, w, c, gen, dev):
    """Images, the Alg. 2 maps, and ``grid_sample``'s NCHW images and grid
    for the same inverse map (align_corners=True puts -1/+1 on the edge
    pixel centres, the warp's convention)."""
    from repro_torch.core.augmentation import affine_from_uniform
    from repro_torch.kernels import ref
    imgs = torch.randn(b, h, w, c, generator=gen, device=dev)
    mats, trans = affine_from_uniform(torch.rand(b, 6, generator=gen, device=dev))
    mats, trans = mats.contiguous(), trans.contiguous()
    sy, sx = ref.warp_coords(h, w, mats, trans)
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    return imgs, mats, trans, imgs.permute(0, 3, 1, 2).contiguous(), grid


def grid_sample(nchw, grid):
    return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def _accepts(fn, name: str) -> bool:
    """Whether ``fn`` (a tree's wrapper) takes the keyword ``name``."""
    import inspect
    return name in inspect.signature(fn).parameters


def flash_bwd_rows(gen, dev) -> list[dict]:
    """The attention backward at ``FLASH_BWD_SHAPES`` in bf16 and fp32: the
    direct call (the tree's wrapper finds the row statistics itself)
    beside its plain version, the bound, SDPA's backward and, where the
    tree's wrapper takes them, the call with the forward's lse (the
    training path) and its kernels' device ms, and each head split of the
    dK/dV pass (in fp32 only where the tree's fp32 pass splits)."""
    from repro_torch.kernels import ops, ref
    rows = []
    with_lse = _accepts(ops.flash_attention_bwd, "lse")
    with_split = hasattr(ops, "_flash_bwd_launch")
    fp32_split = hasattr(ops, "flash_bwd_rows")    # the fp32 dK/dV pass splits too
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, skv, h, kv, d, window, off in FLASH_BWD_SHAPES:
            kw = dict(causal=True, window=window, q_offset=off)
            q, dout = (torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            mask = ref.attention_mask(sq, skv, device=dev, **kw)
            out = ops.flash_attention(q, k, v, **kw)
            b_ms, by = flash_bwd_bound(q, k, mask)
            row = {"kernel": "flash_attention_bwd",
                   "shape": f"b={b} sq={sq} skv={skv} H={h} KV={kv} d={d} W={window} "
                            f"off={off} {str(dtype)[6:]}", "bound_ms": b_ms, "bound_by": by}
            row = _timed_row(row, lambda: ops.flash_attention_bwd(q, k, v, out, dout, **kw),
                             lambda: ref.flash_attention_bwd(q, k, v, out, dout, **kw))
            if with_lse:
                _, lse = ops._flash_forward(q, k, v, True, window, off, with_lse=True)
                call = lambda: ops.flash_attention_bwd(  # noqa: E731
                    q, k, v, out, dout, lse=lse, **kw)
                row["lse_ms"] = time_ms(call)
                row["lse_device_ms"] = device_profile(call, row["lse_ms"])[0]
                row["lse_kernels_device_ms"] = kernel_breakdown(call, row["lse_ms"])
                if with_split and (dtype == torch.bfloat16 or fp32_split):
                    tile = dict(d=d, dtype=dtype) if fp32_split \
                        else dict(keys=ops.flash_bwd_keys(d))
                    row["split"] = ops.flash_bwd_split(
                        b, sq, skv, kv, h // kv, ops._sm_count(dev.index), **tile, **kw)
                    row["split_ms"], row["split_device_ms"] = {}, {}
                    for s in (s for s in range(1, h // kv + 1) if (h // kv) % s == 0):
                        fn = lambda: ops._flash_bwd_launch(  # noqa: E731
                            q, k, v, out, dout, lse, s, **kw)
                        row["split_ms"][s] = time_ms(fn)
                        row["split_device_ms"][s] = device_profile(fn, row["split_ms"][s])[0]
                del lse
            lib = sdpa_backward(q, k, v, dout, mask)
            row["sdpa_bwd_ms"] = time_ms(lib)
            row["sdpa_bwd_device_ms"] = device_profile(lib, row["sdpa_bwd_ms"])[0]
            rows.append(row)
            del q, k, v, out, dout, lib
    return rows


def flash_bwd_case_rows(gen, dev) -> list[dict]:
    """The fp32 attention backward with the forward's lse (the training
    path's call) at ``FLASH_BWD_CARD_CASES``: event and device ms, beside
    the bound."""
    from repro_torch.kernels import ops, ref
    rows = []
    for b, sq, skv, h, kv, d, causal, window, off in FLASH_BWD_CARD_CASES:
        kw = dict(causal=causal, window=window, q_offset=off)
        q, dout = (torch.randn(b, sq, h, d, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(b, skv, kv, d, generator=gen, device=dev) for _ in range(2))
        out, lse = ops._flash_forward(q, k, v, causal, window, off, with_lse=True)
        b_ms, by = flash_bwd_bound(q, k, ref.attention_mask(sq, skv, device=dev, **kw))
        row = {"kernel": "flash_attention_bwd_cases",
               "shape": f"b={b} sq={sq} skv={skv} H={h} KV={kv} d={d} causal={causal} "
                        f"W={window} off={off} float32", "bound_ms": b_ms, "bound_by": by}
        rows.append(_timed_row(
            row, lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw),
            lambda: ref.flash_attention_bwd(q, k, v, out, dout, **kw)))
    return rows


def measure(only: set[str] | None = None) -> list[dict]:
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    rng = np.random.default_rng(0)

    def want(name: str) -> bool:
        return only is None or name in only

    if want("fedavg_agg"):
        for m, n, dtype in FEDAVG_SHAPES:
            d = torch.randn(m, n, generator=gen, device=dev).to(dtype)
            w = torch.rand(m, generator=gen, device=dev) * 100 + 1
            err = float((ops.fedavg_agg(d, w).double() - ref.fedavg_agg(d, w).double()).abs().max())
            call = lambda: ops.fedavg_agg(d, w)      # noqa: E731
            ms = time_ms(call)
            dev_ms, kernels = device_profile(call, ms)
            rows.append({"kernel": "fedavg_agg", "shape": f"M={m} N={n} {str(dtype)[6:]}",
                         "ms": ms, "device_ms": dev_ms, "kernels_per_call": kernels,
                         "max_abs_err": err})
    if want("flash_attention"):
        for dtype in (torch.bfloat16, torch.float32):
            for b, sq, skv, h, kv, d, causal, window in FLASH_SHAPES:
                q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
                k = torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype)
                v = torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype)
                kw = dict(causal=causal, window=window)
                mask = ref.attention_mask(sq, skv, q_offset=0, device=dev, **kw)
                b_ms, by = flash_bound(q, k, mask)
                shape = f"b={b} s={sq}" if sq == skv else f"b={b} sq={sq} skv={skv}"
                row = {"kernel": "flash_attention",
                       "shape": f"{shape} H={h} KV={kv} d={d} W={window}"
                                + ("" if causal else " non-causal") + f" {str(dtype)[6:]}",
                       "bound_ms": b_ms, "bound_by": by}
                row = _timed_row(row, lambda: ops.flash_attention(q, k, v, **kw),
                                 lambda: ref.flash_attention(q, k, v, **kw))
                if _accepts(ops._flash_forward, "with_lse") and row["ms"] is not None:
                    # what writing the backward's lse costs the forward
                    fwd = lambda: ops._flash_forward(  # noqa: E731
                        q, k, v, causal, window, 0, with_lse=True)
                    row["lse_ms"] = time_ms(fwd)
                    row["lse_device_ms"] = device_profile(fwd, row["lse_ms"])[0]
                if (dtype == torch.float32 or not causal) and row["ms"] is not None:
                    # the library's attention on the same inputs and mask (no
                    # mask where every key is seen: SDPA then picks its
                    # fastest kernel); the causal rows' in fp32 only
                    qt = q.transpose(1, 2).contiguous()
                    kt, vt = (t.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
                              for t in (k, v))
                    lib_mask = sdpa_mask(mask)
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, attn_mask=lib_mask)
                    row["sdpa_ms"] = time_ms(sdpa)
                    row["sdpa_device_ms"] = device_profile(sdpa, row["sdpa_ms"])[0]
                    del qt, kt, vt
                rows.append(row)
                del q, k, v
    if want("flash_attention_bwd"):
        if hasattr(ops, "flash_attention_bwd"):         # absent in older trees
            rows += flash_bwd_rows(gen, dev)
    if want("flash_attention_bwd_cases") and _accepts(ops.flash_attention_bwd, "lse"):
        rows += flash_bwd_case_rows(gen, dev)
    if want("affine_warp"):
        for b, h, w, c in WARP_SHAPES:
            imgs, mats, trans, nchw, grid = warp_inputs(b, h, w, c, gen, dev)
            err = float((ops.affine_warp(imgs, mats, trans)
                         - ref.affine_warp(imgs, mats, trans)).abs().max())
            call = lambda: ops.affine_warp(imgs, mats, trans)          # noqa: E731
            ms = time_ms(call)
            dev_ms, kernels = device_profile(call, ms)
            lib = lambda: grid_sample(nchw, grid)                      # noqa: E731
            lib_ms = time_ms(lib)
            rows.append({"kernel": "affine_warp", "shape": f"B={b} {h}x{w}x{c}",
                         "ms": ms, "device_ms": dev_ms, "kernels_per_call": kernels,
                         "max_abs_err": err, "grid_sample_ms": lib_ms,
                         "grid_sample_device_ms": device_profile(lib, lib_ms)[0]})
    if want("kld_greedy_picks"):
        from repro_torch.core import scheduling
        for k, c, gamma in GREEDY_SHAPES:
            counts_np = rng.integers(0, 200, (k, c))
            counts = torch.as_tensor(counts_np, dtype=torch.float32, device=dev)
            kp = ops.kld_greedy_picks(counts, gamma).cpu().numpy()
            div = scheduling.first_divergence(counts_np, gamma,
                                              ref.kld_greedy_picks(counts, gamma).cpu().numpy(),
                                              kp)
            call = lambda: ops.kld_greedy_picks(counts, gamma)         # noqa: E731
            ms = time_ms(call)
            dev_ms, kernels = device_profile(call, ms)
            b_ms, by = greedy_bound(k, c, gamma)
            # the picks' digest tells two trees' passes apart without the picks
            rows.append({"kernel": "kld_greedy_picks", "shape": f"K={k} C={c} gamma={gamma}",
                         "ms": ms, "device_ms": dev_ms, "kernels_per_call": kernels,
                         "bound_ms": b_ms, "bound_by": by,
                         "max_abs_err": 0.0 if div is None else abs(div["score_a"] - div["score_b"]),
                         "first_divergence_from_plain": div, "us_per_step": 1e3 * ms / k,
                         "picks_sha256": hashlib.sha256(kp.astype(np.int32).tobytes()).hexdigest()})
    if want("kld_score"):
        for k, c in SCORE_SHAPES:
            med = torch.as_tensor(rng.random(c) * 100, dtype=torch.float32, device=dev)
            cand = torch.as_tensor(rng.random((k, c)) * 50, dtype=torch.float32, device=dev)
            b_ms, by = score_bound(1, k, c)
            row = {"kernel": "kld_score", "shape": f"K={k} C={c}", "bound_ms": b_ms,
                   "bound_by": by}
            if hasattr(ops, "kld_score_plan"):          # absent in older trees
                row["plan"] = ops.kld_score_plan(k, c)
            rows.append(_timed_row(row, lambda: ops.kld_score(med, cand),
                                   lambda: ref.kld_score(med, cand)))
    if want("kld_score_matrix"):
        for m, k, c in MATRIX_SHAPES:
            meds = torch.as_tensor(rng.random((m, c)) * 100, dtype=torch.float32, device=dev)
            cand = torch.as_tensor(rng.random((k, c)) * 50, dtype=torch.float32, device=dev)
            b_ms, by = score_bound(m, k, c)
            row = {"kernel": "kld_score_matrix", "shape": f"M={m} K={k} C={c}",
                   "bound_ms": b_ms, "bound_by": by}
            if hasattr(ops, "kld_score_matrix_plan"):   # absent in older trees
                row["plan"] = ops.kld_score_matrix_plan(m, k, c, meds, cand)
            rows.append(_timed_row(row, lambda: ops.kld_score_matrix(meds, cand),
                                   lambda: ref.kld_score_matrix(meds, cand)))
    if want("ssd_chunk"):
        for b, nc, L, h, p, n, dtype in SSD_SHAPES:
            args = ssd_inputs(b, nc, L, h, p, n, dtype, gen, dev)
            b_ms, by = ssd_bound(b, nc, L, h, p, n, dtype)
            row = {"kernel": "ssd_chunk", "shape": f"b={b} nc={nc} L={L} h={h} p={p} n={n} "
                                                   f"{str(dtype)[6:]}",
                   "bound_ms": b_ms, "bound_by": by}
            rows.append(_timed_row(row, lambda: ops.ssd_chunk(*args), lambda: ref.ssd_chunk(*args)))
    if want("ssd_chunk_bwd") and hasattr(ops, "ssd_chunk_bwd"):     # absent in older trees
        for b, nc, L, h, p, n in SSD_BWD_SHAPES:
            args = ssd_bwd_inputs(b, nc, L, h, p, n, gen, dev)
            b_ms, by = ssd_bwd_split_bound(b, nc, L, h, p, n)
            c_ms, c_by = ssd_bwd_bound(b, nc, L, h, p, n)
            row = {"kernel": "ssd_chunk_bwd",
                   "shape": f"b={b} nc={nc} L={L} h={h} p={p} n={n} float32",
                   "bound_ms": b_ms, "bound_by": by, "fp32_core_bound_ms": c_ms,
                   "fp32_core_bound_by": c_by, "library": "none"}
            plain = lambda: ref.ssd_chunk_bwd(*args)          # noqa: E731
            row = _timed_row(row, lambda: ops.ssd_chunk_bwd(*args), plain)
            if row["ms"] is not None:
                row["plan"] = ops.ssd_chunk_bwd_plan(b, nc, L, h, p, n)
                row["plain_ms"] = time_ms(plain)
                row["plain_device_ms"] = device_profile(plain, row["plain_ms"])[0]
            rows.append(row)
    return rows


def _timed_row(row: dict, call, plain) -> dict:
    """``row`` with the call's largest error against ``plain`` (each output's
    absolute error, and over its scale), event and device ms, kernels per
    call; or the error a wrapper raised for a shape it refuses (a
    ValueError; a failed build or launch stops the run)."""
    try:
        got = call()
    except ValueError as e:
        return {**row, "refused": str(e), "ms": None, "device_ms": None,
                "kernels_per_call": 0, "max_abs_err": float("nan")}
    want = plain()
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    errs = [float((o.double() - w.double()).abs().max()) for o, w in zip(got, want)]
    scales = [max(float(w.double().abs().max()), 1.0) for w in want]
    row["max_abs_err"] = max(errs)
    row["err_over_scale"] = max(e / s for e, s in zip(errs, scales))
    row["ms"] = time_ms(call)
    row["device_ms"], row["kernels_per_call"] = device_profile(call, row["ms"])
    return row


def ptxas_report(names=("flash_f32_kernel", "bwd_dkdv_f32_kernel", "bwd_dq_f32_kernel",
                        "kld_score_matrix_kernel", "ssd_bwd_kernel")) -> list[str]:
    """Registers and spills ptxas reports for every kernel whose mangled
    name holds one of ``names``, from the build log of the library built
    once more into a temporary directory."""
    from repro_torch.kernels import build
    log: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        build.build(log, Path(tmp))
    lines, entry = [], None
    for line in "\n".join(log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(n in m.group(1) for n in names) else None
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split('info    :')[-1].strip()}")
    return lines


# opcodes that compute on floating-point values (FFMA, FADD, FMUL, FSETP,
# FSEL, FMNMX, FCHK, F2F, MUFU, DADD, I2F, ...)
FLOAT_OPCODES = ("F", "MUFU", "D", "I2F")


def sass_counts() -> dict:
    """SASS instructions per class of the matrix scorer, from its one-lane
    kernel (which streams the rows) in the built library (``cuobjdump
    -sass``): its innermost loops (a branch back to an earlier address with
    no other such branch inside) are its two sums, per path (staged: the
    loops that read shared memory, LDS; direct: the others) and per type
    (f32 up to 64 classes, f64 past that: the loops with DADD), each
    unrolled over some classes, which read two counts each (so a loop's
    classes are its loads over 2); the slow paths of the division and the
    logarithm lie outside the loops.  Per (path, type): the two sums'
    instructions per class added, the float instructions among them (the
    merge, the adds of both sums, the division, the clamp, the logarithm,
    the subtract and the multiply: what the function's op order needs;
    the rest are loads, address arithmetic, loop control and the
    logarithm's few integer steps), and the commonest opcodes."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    ins, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and name and "kld_score_matrix_kernel" in name and "ILi1EE" in name \
                and not m.group(2).startswith("NOP"):
            ins.append((int(m.group(1), 16), m.group(2), m.group(3), name))
    backs = []
    for addr, op, rest, _ in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            backs.append((int(t.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in backs
             if not any(lo <= lo2 and hi2 < hi for lo2, hi2 in backs if (lo2, hi2) != (lo, hi))]
    groups = collections.defaultdict(list)
    for lo, hi in inner:
        body = [op for a, op, _, _ in ins if lo <= a <= hi]
        loads = sum(op.startswith(("LD.", "LDS", "LDG")) or op == "LD" for op in body)
        if loads and any(op.startswith(("FADD", "DADD")) for op in body):
            path = "staged" if any(op.startswith("LDS") for op in body) else "direct"
            wide = any(op.startswith("DADD") for op in body)
            groups[(path, "f64" if wide else "f32")].append((len(body), loads // 2, body))
    out = {}
    for key, loops in groups.items():
        sums = sorted(loops, key=lambda x: x[0])[-2:]
        if len(sums) == 2:
            ops_seen = collections.Counter(op.split(".")[0] for _, _, b in sums for op in b)
            out[key] = {"function": ins[0][3],
                        "loops": [(n, cls) for n, cls, _ in sums],
                        "per_class": sum(n / cls for n, cls, _ in sums),
                        "float_per_class": sum(sum(op.startswith(FLOAT_OPCODES) for op in b)
                                               / cls for _, cls, b in sums),
                        "top_opcodes": ops_seen.most_common(8)}
    return out


def issue_floor_ms(m: int, k: int, c: int, per_class: float, sm_mhz: float,
                   sms: int) -> float:
    """The least ms ``sms`` SMs need to issue ``per_class`` instructions for
    every class of every pair, one pair a lane, 32 lanes a warp
    instruction, 4 warp instructions a cycle on each SM at ``sm_mhz``."""
    return m * k * c * per_class / 32 / (4 * sms * sm_mhz * 1e6) * 1e3


def profiler_sessions(sessions: int) -> dict[int, dict[int, int]]:
    """Per Eq. 6 width of the main paths: {device kernels recorded: number
    of profiler sessions}, over ``sessions`` sessions of one call each."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    out = {}
    for n in (68_873, 2_168_362):
        d = torch.randn(16, n, device="cuda")
        w = torch.rand(16, device="cuda")
        seen: dict[int, int] = {}
        for _ in range(sessions):
            ops.fedavg_agg(d, w)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ops.fedavg_agg(d, w)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            seen[kernels] = seen.get(kernels, 0) + 1
        out[n] = dict(sorted(seen.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    ap.add_argument("--profiler-sessions", type=int, default=0,
                    help="count the kernels recorded in this many one-call sessions")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the fp32 flash (forward, backward), matrix and SSD backward "
                         "kernels' registers and spills")
    ap.add_argument("--sass", action="store_true",
                    help="count the matrix scorer's SASS instructions per class")
    ap.add_argument("--only", default=None,
                    help="time only these kernels (comma-separated ops names, e.g. "
                         "flash_attention,flash_attention_bwd)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.profiler_sessions:
        for n, seen in profiler_sessions(args.profiler_sessions).items():
            print(f"[{args.label}] fedavg_agg M=16 N={n}: sessions by device kernels "
                  f"recorded {seen}", flush=True)
        return 0
    if args.ptxas or args.sass:
        if args.ptxas:
            for line in ptxas_report():
                print(f"[{args.label}] ptxas {line}", flush=True)
        if args.sass:
            mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True).stdout.split()[0])
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            counts = sass_counts()
            for (path, key), r in sorted(counts.items()):
                print(f"[{args.label}] sass {path} {key} sums {r['function']}: (instructions, "
                      f"classes) per loop {r['loops']}, {r['per_class']:.2f} per class, "
                      f"{r['float_per_class']:.2f} of them float; top {r['top_opcodes']}",
                      flush=True)
            for m, k, c in MATRIX_SHAPES:
                r = counts.get(("staged", "f32" if c <= 64 else "f64"))
                if r and r["per_class"]:
                    print(f"[{args.label}] sass floor M={m} K={k} C={c} (staged path, "
                          f"{sms} SMs at {mhz:.0f} MHz): float instructions "
                          f"{issue_floor_ms(m, k, c, r['float_per_class'], mhz, sms):.6f} ms "
                          f"({r['float_per_class']:.2f} a class), the whole loop "
                          f"{issue_floor_ms(m, k, c, r['per_class'], mhz, sms):.6f} ms "
                          f"({r['per_class']:.2f} a class)", flush=True)
        return 0
    rows = measure(None if args.only is None else set(args.only.split(",")))
    for r in rows:
        if "refused" in r:
            print(f"[{args.label}] {r['kernel']:16s} {r['shape']:36s} refused: {r['refused']}",
                  flush=True)
            continue
        extra = (f", grid_sample {r['grid_sample_ms']:.4f} ms "
                 f"(device {r['grid_sample_device_ms']})" if "grid_sample_ms" in r else "")
        if "bound_ms" in r:
            extra += f", bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            if r["device_ms"]:
                extra += f", {100 * r['bound_ms'] / r['device_ms']:.1f} % of it by device time"
        if "fp32_core_bound_ms" in r:
            extra += (f", fp32-core bound {r['fp32_core_bound_ms']:.6f} ms "
                      f"({r['fp32_core_bound_by']})")
            if r["device_ms"]:
                extra += f", {100 * r['fp32_core_bound_ms'] / r['device_ms']:.1f} % of it"
        if "plan" in r:
            extra += f", plan {r['plan']}"
        if "sdpa_ms" in r:
            extra += f", SDPA {r['shape'].split()[-1]} {r['sdpa_ms']:.4f} ms (device {r['sdpa_device_ms']})"
        if "lse_ms" in r:
            extra += f", with lse {r['lse_ms']:.4f} ms (device {r['lse_device_ms']})"
        if "lse_kernels_device_ms" in r:
            extra += ", kernels " + ", ".join(f"{k} {v:.4f}" for k, v in
                                              r["lse_kernels_device_ms"].items())
        if "split_device_ms" in r:
            extra += (f", split {r['split']}; event (device) ms by split " + ", ".join(
                f"{k}: {r['split_ms'][k]:.4f} ({r['split_device_ms'][k]})"
                for k in r["split_ms"]))
        if "plain_ms" in r:
            extra += (f", plain {r['plain_ms']:.4f} ms (device {r['plain_device_ms']}), "
                      f"library {r['library']}")
        if "sdpa_bwd_ms" in r:
            extra += (f", SDPA backward {r['sdpa_bwd_ms']:.4f} ms "
                      f"(device {r['sdpa_bwd_device_ms']})")
        print(f"[{args.label}] {r['kernel']:16s} {r['shape']:36s} event {r['ms']:.4f} ms "
              f"device {r['device_ms']} ms, {r['kernels_per_call']:g} kernels/call, "
              f"err {r['max_abs_err']:.3e}{extra}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"label": args.label, "src": args.src,
                                              "device": torch.cuda.get_device_name(0),
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
