"""Time the port's Eq. 6 and bf16 flash-attention wrappers on the card, at
the main paths' shapes and the zoo's other head dims, for the
``repro_torch`` of any source tree (to compare two commits in one run):

  python3 src/repro_torch/examples/kernel_times.py [--src TREE/src] [--label NAME] [--out FILE]

``--src`` puts that tree's ``src`` first on ``sys.path`` before
``repro_torch`` is imported (its kernels are built into that tree's
``build/``); the default is this file's own tree.  Per shape it prints the
CUDA-event ms per call (host dispatch included), the profiler's device ms
per call, the device kernels per call and the largest error against the
plain version.  ``chip_smoke.py`` uses the timing helpers below.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch


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


def device_profile(fn, event_ms: float) -> tuple[float | None, float]:
    """Mean device ms per call of the kernels ``fn`` launches, summed, and
    the mean number of device kernels per call, from ``torch.profiler``
    (CUPTI): the kernel work without the host's dispatch cost.  The ms is
    None if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    calls = max(1, min(20, int(200.0 / max(event_ms, 1e-3))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    kernels = sum(e.count for e in events) / calls
    return (total_us / calls / 1e3 if total_us > 0 else None), kernels


# (M, N, dtype) of Eq. 6: the EMNIST and CINIC models' widths and a large one
FEDAVG_SHAPES = [(16, 68_873, torch.float32), (16, 68_873, torch.bfloat16),
                 (16, 2_168_362, torch.float32), (16, 2 ** 24, torch.float32)]
# (b, s, H, KV, d, window) in bf16: the Hymba layer, danube's and qwen3's heads
FLASH_SHAPES = [(4, 2048, 25, 5, 64, 1024), (1, 2048, 32, 8, 80, 4096),
                (1, 2048, 32, 8, 128, None)]


def measure() -> list[dict]:
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
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
    for b, s, h, kv, d, window in FLASH_SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, kv, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, kv, d, generator=gen, device=dev).to(torch.bfloat16)
        err = float((ops.flash_attention(q, k, v, window=window).double()
                     - ref.flash_attention(q, k, v, window=window).double()).abs().max())
        call = lambda: ops.flash_attention(q, k, v, window=window)   # noqa: E731
        ms = time_ms(call)
        dev_ms, kernels = device_profile(call, ms)
        rows.append({"kernel": "flash_attention",
                     "shape": f"b={b} s={s} H={h} KV={kv} d={d} W={window} bfloat16",
                     "ms": ms, "device_ms": dev_ms, "kernels_per_call": kernels,
                     "max_abs_err": err})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    rows = measure()
    for r in rows:
        print(f"[{args.label}] {r['kernel']:15s} {r['shape']:36s} event {r['ms']:.4f} ms "
              f"device {r['device_ms']} ms, {r['kernels_per_call']:g} kernels/call, "
              f"err {r['max_abs_err']:.3e}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"label": args.label, "src": args.src,
                                              "device": torch.cuda.get_device_name(0),
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
