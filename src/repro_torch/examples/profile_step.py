"""Where a full-width AdamW step of the zoo's training path spends its time
on the card, for the ``repro_torch`` of any source tree (to compare two
commits in one run, in turns):

  python3 src/repro_torch/examples/profile_step.py [--src TREE/src] [--label NAME]
      [--arch qwen3-4b] [--steps 6] [--profiled 3] [--out FILE]

Builds ``--arch`` at its published widths (bf16, weights from seed 0), as
``chip_smoke.py`` phase 11 does, and runs ``--steps`` AdamW steps of
``launch.steps.make_train_step`` at batch 4 x 128 (host clock around each
synchronized step; the first includes the kernels' build), then
``--profiled`` steps under ``torch.profiler``: each one's wall ms, the
device's busy ms (the union of its kernels' and copies' intervals), idle
share (1 - busy / wall), its device kernels and the flash backward's
device ms.  Over every step it also sums the host time spent inside the
flash wrappers (``ops._flash_forward`` and ``ops.flash_attention_bwd``:
argument checks, allocations and the launch call; they do not wait for the
card) and prints it per call.  ``--src`` puts that tree's ``src`` first on
``sys.path`` before ``repro_torch`` is imported (its kernels are built
into that tree's ``build/``); the default is this file's own tree.
"""
import argparse
import json
import re
import sys
import time
from pathlib import Path

import torch

# the backward kernel's passes in either design (bwd_*: the tensor-core
# kernels; stats/dkdv/dq: the CUDA-core kernels before them)
FLASH_BWD = re.compile(r"\b(bwd_\w+|stats|dkdv|dq)_kernel\b")


def busy_ms(events) -> float:
    """Milliseconds in which at least one device kernel or copy ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def host_timed(ops, name: str, acc: dict) -> None:
    """Replace ``ops.<name>`` by a wrapper adding its host seconds and
    calls to ``acc[name]`` (the module looks its functions up at call time,
    so the autograd function's calls go through it too)."""
    fn = getattr(ops, name)
    acc[name] = [0.0, 0]

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name][0] += time.perf_counter() - t0
            acc[name][1] += 1
    setattr(ops, name, wrapped)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, schedules

    dev = torch.device("cuda", 0)
    cfg = configs.get(args.arch)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)
    opt = adamw(schedules.warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    shape = configs.InputShape("step", 128, 4, "train")
    batches = []
    for i in range(2):
        b = configs.make_batch(cfg, shape, seed=1 + i, device=dev)["batch"]
        b["labels"] = torch.roll(b["tokens"], -1, dims=1)
        batches.append(b)
    host: dict = {}
    host_timed(ops, "_flash_forward", host)
    host_timed(ops, "flash_attention_bwd", host)

    res = {"label": args.label, "arch": args.arch, "step_s": [], "profiled": []}
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batches[i % 2])
        torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        print(f"[{args.label}] step {i}: {res['step_s'][-1]:.4f} s, loss {float(loss):.4f}",
              flush=True)
    for i in range(args.profiled):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batches[i % 2])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = prof.events()
        busy = busy_ms(events)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        bwd = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels
                  if FLASH_BWD.search(e.key)) / 1e3
        row = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
               "kernels": sum(e.count for e in kernels), "flash_bwd_ms": bwd}
        res["profiled"].append(row)
        print(f"[{args.label}] profiled step {i}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle {100 * row['idle_share']:.1f} %, {row['kernels']} "
              f"kernels, flash backward {bwd:.2f} ms", flush=True)
    res["flash_host_us_per_call"] = {k: 1e6 * s / max(n, 1) for k, (s, n) in host.items()}
    res["flash_calls"] = {k: n for k, (_, n) in host.items()}
    print(f"[{args.label}] host time inside the flash wrappers per call (us): "
          + ", ".join(f"{k} {v:.1f} ({res['flash_calls'][k]} calls)"
                      for k, v in res["flash_host_us_per_call"].items()), flush=True)
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
