"""A full-width training step with and without ``ArchConfig.remat``, in
turns, on the card.

  python3 src/repro_torch/examples/remat_step.py [--arch qwen3-4b] [--seqs 128,1024]

For each sequence length (batch ``--batch``) one model is built (bf16,
weights from seed 0) and trained under remat off and on in the order
``--order`` (off,on,on,off by default), a fresh AdamW state a turn: each
turn's seconds a step (host clock between device syncs; the first step
builds the library's plans), its flash and SSD launches a step, the
peak bytes of the whole step (``max_memory_allocated``: parameters,
moments, gradients and the update's temporaries included) and of its
forward and backward alone (``step.grad_of``), where remat keeps one
input a layer instead of every activation.  Prints the card's name and
power limit, then one JSON line a turn.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def turn(model, cfg, params, batch, remat: bool, steps_n: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, schedules
    model.cfg = dataclasses.replace(cfg, remat=remat)
    opt = adamw(schedules.warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, grads = step.grad_of(params, batch)
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated()
    del grads
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    secs = []
    for _ in range(steps_n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = {"remat": remat, "s_per_step": secs, "loss": float(loss),
           "step_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grad_peak_gb": grad_peak / 1e9,
           "launches_per_step": {k: v / steps_n for k, v in ops.LAUNCHES.items() if v}}
    del state, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqs", default="128,1024")
    ap.add_argument("--order", default="off,on,on,off")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    from repro_torch import configs, resolve_device
    from repro_torch.models import transformer as T
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = resolve_device()
    cfg = configs.get(args.arch)
    for seq in (int(s) for s in args.seqs.split(",")):
        model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        params = T.train_params(model)
        shape = configs.InputShape("remat", seq, args.batch, "train")
        batch = configs.make_batch(cfg, shape, seed=1, device=dev)["batch"]
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        for which in args.order.split(","):
            row = turn(model, cfg, params, batch, which == "on", args.steps)
            print(json.dumps({"arch": args.arch, "batch": args.batch, "seq": seq, **row}),
                  flush=True)
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
