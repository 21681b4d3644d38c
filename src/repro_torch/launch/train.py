"""Training launcher for the port's zoo: AdamW on random token streams.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

The reduced (CPU smoke) variant of ``--arch`` by default, as the reference's
``repro.launch.train``; ``--full-config`` trains the published widths (on
the card: qwen3-4b needs ~8 GB of bf16 weights, 8 GB of gradients and 16 GB
of AdamW moments).  ``--ckpt`` writes ``{"params", "step"}`` in the
reference's checkpoint format (the parameters with stacked layers).  The
``ssm`` and ``hybrid`` families train on the card too (``--arch
mamba2-370m``, ``--arch hymba-1.5b``): ``--seq`` a multiple of their
chunk of 64.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step, suggest_microbatches
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedules


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=C.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="train the full config instead of the reduced one")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = C.get(args.arch)
    if not args.full_config:
        cfg = C.reduced(cfg)
    dev = resolve_device(args.device)
    shape = C.InputShape("cli", args.seq, args.batch, "train")

    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)
    n_params = sum(p.numel() for p in params.values())
    # gradient accumulation when the saved activations would pass ~4 GB
    microbatches = suggest_microbatches(cfg, args.batch, args.seq)
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M seq={args.seq} batch={args.batch} "
          f"microbatches={microbatches}")

    opt = adamw(schedules.warmup_cosine(args.lr, 10, max(args.steps, 20)))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=microbatches)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = C.make_batch(cfg, shape, seed=1 + step, device=dev)["batch"]
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:8.4f}  "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
        if not math.isfinite(losses[-1]):
            raise RuntimeError("training diverged")

    if args.ckpt:
        from repro_torch.checkpoint import save_pytree
        from repro_torch.convert import transformer_params_to_jax
        save_pytree(args.ckpt, {"params": transformer_params_to_jax(params),
                                "step": args.steps})
        print("saved", args.ckpt)
    return {"losses": losses, "params": n_params, "microbatches": microbatches}


if __name__ == "__main__":
    main()
