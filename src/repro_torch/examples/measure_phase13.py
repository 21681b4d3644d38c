"""``chip_smoke.py``'s phase 13 alone on the card: the step-cost counter on
a qwen3-4b AdamW step against the dry run's meta count, the quickstart
twin, and the dry runs of the two largest models.

  python3 src/repro_torch/examples/measure_phase13.py

Builds the kernels, builds qwen3-4b at full width (bf16, weights from seed
0) and warms it with one AdamW step at 4 x 128 as phase 11 does, then runs
``counted_step`` and ``phase13``.  Prints the card's name and power limit
first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, schedules

    if not torch.cuda.is_available():
        print("measure_phase13: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t_start = time.perf_counter()
    build.build([])
    build.library()
    dev = torch.device("cuda")
    cfg = configs.get(cs.TRAIN_ARCH)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)
    b = configs.make_batch(cfg, configs.InputShape("phase11", 128, 4, "train"), seed=1,
                           device=dev)["batch"]
    b["labels"] = torch.roll(b["tokens"], -1, dims=1)
    opt = adamw(schedules.warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    steps.make_train_step(model, opt)(params, state, b)       # warm, as phase 11
    del state, opt
    torch.cuda.empty_cache()
    laps: dict[str, float] = {}

    def lap(name: str) -> None:
        laps[name] = time.perf_counter() - t_start - sum(laps.values())
        print(f"[time] {name}: {laps[name]:.1f} s", flush=True)

    lap("build, model, warm step")
    path_launches: dict = {}
    counted = cs.counted_step(dev, cfg, model, params, b, path_launches)
    lap("13 (a) counted step")
    del model, params
    torch.cuda.empty_cache()
    cs.phase13(dev, counted, path_launches, lap)
    print(f"[time] phase 13: {sum(v for k, v in laps.items() if k.startswith('13')):.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
