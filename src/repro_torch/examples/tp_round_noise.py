"""How far a bf16 federated round moves under rounding noise, beside its
tensor-parallel copy.

``chip_smoke.py`` phase 11's round of ``--arch`` at full width (bf16,
weights from seed 0; with ``--fan-in`` the stacked layer matrices at the
standard fan-in) over the 2 mediators Alg. 3 makes of 8 synthetic clients
(4 steps of 1 x 128 each, SGD at 5e-4), full-delta or with ``--lora-rank``
over an adapter state, three times:

* at t=1;
* at t=1 from a start with one bf16 ulp added to every 100th element of
  one weight (``--leaf``; by default layer 0's first projection), the
  rounding noise of a round;
* at t=2, tensor-parallel over two logical positions of the card.

Each round's update (new - start, fp32) is read against the first's in L2
relative to it: a no-op round reads 1.  Where a round moves its bf16
leaves by less than an ulp, the noise run reads near the TP run, and a
bf16 round cannot tell a TP error from rounding.

  python3 src/repro_torch/examples/tp_round_noise.py --arch mamba2-370m
  python3 src/repro_torch/examples/tp_round_noise.py --arch hymba-1.5b --fan-in --lora-rank 16

Needs a CUDA device; prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch import configs  # noqa: E402
from repro_torch.core import scheduling  # noqa: E402
from repro_torch.launch import fl_train, steps  # noqa: E402
from repro_torch.launch.mesh import make_fl_mesh  # noqa: E402
from repro_torch.models import lora  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CLIENTS, GAMMA, SEQ, LR = 8, 4, 128, 5e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m", choices=configs.ARCH_IDS)
    ap.add_argument("--fan-in", action="store_true")
    ap.add_argument("--lora-rank", type=int, default=None)
    ap.add_argument("--leaf", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = configs.get(args.arch)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if args.fan_in:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("layers.") and p.dim() >= 2:
                    p.mul_(math.sqrt(cfg.n_layers / p.shape[-2]))
    params = T.train_params(model)
    base = configs.get("qwen3-4b").vocab
    streams, counts = fl_train.synth_client_streams(
        torch.Generator(device=dev).manual_seed(1), CLIENTS, base, SEQ)
    meds = scheduling.reschedule(counts, gamma=GAMMA, device=dev)
    streams = [t * cfg.vocab // base for t in streams]
    tokens, labels, w, per_med = fl_train.pack_mediators(meds, streams, counts, SEQ, 2)
    leaf = args.leaf or ("layers.0.ssm.in_proj" if cfg.arch_type == "ssm"
                         else "layers.0.attn.wq")
    nudged = dict(params)
    nudged[leaf] = params[leaf].clone()
    flat = nudged[leaf].view(-1)
    flat.view(torch.int16)[::100] += 1          # one bf16 ulp, away from zero
    mesh = make_fl_mesh(mediator=1, model=2, devices=(dev, dev))
    kw = dict(learning_rate=LR, local_steps=per_med)
    if args.lora_rank is None:
        start = params

        def run(p, m=None):
            return steps.make_fl_round(model, 2, mesh=m, **kw)(p, tokens, labels, w)
    else:
        mapping = T.adapter_mapping(cfg, args.lora_rank)
        a_tree = lora.init_adapter_A(lora.A_SALT, mapping, dev)
        start = lora.init_adapter_state(mapping, params)

        def run(p, m=None):
            fl = steps.make_fl_round(model, 2, mesh=m, lora_mapping=mapping, **kw)
            return fl(p, a_tree, start, tokens, labels, w)
    one = run(params)

    def rel(out):
        err = norm = 0.0
        for k, s in start.items():
            d1 = one[k].float() - s.float()
            err += float((out[k].float() - s.float() - d1).square().sum())
            norm += float(d1.square().sum())
        return (err / norm) ** 0.5
    noise = rel(run(nudged))
    tp = rel(run(params, mesh))
    out = {"card": card, "arch": args.arch, "lora_rank": args.lora_rank,
           "fan_in": args.fan_in, "leaf": leaf, "noise_rel_l2": noise, "tp_rel_l2": tp,
           "t1_largest_update": max(float((one[k].float() - s.float()).abs().max())
                                    for k, s in start.items())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
