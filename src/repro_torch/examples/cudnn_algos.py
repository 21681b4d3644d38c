"""Which convolution algorithm parts the lockstep ("vmap") rows from the
per-row ("map") ones at the CINIC-10 width, and by how much.

  PYTHONPATH=src python -m repro_torch.examples.cudnn_algos [--rows 4] [--batch 20]

For each 3x3 SAME convolution of ``cinic_cnn(10, 32, 3, 32)`` (3->32 and
32->32 at 32x32, 32->64 and 64->64 at 16x16) it runs, on the card in
fp32 (TF32 off):

* ``vmap``: ``torch.func.vmap`` of ``F.conv2d`` over ``--rows`` mediator
  rows with their own weights -- what the engine's lockstep rows lower to
  (one grouped convolution);
* ``map``: one ``F.conv2d`` per row, as the eager per-row oracle runs;

forward and backward (the input and weight gradients of ``sum(out * G)``),
under each choice torch exposes over cuDNN's algorithms: its heuristics
(the default), ``cudnn.deterministic``, ``cudnn.benchmark`` (timed
autotuning), both, and cuDNN off (ATen's own convolution).  Each result is
held against the same computation in float64 on the CPU: the largest
error over the output's scale, and the gap between ``vmap`` and ``map``.
The device kernels each call ran (``torch.profiler``) name the algorithm.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

# (C_in, C_out, H = W) of cinic_cnn(10, 32, 3, 32)'s convolutions
LAYERS = [(3, 32, 32), (32, 32, 32), (32, 64, 16), (64, 64, 16)]
MODES = {"heuristic": dict(enabled=True, deterministic=False, benchmark=False),
         "deterministic": dict(enabled=True, deterministic=True, benchmark=False),
         "benchmark": dict(enabled=True, deterministic=False, benchmark=True),
         "benchmark+deterministic": dict(enabled=True, deterministic=True, benchmark=True),
         "aten (cudnn off)": dict(enabled=False, deterministic=False, benchmark=False)}


def conv_rows(x, w, b, g, path: str):
    """Output, input gradient and weight gradient of ``rows`` convolutions:
    ``x (M, B, C, H, W)``, ``w (M, O, C, 3, 3)``, ``b (M, O)``, ``g`` the
    output gradient."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    if path == "vmap":
        out = torch.func.vmap(lambda xi, wi, bi: F.conv2d(xi, wi, bi, padding=1))(x, w, b)
    else:
        out = torch.stack([F.conv2d(x[m], w[m], b[m], padding=1) for m in range(x.shape[0])])
    dx, dw = torch.autograd.grad(out, (x, w), g)
    return out.detach(), dx, dw


def kernels_of(fn) -> list[str]:
    """The device kernels one call runs, by name, in order of first use."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names:
            names.append(e.name)
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4, help="mediator rows (gamma 4 of 16 clients)")
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cudnn_algos: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import set_fp32_precision
    set_fp32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    m, bsz = args.rows, args.batch
    rows = []
    for cin, cout, hw in LAYERS:
        x = torch.randn(m, bsz, cin, hw, hw, generator=gen, dtype=torch.float64)
        w = torch.randn(m, cout, cin, 3, 3, generator=gen, dtype=torch.float64) \
            * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn(m, cout, generator=gen, dtype=torch.float64) * 0.1
        g = torch.randn(m, bsz, cout, hw, hw, generator=gen, dtype=torch.float64)
        exact = conv_rows(x, w, b, g, "map")                      # float64 on the CPU
        card = [t.float().to(dev) for t in (x, w, b, g)]
        for mode, flags in MODES.items():
            with torch.backends.cudnn.flags(allow_tf32=False, **flags):
                res = {}
                for path in ("vmap", "map"):
                    conv_rows(*card, path)                        # benchmark's autotuning
                    got = conv_rows(*card, path)
                    res[path] = got
                    errs = [float((o.double().cpu() - e).abs().max()
                                  / e.abs().max().clamp_min(1e-300))
                            for o, e in zip(got, exact)]
                    row = {"layer": f"{cin}->{cout} {hw}x{hw}", "mode": mode, "path": path,
                           "err_out": errs[0], "err_dx": errs[1], "err_dw": errs[2],
                           "kernels": kernels_of(lambda: conv_rows(*card, path))}
                    rows.append(row)
                gap = [float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                       for a, c in zip(res["vmap"], res["map"])]
                rows[-2]["gap_to_map"] = gap
        for r in rows[-2 * len(MODES):]:
            gap = r.get("gap_to_map")
            print(f"{r['layer']:14s} {r['mode']:24s} {r['path']:4s} err/scale out "
                  f"{r['err_out']:.2e} dx {r['err_dx']:.2e} dw {r['err_dw']:.2e}"
                  + (f"  vmap-map gap out {gap[0]:.2e} dx {gap[1]:.2e} dw {gap[2]:.2e}"
                     if gap else ""), flush=True)
            print(f"{'':14s} {'':24s} {'':4s} kernels: {'; '.join(k[:60] for k in r['kernels'])}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
