"""Serve chosen rows of ``chip_smoke.py``'s ``SERVE_RUNS`` on the card,
each after its reduced config's card-against-CPU agreement: phases 8 and 9
for those models alone, without the rest of the smoke script.

  python3 src/repro_torch/examples/serve_runs.py [--arch granite-moe-3b-a800m,whisper-base]

Builds the kernels, then per model: ``serve_agreement`` on its reduced
config (at the standard fan-in for ``FAN_IN_ARCHS``, as phase 8 holds
them), ``serve_path`` at full width (launch counts checked, prefill s,
decode ms/token, peak GB and a profile of both phases) and
``hold_unchecked`` for every kernel signature the run called.  Default:
the MoE, VLM and audio rows.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m,internvl2-1b,whisper-base",
                    help="comma-separated ids of SERVE_RUNS")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("serve_runs: no CUDA device available", file=sys.stderr)
        return 2
    runs = {run[0]: run for run in cs.SERVE_RUNS}
    archs = args.arch.split(",")
    unknown = [a for a in archs if a not in runs]
    if unknown:
        raise SystemExit(f"not in SERVE_RUNS: {unknown}")
    build.build([])
    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"flash_attention": [], "ssd_chunk": [], "ssd_chunk_bwd": []}
    for arch in archs:
        t0 = time.perf_counter()
        a = cs.serve_agreement(dev, configs.reduced(configs.get(arch)),
                               fan_in=arch in cs.FAN_IN_ARCHS)
        print(f"[agree] reduced {arch}: logits max rel err {a['max_rel_err']:.3e} "
              f"(tol {a['tol_rel']}), {time.perf_counter() - t0:.1f} s", flush=True)
        r, seen = cs.serve_path(dev, *runs[arch])
        pf, dc = r["profile"]["prefill"], r["profile"]["decode"]
        print(f"[serve] {arch}: prefill {r['prefill_s']:.3f} s (warm {pf['wall_ms']:.1f} ms, "
              f"busy {pf['device_busy_ms']:.1f} ms, idle {100 * pf['idle_share']:.1f} %), "
              f"decode {r['decode_ms_per_token']:.2f} ms/token (idle "
              f"{100 * dc['idle_share']:.1f} %, {dc['kernel_launches_per_token']:.0f} "
              f"kernels), peak {r['peak_mem_gb']:.2f} GB; flash {pf['flash_device_ms']:.2f} "
              f"ms of the prefill", flush=True)
        for name, ms, calls in pf["top_kernels"]:
            print(f"   prefill {ms:9.3f} ms {calls:5d}x {name[:100]}")
        for name, ms, calls in dc["top_kernels"]:
            print(f"   decode  {ms:9.3f} ms {calls:5d}x {name[:100]}")
        cs.hold_unchecked(dev, gen, seen, checks, f"serve {arch}")
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
