#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the three CUDA kernels with ``nvcc`` for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at a large one, with CUDA-event times of the
   kernel, the plain version and a one-call PyTorch yardstick, beside the
   least time the card could take (H100 SXM peaks);
4. agreement: a small Astraea run on the card against the same run on the
   CPU (plain versions), same params and draws;
5. main path: FedAvg then Astraea at the paper's EMNIST width (68,873
   parameters), 3 rounds each, with every kernel launch count reset just
   before and read just after; the WAN ledger must equal the CommMeter
   formula and accuracy must be finite.

Prints the kernels' JSON summary, then as the last line
``{"ok": true, "device": {...}}``.  Full results go to
``build/chip_smoke.json``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FED_KW = dict(num_clients=64, total_samples=6400, test_samples=2350,
              sizes="instagram", global_dist="letterfreq", local="random",
              seed=0)
CLIENTS, GAMMA, ROUNDS, ALPHA = 16, 4, 3, 0.67


def log(*a):
    print(*a, flush=True)


def time_ms(fn, min_ms: float = 50.0, max_reps: int = 4096) -> float:
    """Mean device time of ``fn`` over enough back-to-back calls to span
    ``min_ms`` (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
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


def device_ms(fn, event_ms: float) -> float | None:
    """Mean device time per call of the kernels ``fn`` launches, summed,
    from ``torch.profiler`` (CUPTI): the kernel work without the host's
    dispatch cost.  None if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    calls = max(1, min(20, int(200.0 / max(event_ms, 1e-3))))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / calls / 1e3 if total_us > 0 else None


def timed(row: dict, **fns) -> dict:
    """Add ``<name>`` (CUDA-event ms per call, host dispatch included) and
    ``<name>_device`` (profiler device ms) for each callable."""
    for name, (fn, min_ms) in fns.items():
        row[name] = time_ms(fn, min_ms=min_ms)
        row[name.replace("ms", "device_ms")] = device_ms(fn, row[name])
    return row


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------- phase 3

def check_fedavg(dev, m, n, dtype, gen):
    from repro_torch.kernels import ops, ref
    d = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    w = torch.rand(m, generator=gen, device=dev) * 100 + 1
    w[-1] = 0.0                                   # a dummy (zero-weight) row
    out, plain = ops.fedavg_agg(d, w), ref.fedavg_agg(d, w)
    err = float((out.double() - plain.double()).abs().max())
    scale = float(plain.double().abs().max())
    # fp32: sums in another order, |err| <= 1e-5 of the output's scale;
    # bf16: the two fp32 sums may round to neighbouring bf16 values (2^-7)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(scale, 1.0)
    if not err <= tol:
        raise AssertionError(f"fedavg_agg M={m} N={n} {dtype}: err {err} > {tol}")
    wn = ref.normalized_weights(w).to(dtype)
    esize = d.element_size()
    b_ms, by = bound(m * n * esize + m * 4 + n * esize, 2 * m * n)
    return timed({"shape": f"M={m} N={n} {str(dtype).split('.')[-1]}",
                  "max_abs_err": err, "tol": tol, "bound_ms": b_ms, "bound_by": by},
                 ms=(lambda: ops.fedavg_agg(d, w), 50.0),
                 plain_ms=(lambda: ref.fedavg_agg(d, w), 50.0),
                 library_ms=(lambda: wn @ d, 50.0))


def check_greedy(dev, counts_np, gamma):
    from repro_torch.core import scheduling
    from repro_torch.kernels import ops, ref
    counts = torch.as_tensor(counts_np, dtype=torch.float32, device=dev)
    kp = ops.kld_greedy_picks(counts, gamma).cpu().numpy()
    pp = ref.kld_greedy_picks(counts, gamma).cpu().numpy()
    if sorted(kp.tolist()) != list(range(len(kp))):
        raise AssertionError("kld_greedy_picks is not a permutation")
    div = scheduling.first_divergence(counts_np, gamma, pp, kp)
    # picks must be equal; they may differ only where the two candidates'
    # float64 scores tie (to 1e-9 relative)
    if div is not None and not div["tie"]:
        raise AssertionError(f"kld_greedy_picks disagrees: {div}")
    k, c = counts_np.shape
    err = 0.0 if div is None else abs(div["score_a"] - div["score_b"])
    # data-dependent work: step s scores the K - s unpicked clients, ~8 f32
    # operations per class (merge, total, divide, clamp, log, subtract,
    # multiply, accumulate)
    scorings = k * (k + 1) // 2
    b_ms, by = bound(k * c * 4 + k * 4, 8.0 * scorings * c)
    row = timed({"shape": f"K={k} C={c} gamma={gamma}", "max_abs_err": err,
                 "first_divergence": div, "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.kld_greedy_picks(counts, gamma), 50.0),
                plain_ms=(lambda: ref.kld_greedy_picks(counts, gamma), 1.0))
    row["library_ms"] = row["library_device_ms"] = None
    return row


def check_warp(dev, b, h, w, c, gen):
    from repro_torch.core.augmentation import affine_from_uniform
    from repro_torch.kernels import ops, ref
    imgs = torch.randn(b, h, w, c, generator=gen, device=dev)
    u = torch.rand(b, 6, generator=gen, device=dev)
    mats, trans = affine_from_uniform(u)
    mats, trans = mats.contiguous(), trans.contiguous()
    out, plain = ops.affine_warp(imgs, mats, trans), ref.affine_warp(imgs, mats, trans)
    err = float((out - plain).abs().max())
    if not err <= 1e-5:          # same op order, no FMA: ulp-level only
        raise AssertionError(f"affine_warp B={b} {h}x{w}x{c}: err {err} > 1e-5")
    # yardstick: grid_sample on the same inverse map (align_corners=True
    # puts -1/+1 on the edge pixel centres, the warp's convention)
    sy, sx = ref.warp_coords(h, w, mats, trans)
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    nchw = imgs.permute(0, 3, 1, 2).contiguous()
    gs = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=True).permute(0, 2, 3, 1)
    pix = b * h * w
    b_ms, by = bound(2 * pix * c * 4 + b * 6 * 4, pix * (20 + 8 * c))
    return timed({"shape": f"B={b} {h}x{w}x{c}", "max_abs_err": err,
                  "grid_sample_err": float((gs - plain).abs().max()),
                  "bound_ms": b_ms, "bound_by": by},
                 ms=(lambda: ops.affine_warp(imgs, mats, trans), 50.0),
                 plain_ms=(lambda: ref.affine_warp(imgs, mats, trans), 50.0),
                 library_ms=(lambda: F.grid_sample(
                     nchw, grid, mode="bilinear", padding_mode="zeros",
                     align_corners=True), 50.0))


# ---------------------------------------------------------------- phases 4-5

class _DrawsOn:
    """CPU-seeded draws moved to ``device``: the same numbers on both sides
    of the agreement check."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def client(self, *address):
        return _DrawsOn(self.inner.client(*address), self.device)

    def permutation(self, epoch, n):
        return self.inner.permutation(epoch, n).to(self.device)

    def keep_masks(self, epoch, step, shapes):
        return [k.to(self.device) for k in self.inner.keep_masks(epoch, step, shapes)]

    def augment(self, rnd, row, slot, weights):
        return tuple(t.to(self.device) for t in
                     self.inner.augment(rnd, row, slot, weights.cpu()))


def agreement_check(dev):
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.core.draws import SeededDraws
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.models.cnn import emnist_cnn, init_params
    from repro_torch.optim import adam
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    fed = partition(spec, num_clients=12, total_samples=300, test_samples=80,
                    sizes="instagram", global_dist="letterfreq", local="random",
                    seed=0)
    init = init_params(emnist_cnn(8, 16), 0)
    runs = []
    for where in ("cpu", dev):
        tr = AstraeaTrainer(emnist_cnn(8, 16), adam(1e-3), fed, clients_per_round=8,
                            gamma=4, local=LocalSpec(10, 1), alpha=ALPHA, seed=0,
                            device=where, init_params=init,
                            draws=_DrawsOn(SeededDraws(1, "cpu"), where))
        tr.fit(2, eval_every=2)
        runs.append((tr.engine.last_groups,
                     {k: v.cpu() for k, v in tr.params.items()},
                     tr.comm.round_log))
    (g_cpu, p_cpu, l_cpu), (g_dev, p_dev, l_dev) = runs
    err = max(float((p_cpu[k] - p_dev[k]).abs().max()) for k in p_cpu)
    if g_cpu != g_dev or l_cpu != l_dev or not err <= 1e-4:
        raise AssertionError(f"card vs CPU: groups {g_dev} vs {g_cpu}, "
                             f"ledger {l_dev} vs {l_cpu}, params err {err}")
    return {"groups": g_dev, "params_max_abs_err": err, "tol": 1e-4}


def main_path(fed, dev):
    from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    local = LocalSpec(20, 2)
    n_params = 68_873
    rows = {}
    ops.reset_launches()
    for name in ("FedAvg", "Astraea"):
        if name == "FedAvg":
            tr = FedAvgTrainer(emnist_cnn(47, 28), adam(1e-3), fed,
                               clients_per_round=CLIENTS, local=local, seed=0,
                               device=dev)
        else:
            tr = AstraeaTrainer(emnist_cnn(47, 28), adam(1e-3), fed,
                                clients_per_round=CLIENTS, gamma=GAMMA,
                                local=local, mediator_epochs=1, alpha=ALPHA,
                                seed=0, device=dev)
        secs = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        m = tr.evaluate()
        m["round_seconds"] = secs
        m["pad"] = tr.engine.pad
        m["mediators"] = tr.engine.last_groups
        rows[name] = m
        if not (math.isfinite(m["accuracy"]) and math.isfinite(m["loss"])):
            raise AssertionError(f"{name}: non-finite metrics {m}")
        if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
            raise AssertionError(f"{name}: non-finite params")
        n = sum(p.numel() for p in tr.params.values())
        if n != n_params:
            raise AssertionError(f"{name}: {n} params, expected {n_params}")
        w = 4 * n_params
        if name == "FedAvg":
            expect = [w * 2 * CLIENTS * (r + 1) for r in range(ROUNDS)]
        else:
            plan_bytes = 4 * fed.num_classes * fed.num_clients
            per_round = w * (2 * CLIENTS + 2 * math.ceil(CLIENTS / GAMMA))
            expect = [plan_bytes + per_round * (r + 1) for r in range(ROUNDS)]
        if tr.comm.round_log != expect:
            raise AssertionError(f"{name}: WAN ledger {tr.comm.round_log} != {expect}")
    launches = dict(ops.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: {launches}")
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.core.augmentation import augmentation_plan
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.kernels import build

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    dev = resolve_device()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    build_log: list[str] = []
    build.build(build_log)
    build.library()
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.2f} s -> {build.library_path().name}")
    for line in "\n".join(build_log).splitlines():
        if "registers" in line or "Compiling entry" in line or "nvcc" in line:
            log(f"[build]   {line.strip()}")

    # the main path's federation (its pad sets the warp's batch)
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=47), **FED_KW)
    sizes = [x.shape[0] for x in fed.client_images]
    pad = -(-max(sizes) // 20) * 20

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    checks = {"fedavg_agg": [], "kld_greedy_picks": [], "affine_warp": []}
    for m in (16, 4):
        for dt in (torch.float32, torch.bfloat16):
            checks["fedavg_agg"].append(
                check_fedavg(dev, m, 68_873, dt, gen))
    checks["fedavg_agg"].append(check_fedavg(dev, 16, 2 ** 24, torch.float32, gen))
    # Astraea's first cohort as the engine schedules it: the selection of
    # default_rng(seed).choice, at the expected post-augmentation counts
    counts = fed.client_counts()
    sel = np.random.default_rng(0).choice(64, CLIENTS, replace=False)
    main_counts = counts[sel] * (1.0 + augmentation_plan(counts.sum(0), ALPHA))
    checks["kld_greedy_picks"].append(check_greedy(dev, main_counts, GAMMA))
    checks["kld_greedy_picks"].append(check_greedy(
        dev, rng.integers(0, 200, (4096, 47)), GAMMA))
    checks["kld_greedy_picks"].append(check_greedy(
        dev, np.tile(rng.integers(1, 50, (1, 47)), (4096, 1)), GAMMA))
    checks["affine_warp"].append(check_warp(dev, CLIENTS * pad, 28, 28, 1, gen))
    checks["affine_warp"].append(check_warp(dev, 4096, 32, 32, 3, gen))
    def fmt(x):
        return "n/a" if x is None else f"{x:.4f}"
    log("[kernel] times in ms per call: CUDA events (device time from the profiler)")
    for name, rows in checks.items():
        for r in rows:
            log(f"[kernel] {name:17s} {r['shape']:24s} err {r['max_abs_err']:.3e} "
                f"kernel {fmt(r['ms'])} ({fmt(r['device_ms'])})  "
                f"plain {fmt(r['plain_ms'])} ({fmt(r['plain_device_ms'])})  "
                f"library {fmt(r['library_ms'])} ({fmt(r['library_device_ms'])})  "
                f"bound {r['bound_ms']:.4f} ({r['bound_by']})")

    # ---- 4. card vs CPU on a small Astraea run
    agree = agreement_check(dev)
    log(f"[agree] card vs CPU Astraea (8 classes, 16px, 2 rounds): params "
        f"max abs err {agree['params_max_abs_err']:.3e}, schedules equal")

    # ---- 5. the main path at full width
    rows, launches = main_path(fed, dev)
    log(f"[main] launches {launches}")
    log(f"\n{'method':10s} {'top1':>7s} {'loss':>7s} {'traffic MB':>11s} "
        f"{'s/round':>8s}")
    for name, m in rows.items():
        log(f"{name:10s} {m['accuracy']:7.4f} {m['loss']:7.4f} "
            f"{m['traffic_mb']:11.3f} {np.mean(m['round_seconds']):8.3f}")

    source = {"fedavg_agg": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
              "kld_greedy_picks": "src/repro_torch/kernels/csrc/kld_greedy.cu",
              "affine_warp": "src/repro_torch/kernels/csrc/affine_warp.cu"}
    replaces = {"fedavg_agg": "src/repro/kernels/fedavg_agg.py:68",
                "kld_greedy_picks": "src/repro/kernels/kld_score.py:215",
                "affine_warp": "src/repro/kernels/affine_warp.py:82"}
    summary = []
    for name, rs in checks.items():
        r = rs[0]                      # the main path's shape
        summary.append({"name": name, "route": "cuda", "source": source[name],
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"], "shape": r["shape"]})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, "build_seconds": build_s,
         "checks": checks, "agreement": agree, "main_path": rows,
         "launches": launches, "kernels": summary}, indent=1, default=str))
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
