"""Where a round's time goes on the card, per trainer and per row
execution, at the paper's EMNIST width, or with ``--cinic`` at its
CINIC-10 width (``cinic_cnn``, 32x32x3, width 32).

  PYTHONPATH=src python -m repro_torch.examples.profile_round [--cinic] \\
      [--rounds 3] [--order map,vmap,vmap,map] [--out DIR] \\
      [--devices cuda:0,cuda:1,cuda:2,cuda:3 [--store sharded]]

For each trainer (FedAvg, Astraea) and each ``row_exec`` in ``--order``
(a fresh trainer each, from the same seed): one warm-up round (the
kernels' build, cuDNN's plans and, under ``"vmap"``, the round graph's
capture), ``--rounds`` timed rounds (host clock around synchronized
rounds), then one round under ``torch.profiler``.  Prints, per run: the
seconds of each timed round, ``num_round_traces``, and from the profiled
round its wall seconds, the device's busy seconds (the union of its
kernels' and copies' intervals) and idle share (1 - busy / wall), the
summed time of all kernels and copies, the host's launch calls (kernels
and graphs), the device kernels, and the top kernels by device time.
``--out`` also writes each profiled round's Chrome trace there.
``--devices`` trains on an ``n x 1`` ``(mediator, model)`` mesh of those
positions, each mediator row's rows on its own (``cuda:0`` four times:
four logical positions of one card), over ``--store``; the clock and
the profile then wait on every visible card, and device busy is the
union over the cards.
"""
import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
from repro_torch.examples.astraea_vs_fedavg import configuration
from repro_torch.launch.mesh import make_fl_mesh
from repro_torch.optim import adam

# the runtime calls that put work on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def synchronize() -> None:
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def round_seconds(trainer, rounds: int) -> list[float]:
    """Host seconds of ``rounds`` synchronized rounds."""
    out = []
    for _ in range(rounds):
        synchronize()
        t0 = time.perf_counter()
        trainer.run_round()
        synchronize()
        out.append(time.perf_counter() - t0)
    return out


def busy_seconds(events) -> float:
    """Seconds in which at least one device kernel or copy ran: the union
    of their intervals (kernels of one captured graph may overlap, so
    their summed times can exceed the wall time)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def profile_round(trainer, top: int = 12, trace: Path | None = None) -> dict:
    """One round under ``torch.profiler``: wall seconds, device busy
    seconds (``busy_seconds``) and idle share, the summed device time of
    all kernels and copies, host launch calls (kernels and graph
    launches), device kernels, the ``top`` kernels by device time, and the
    seconds the profile's analysis took (``analysis_s``)."""
    synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_round()
        synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    busy = busy_seconds(prof.events())
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {name: sum(e.count for e in events if e.key == name) for name in LAUNCH_CALLS}
    if trace is not None:
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
    analysis = time.perf_counter() - t1
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
            "analysis_s": analysis,
            "kernel_s": sum(device_us(e) for e in kernels) / 1e6,
            "host_launches": sum(calls.values()),
            "graph_launches": calls["cudaGraphLaunch"],
            "device_kernels": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:90], "count": e.count,
                     "device_ms": device_us(e) / 1e3}
                    for e in sorted(kernels, key=device_us, reverse=True)[:top]]}


def trainers(cinic: bool, row_exec: str, **kw) -> dict:
    """The two trainers of the full-width arm, both from seed 0, with the
    trainer fields ``kw`` (a mesh, a store)."""
    fed, model, c, _ = configuration(cinic, full=True)
    common = dict(clients_per_round=c, local=LocalSpec(20, 2), seed=0,
                  row_exec=row_exec, **kw)
    return {"FedAvg": lambda: FedAvgTrainer(model, adam(1e-3), fed, **common),
            "Astraea": lambda: AstraeaTrainer(model, adam(1e-3), fed, gamma=4,
                                              alpha=0.67, **common)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=3, help="timed rounds per run")
    ap.add_argument("--order", default="map,vmap,vmap,map",
                    help="row_exec of each run, in turn")
    ap.add_argument("--cinic", action="store_true", help="the CINIC-10 arm")
    ap.add_argument("--devices", default=None,
                    help="comma-separated positions of an n x 1 mesh, one a mediator row")
    ap.add_argument("--store", default="replicated", help="the client store")
    args = ap.parse_args()
    kw = {"store": args.store}
    if args.devices:
        devices = args.devices.split(",")
        kw["mesh"] = make_fl_mesh(mediator=len(devices), model=1, devices=devices)
    report = []
    for turn, row_exec in enumerate(args.order.split(",")):
        for name, make in trainers(args.cinic, row_exec, **kw).items():
            tr = make()
            t0 = time.perf_counter()
            tr.run_round()                      # warm-up (build, plans, capture)
            synchronize()
            first = time.perf_counter() - t0
            secs = round_seconds(tr, args.rounds)
            trace = None if args.out is None else \
                Path(args.out) / f"{name.lower()}_{row_exec}_{turn}.json"
            prof = profile_round(tr, args.top, trace)
            row = {"trainer": name, "row_exec": row_exec, "turn": turn,
                   "devices": args.devices, "store": args.store,
                   "first_round_s": first, "round_s": secs,
                   "num_round_traces": tr.engine.num_round_traces, **prof}
            report.append(row)
            print(f"{name:8s} {row_exec:5s} turn {turn}: first {first:.3f} s, rounds "
                  f"{' '.join(f'{s:.4f}' for s in secs)} s, traces "
                  f"{row['num_round_traces']}; profiled {prof['wall_s']:.4f} s wall, "
                  f"{prof['busy_s']:.4f} s device busy, idle {100 * prof['idle_share']:.1f} %, "
                  f"{prof['kernel_s']:.4f} s summed kernel time, "
                  f"{prof['host_launches']} host launches ({prof['graph_launches']} "
                  f"graphs), {prof['device_kernels']} device kernels", flush=True)
            del tr
            torch.cuda.empty_cache()
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
