"""Async waves spread over processes (``ProcessWaveDispatcher``).

Every process builds the same federation, trainer and draws from the same
seeds and runs ``ROUNDS`` overlapped async rounds at S=0, a wave per
mediator behind a lognormal straggler fleet, then flushes.  The owner of
wave ``(r, w)`` (``(r + w) % P``) trains it and publishes its rows through
the run's ``TCPStore``; the others receive them.  Every process folds every
wave, so the committed params must be bit for bit equal across processes
and to a single-process run of the same workload, and every per-key WAN
ledger total equal.  Each process checks the first two against rank 0
through the store; the caller compares with its own single-process run.

  # one process (the single-process run)
  PYTHONPATH=src python -m repro_torch.examples.distributed_waves --device cpu
  # process i of two, against a store at 127.0.0.1:29500 (rank 0 hosts it)
  PYTHONPATH=src python -m repro_torch.examples.distributed_waves --device cpu \\
      --coordinator 127.0.0.1:29500 --num-processes 2 --process-id i --out r{i}.npz

``--model-parallel 2`` runs the workload a second time on each process's
``process_local_mesh(model=2)`` (two model positions on its device; on the
card ``tp_rows="auto"`` trains TP rows), through a second dispatcher
namespace, and reports that run's params and ledger too.

Arms: ``tiny`` (12 clients, 8 classes, 16 px, c=6, gamma=3, B=10, E=1, no
Alg. 2, ``"map"``: the JAX package's two-process smoke workload) and
``emnist`` (64 clients, 47 classes, 28 px, c=16, gamma=4, B=20, E=2, alpha
0.67 online, ``"vmap"``: the EMNIST arm of ``chip_smoke.py``).  ``main``
puts cuDNN on its deterministic algorithms, so two runs on the card can be
held bit for bit (a caller of ``run_waves`` on the card does the same).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

ROUNDS = 2
ARMS = ("tiny", "emnist")


def federation(arm: str):
    from repro_torch.data.federated import EMNIST_LIKE, partition
    if arm == "tiny":
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
        return partition(spec, num_clients=12, total_samples=600, test_samples=160,
                         sizes="instagram", global_dist="letterfreq", local="random",
                         seed=0)
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=47)
    return partition(spec, num_clients=64, total_samples=6400, test_samples=2350,
                     sizes="instagram", global_dist="letterfreq", local="random", seed=0)


def trainer(arm: str, fed, device, **kw):
    """The arm's Astraea trainer (its own rounds synchronous: the caller
    wraps its engine in the async runner)."""
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    if arm == "tiny":
        return AstraeaTrainer(emnist_cnn(8, 16), adam(1e-3), fed, clients_per_round=6,
                              gamma=3, local=LocalSpec(10, 1), alpha=None, aug_mode=None,
                              seed=0, device=device, row_exec="map", **kw)
    return AstraeaTrainer(emnist_cnn(47, 28), adam(1e-3), fed, clients_per_round=16,
                          gamma=4, local=LocalSpec(20, 2), alpha=0.67, seed=0,
                          device=device, **kw)


def run_waves(arm: str, device, dispatcher=None, rounds: int = ROUNDS,
              mesh=None) -> dict:
    """The workload: ``rounds`` overlapped S=0 async rounds and a flush
    (on ``mesh``, if given: a process-local mesh with a model axis, say).
    Returns the runner, each round's seconds (host clock between device
    syncs) and the FL kernels' launches over the rounds."""
    from repro_torch.core import AsyncRoundEngine, AsyncSpec, StragglerSpec
    from repro_torch.kernels import ops
    device = torch.device(device)
    on_card = device.type == "cuda"
    tr = trainer(arm, federation(arm), device, mesh=mesh)
    spec = AsyncSpec(staleness_bound=0, wave_size=1, dispatch="overlapped",
                     straggler=StragglerSpec(model="lognormal", seed=3))
    runner = AsyncRoundEngine(tr.engine, spec, dispatcher=dispatcher)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    ops.reset_launches()
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        runner.run_round()
        sync()
        secs.append(time.perf_counter() - t0)
    runner.flush()
    sync()
    launches = {k: ops.LAUNCHES[k] for k in ("fedavg_agg", "kld_greedy_picks", "affine_warp")}
    return {"runner": runner, "params": tr.engine.params, "round_seconds": secs,
            "launches": launches}


def summary(res: dict) -> dict:
    """What a process reports: params as numpy by name, the ledger, the
    commit log."""
    runner = res["runner"]
    return {"params": {k: v.detach().cpu().numpy() for k, v in res["params"].items()},
            "ledger": runner.engine.comm.ledger_totals(),
            "commit_log": runner.commit_log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arm", choices=ARMS, default="tiny")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--coordinator", default=None, help="host:port of the run's TCPStore")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="above 1: run the workload again on a process-local mesh with "
                         "this model axis")
    ap.add_argument("--out", default=None,
                    help="write this process's params, ledger and counters here (.npz)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.backends.cudnn.deterministic = True       # runs held to each other bit for bit

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import (ProcessWaveDispatcher, init_distributed,
                                         process_local_mesh)
    joined = init_distributed(args.coordinator, args.num_processes, args.process_id)
    device = process_local_mesh(device=args.device).devices[0]
    passes = [("", None, "astraea")]
    if args.model_parallel > 1:
        passes.append(("model_", process_local_mesh(args.model_parallel, device=device),
                       f"astraea-model{args.model_parallel}"))
    report, arrays, failures = {}, {}, []
    for prefix, mesh, namespace in passes:
        disp = ProcessWaveDispatcher(timeout_s=120, namespace=namespace) if joined else None
        res = run_waves(args.arm, device, disp, args.rounds, mesh=mesh)
        out = summary(res)
        rank = disp.process_index if disp else 0
        names = sorted(out["params"])
        keys = sorted(out["ledger"])
        ledger = np.asarray([out["ledger"][k] for k in keys], np.float64)
        if disp is not None:
            # every process against rank 0, through the store
            disp.publish(f"params-{rank}", [out["params"][k] for k in names] + [ledger])
            disp.barrier("results")
            ref = disp.receive("params-0")
            if not all(np.array_equal(out["params"][k], r) for k, r in zip(names, ref)):
                failures.append(f"{prefix}params differ from rank 0's")
            if not np.array_equal(ledger, ref[-1]):
                failures.append(f"{prefix}ledger differs from rank 0's")
            if not (disp.num_published > 0 and disp.num_received > 0):
                failures.append(f"{prefix}no wave crossed the process boundary")
            disp.barrier("done")
        part = {"round_seconds": res["round_seconds"], "launches": res["launches"],
                "num_published": disp.num_published if disp else 0,
                "num_received": disp.num_received if disp else 0,
                "commits": res["runner"].num_commits,
                "model_axis": res["runner"].engine.store.stats()["model_axis"],
                "tp_rows": res["runner"].engine._tp_rows}
        if prefix:
            report["model_axis_run"] = part
        else:
            report.update(rank=rank, device=str(device), **part)
        arrays.update({f"{prefix}names": np.asarray(names),
                       f"{prefix}ledger_keys": np.asarray(keys), f"{prefix}ledger": ledger,
                       f"{prefix}commit_log": np.asarray(json.dumps(out["commit_log"])),
                       **{f"{prefix}p_{i}": out["params"][k] for i, k in enumerate(names)}})
    report.update(nvcc_builds=build.NUM_BUILDS, failures=failures)
    print(json.dumps(report), flush=True)
    if args.out:
        np.savez(args.out, report=np.asarray(json.dumps(report)), **arrays)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
