"""The dry run: every (arch x input shape x production mesh) on the meta
device -- shapes, memory and counted costs, no card and no computation
(``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # 2 x 16 x 16

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The model is built on meta and its step -- the train step, or a prefill
or decode step, or with ``fl_round`` one Astraea round of
``launch/steps.py::make_fl_round`` under ``model_only_rules`` -- runs on
meta under the step-cost counter (``roofline/counts.py``), on the rows one
data shard holds.  A train step's microbatches are identical: one
microbatch's forward and backward is counted and multiplied by
``suggest_microbatches``' count, then the update (clip and AdamW) is
counted once.  Per device, counted FLOPs and bytes are that divided by
the model axis (an even split of the work over it).

Each record keeps the reference's keys:

* ``params_total`` / ``params_active``;
* ``memory``: each device's parameter, gradient and optimizer bytes under
  the rule tables, exact; from the live meta bytes, an estimate of what
  the step holds beyond them at its peak -- one microbatch's activations
  and temporaries divided by the model axis, or the update's
  gradient-shaped temporaries sharded as the parameters, the larger;
  their sum ``peak_estimate_gb``;
* ``roofline`` at ``roofline.HW``'s H100 peaks, with ``collective_s``
  null: a one-process program moves nothing between devices, and no
  count of a sharded program exists without one;
* ``model_flops`` / ``useful_ratio`` inside it;
* for a train shape, ``cards_80gb``: the fewest 80 GB cards whose state
  (``train_state_bytes``: parameters, gradients, AdamW moments, in the
  dtypes the step leaves) fits, replicated over the data axis (each
  replica sharded over ``model`` only) and sharded by ``TRAIN_RULES``.

The reference's ``lower_s``, ``compile_s``, ``while_trips`` and
``xla_cost_analysis`` come from a compiled XLA program; the port compiles
none, so they are left out.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs as C
from repro_torch.configs.base import INPUT_SHAPES, InputShape, input_specs, skip_reason
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.launch.mesh import (AbstractMesh, data_axes, make_production_mesh,
                                     model_axis_size)
from repro_torch.models import transformer as T
from repro_torch.optim import adam
from repro_torch.roofline import model_flops, roofline_from_costs, step_costs

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
CARD_BYTES = 80e9
COLLECTIVE_REASON = ("not counted: one process on one device moves nothing between "
                     "devices, and no sharded program exists to count")


def mesh_name(mesh: AbstractMesh) -> str:
    if mesh == make_production_mesh(multi_pod=True):
        return "pod2x16x16"
    if mesh == make_production_mesh():
        return "single16x16"
    return "x".join(map(str, mesh.sizes))


def _param_bytes(specs: dict, shards: dict) -> int:
    """One device's bytes of the parameters under their shardings."""
    return sum(shards[k].nbytes(sp.dtype) for k, sp in specs.items())


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _shard_bytes(shards: dict, tree: dict) -> int:
    """Per-device bytes of a nested dict of tensors under its shardings."""
    total = 0
    for k, v in tree.items():
        total += _shard_bytes(shards[k], v) if isinstance(v, dict) else \
            shards[k].nbytes(v.dtype)
    return total


def _rows(shape: InputShape, mesh: AbstractMesh) -> int:
    """The batch rows one data shard holds (``batch_shardings``' rule)."""
    dsize = math.prod(mesh.shape[a] for a in data_axes(mesh))
    B = shape.global_batch
    return B // dsize if B % dsize == 0 and B >= dsize else B


def microbatches(cfg, shape: InputShape, mesh: AbstractMesh) -> int:
    """The train step's microbatches on ``mesh`` (``suggest_microbatches``,
    at most one a row of the data shard)."""
    dp = math.prod(mesh.shape[a] for a in data_axes(mesh))
    m = steps.suggest_microbatches(cfg, shape.global_batch, shape.seq_len,
                                   data_parallel=dp, model_parallel=model_axis_size(mesh))
    return min(m, _rows(shape, mesh))


def train_state_bytes(specs: dict, mesh: AbstractMesh, rules: dict, m: int) -> dict:
    """One device's bytes of the train step's state under ``rules``, in the
    dtypes the step leaves (``make_train_step`` with ``m`` microbatches):
    the parameters; their gradients in the parameters' dtype and, with
    ``m > 1``, the step's fp32 sum of them beside; AdamW's two moments,
    which the first update leaves in the summed gradients' dtype
    (``optim.adam`` adds them in: fp32 with ``m > 1``)."""
    shards = S.param_shardings(specs, mesh, rules)
    param_b = _param_bytes(specs, shards)
    acc_b = sum(shards[k].nbytes(torch.float32) for k in specs) if m > 1 else 0
    return {"param_bytes": param_b, "grad_bytes": param_b + acc_b,
            "opt_bytes": 2 * (acc_b if m > 1 else param_b)}


def cards_needed(cfg, shape: InputShape, max_seq: int = 4096,
                 card_bytes: float = CARD_BYTES) -> dict:
    """The fewest cards whose train state (``train_state_bytes`` at each
    mesh's ``microbatches`` for ``shape``) fits ``card_bytes`` each
    (activations left out): ``replicated`` -- each data replica sharded
    over ``model`` alone (``model_only_rules``, the federated round's
    layout), a (1, t) mesh; ``sharded`` -- ``TRAIN_RULES`` over a (data,
    model) mesh, the first power-of-two count with a fitting
    factorization, the one with the least per-device bytes."""
    specs = T.param_specs(cfg, max_seq)
    out = {}
    for layout, rules in (("replicated", S.model_only_rules()), ("sharded", S.TRAIN_RULES)):
        best = None
        for log_n in range(0, 13):
            n = 2 ** log_n
            meshes = [(1, n)] if layout == "replicated" else \
                [(n // t, t) for t in (2 ** i for i in range(log_n + 1))]
            for d, t in meshes:
                mesh = AbstractMesh(("data", "model"), (d, t))
                m = microbatches(cfg, shape, mesh)
                per = sum(train_state_bytes(specs, mesh, rules, m).values())
                if per <= card_bytes and (best is None or per < best["per_device_bytes"]):
                    best = {"cards": n, "mesh": [d, t], "microbatches": m,
                            "per_device_bytes": per}
            if best is not None:
                break
        out[layout] = best
    return out


def _train(model, cfg, shape, mesh, rules, specs, rows) -> dict:
    tp = model_axis_size(mesh)
    m = microbatches(cfg, shape, mesh)
    params = T.train_params(model)
    opt = adam(1e-4)
    state = opt.init(params)
    step = steps.make_train_step(model, opt, microbatches=m)
    batch = input_specs(cfg, shape, batch=max(rows // m, 1))["batch"]
    grad = step_costs(lambda p, s, b: step.grad_of(p, b), params, state, batch)
    grads = grad.result[1]
    mb_grads = _tree_bytes(grads)       # one microbatch's, the parameters' dtype
    if m > 1:       # the step's fp32 sum of the microbatches' gradients
        grads = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                 for k, p in params.items()}
    update = step_costs(step.finish, params, state, grads)
    mem = train_state_bytes(specs, mesh, rules, m)
    # beyond the state: one microbatch's activations and temporaries (its
    # gradients, live at the backward's end, are in grad_b) over the model
    # axis, or the update's gradient-shaped temporaries (the clipped copy)
    # sharded as the parameters are
    fwd_bwd = max(0, grad.peak_bytes - grad.start_bytes - mb_grads) / tp
    upd = (update.peak_bytes - update.start_bytes) * mem["param_bytes"] / _tree_bytes(params)
    act_b = max(fwd_bwd, upd)
    return {
        "microbatches": m, "rows_per_microbatch": max(rows // m, 1),
        "counted": (f"one microbatch's forward and backward on meta x {m}, then the "
                    f"update once; per device / model axis {tp}; the activation "
                    f"estimate is the " + ("update's" if upd > fwd_bwd else
                                          "forward and backward's")),
        "flops": (m * grad.flops + update.flops) / tp,
        "bytes": (m * grad.bytes + update.bytes) / tp,
        "kernels": {k: {f: m * v[f] for f in v} for k, v in grad.kernels.items()},
        "memory": {**mem, "activation_bytes_estimate": act_b},
        "meta": {"grad": grad, "update": update},
    }


def _serve(model, cfg, shape, mesh, specs, rows) -> dict:
    tp = model_axis_size(mesh)
    params = T.train_params(model)
    ins = input_specs(cfg, shape, batch=rows)
    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(model)
        costs = step_costs(lambda p, b: prefill(b), params, ins["batch"])
        cache = costs.result[2]
        new = _tree_bytes(cache)            # the cache the prefill makes
    else:
        serve = steps.make_serve_step(model)
        cache = ins["cache"]
        costs = step_costs(lambda p, b, c: serve(b, c), params, ins["batch"], cache)
        new = 0
    cache_b = _shard_bytes(S.cache_shardings(cache, mesh),
                           {k: v for k, v in cache.items() if isinstance(v, dict)})
    param_b = _param_bytes(specs, S.param_shardings(specs, mesh, S.INFER_RULES))
    act_b = max(0, costs.peak_bytes - costs.start_bytes - new) / tp
    return {
        "counted": f"one {shape.kind} step on meta; per device / model axis {tp}",
        "flops": costs.flops / tp, "bytes": costs.bytes / tp, "kernels": costs.kernels,
        "memory": {"param_bytes": param_b, "cache_bytes": cache_b,
                   "activation_bytes_estimate": act_b},
        "meta": {"step": costs},
    }


def _fl_round(model, cfg, shape, mesh, specs, rows) -> dict:
    """One mediator's Astraea round a data shard (its ``rows`` client
    streams, one row a local step), weights sharded over ``model`` only."""
    tp = model_axis_size(mesh)
    params = T.train_params(model)
    fl = steps.make_fl_round(model, 1, local_steps=rows, mediator_epochs=1)
    tok = torch.empty(rows, shape.seq_len, dtype=torch.int32, device="meta")
    w = torch.empty(rows, dtype=torch.float32, device="meta")
    costs = step_costs(fl, params, tok, tok, w)
    param_b = _param_bytes(specs, S.param_shardings(specs, mesh, S.model_only_rules()))
    return {
        "counted": f"one mediator's round of {rows} local steps on meta; per device / "
                   f"model axis {tp}",
        "flops": costs.flops / tp, "bytes": costs.bytes / tp, "kernels": costs.kernels,
        "memory": {"param_bytes": param_b,
                   "activation_bytes_estimate": (costs.peak_bytes - costs.start_bytes) / tp},
        "meta": {"round": costs},
    }


def run_one(arch_id: str, shape: str | InputShape, multi_pod: bool = False, *,
            out_dir: str | None = None, rules: dict | None = None, tag: str = "",
            fl_round: bool = False, mesh: AbstractMesh | None = None,
            cfg=None, keep_meta: bool = False) -> dict:
    """One dry-run record (the module docstring).  ``shape``: a name of
    ``INPUT_SHAPES`` or an ``InputShape``; ``mesh`` replaces the production
    mesh (``make_host_mesh()``: one card); ``cfg`` replaces ``arch_id``'s
    config; ``rules`` the train rules; ``keep_meta`` keeps the meta runs'
    ``StepCosts`` under ``"meta"``.  With ``out_dir`` the record is also
    written there as JSON."""
    cfg = cfg or C.get(arch_id)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch_id, "shape": shape.name, "mesh": mesh_name(mesh),
                 "kind": "fl_round" if fl_round else shape.kind, "tag": tag,
                 "params_total": T.param_count(cfg),
                 "params_active": T.active_param_count(cfg)}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", skip_reason=reason)
        return _save(rec, out_dir)
    if rules is None:
        rules = dict(S.TRAIN_RULES)
        if cfg.moe_token_parallel:      # experts replicated, tokens over every axis
            rules["mlp"] = []
    max_seq = max(shape.seq_len, T.MAX_SEQ)
    specs = T.param_specs(cfg, max_seq)
    rows = _rows(shape, mesh)
    t0 = time.perf_counter()
    model = T.Transformer(cfg, device="meta", max_seq=max_seq)
    if fl_round:
        part = _fl_round(model, cfg, shape, mesh, specs, rows)
    elif shape.kind == "train":
        part = _train(model, cfg, shape, mesh, rules, specs, rows)
    else:
        part = _serve(model, cfg, shape, mesh, specs, rows)
    meta_s = time.perf_counter() - t0
    mem = part["memory"]
    mem["peak_estimate_bytes"] = sum(mem.values())
    mem["peak_estimate_gb"] = round(mem["peak_estimate_bytes"] / 2 ** 30, 3)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mflops = model_flops(cfg, tokens, "train" if fl_round else shape.kind) / mesh.size
    terms = roofline_from_costs(part["flops"], part["bytes"], None, mflops)
    rec.update(
        status="ok", n_chips=mesh.size, rows_per_device=rows, meta_s=round(meta_s, 2),
        memory=mem,
        counted_costs={"flops": part["flops"], "bytes": part["bytes"],
                       "bytes_are": "aten ops' inputs + outputs (unfused proxy) + kernels' "
                                    "analytic bytes",
                       "collective_bytes": None, "kernels": part["kernels"],
                       "how": part["counted"],
                       **{k: part[k] for k in ("microbatches", "rows_per_microbatch")
                          if k in part}},
        roofline={**terms.as_dict(), "collective_reason": COLLECTIVE_REASON},
    )
    if shape.kind == "train" and not fl_round:
        rec["cards_80gb"] = cards_needed(cfg, shape, max_seq)
    if keep_meta:
        rec["meta"] = part["meta"]
    return _save(rec, out_dir)


def _save(rec: dict, out_dir: str | None) -> dict:
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump({k: v for k, v in rec.items() if k != "meta"}, f, indent=2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = C.ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    failures = 0
    t_all = time.perf_counter()
    for aid in archs:
        for snm in shapes:
            t0 = time.perf_counter()
            try:
                rec = run_one(aid, snm, args.multi_pod, out_dir=args.out)
            except Exception as e:      # a failure here is a fault of the port
                rec = _save({"arch": aid, "shape": snm,
                             "mesh": mesh_name(make_production_mesh(multi_pod=args.multi_pod)),
                             "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()[-3000:]}, args.out)
                failures += 1
            status = rec["status"]
            if status == "ok":
                r, m = rec["roofline"], rec["memory"]
                extra = (f" dom={r['dominant']:7s} comp={r['compute_s'] * 1e3:10.2f}ms"
                         f" mem={r['memory_s'] * 1e3:10.2f}ms peak={m['peak_estimate_gb']:8.2f}GB"
                         f" useful={r['useful_ratio']:.3f}")
            elif status == "skipped":
                extra = " (" + rec["skip_reason"][:60] + ")"
            else:
                extra = " " + rec.get("error", "")[:120]
            print(f"[{time.perf_counter() - t0:6.1f}s] {aid:24s} {snm:12s} {status:8s}{extra}",
                  flush=True)
    print(f"[{time.perf_counter() - t_all:6.1f}s] all, {failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
