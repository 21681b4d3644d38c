"""The port's dry run and quickstart twin on the CPU: the meta input specs
and skip rule against the reference's for every arch x input shape,
``run_one``'s records (the reference's keys, the skipped pair, the memory
accounting of a one-card step, a federated round), the fewest cards that
hold qwen1.5-110b's and grok-1-314b's state, the train step's two parts
equal to the step (and its update not holding the unclipped gradients),
the import boundary (no ``jax``, no ``repro``), and the quickstart twin's
WAN ledger against its closed form."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.configs.base import INPUT_SHAPES as R_SHAPES           # noqa: E402
from repro.configs.base import input_specs as r_input_specs       # noqa: E402
from repro.models import transformer as RT                        # noqa: E402
from repro.roofline.model import RooflineTerms                    # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.examples import quickstart                       # noqa: E402
from repro_torch.launch import dryrun, steps                      # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402
from repro_torch.optim import adam                                # noqa: E402
from repro_torch.roofline import step_costs                       # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _port_cache_leaves(cfg, cache) -> dict:
    if cfg.arch_type == "ssm":
        return dict(cache["ssm"])
    return {f"{blk}.{k}": t for blk, leaves in cache.items() for k, t in leaves.items()}


@pytest.mark.parametrize("shape", list(PC.INPUT_SHAPES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    """The batch (and a decode cache) as meta tensors of the reference's
    shapes and dtypes; the skip rule the reference's."""
    rcfg, cfg = RC.get(arch), PC.get(arch)
    assert PC.INPUT_SHAPES[shape] == PC.InputShape(*vars(R_SHAPES[shape]).values())
    want = r_input_specs(rcfg, R_SHAPES[shape])
    got = PC.input_specs(cfg, PC.INPUT_SHAPES[shape])
    assert set(want) == set(got)
    assert set(want["batch"]) == set(got["batch"])
    for k, sd in want["batch"].items():
        t = got["batch"][k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == sd.shape and str(t.dtype)[6:] == str(sd.dtype), k
    if "cache" in want:
        rflat = {".".join(k.key for k in path): sd for path, sd in
                 jax.tree_util.tree_flatten_with_path(want["cache"])[0]}
        pflat = _port_cache_leaves(cfg, got["cache"])
        assert set(rflat) == set(pflat)
        for k, sd in rflat.items():
            assert tuple(pflat[k].shape) == sd.shape and pflat[k].device.type == "meta"
            assert str(pflat[k].dtype)[6:] == str(sd.dtype), k
    skipped = shape == "long_500k" and not rcfg.sub_quadratic
    assert (PC.skip_reason(cfg, PC.INPUT_SHAPES[shape]) is not None) == skipped


# the reference's record keys the port keeps (``repro/launch/dryrun.py``)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "tag", "params_total", "params_active",
               "status", "n_chips", "memory", "roofline"}


def test_run_one_record_has_the_reference_keys(tmp_path):
    rec = dryrun.run_one("whisper-base", "decode_32k", out_dir=str(tmp_path))
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("single16x16", 256, "decode")
    cfg = RC.get("whisper-base")
    assert rec["params_total"] == RT.param_count(cfg)
    assert rec["params_active"] == RT.active_param_count(cfg)
    terms = RooflineTerms(1.0, 2.0, 3.0, 1.0, 1.0, 1.0, 1.0, 1.0).as_dict()
    assert set(rec["roofline"]) == set(terms) | {"collective_reason"}
    assert rec["roofline"]["collective_s"] is None
    assert rec["roofline"]["collective_bytes"] is None
    mem = rec["memory"]
    assert mem["peak_estimate_gb"] > 0 and mem["param_bytes"] > 0 and mem["cache_bytes"] > 0
    # 6 decoder self-attention layers over the cache, 6 cross-attention
    # launches against the encoder's output (flash)
    assert rec["counted_costs"]["kernels"]["flash_attention"]["launches"] == 6
    saved = json.loads((tmp_path / "whisper-base__decode_32k__single16x16.json").read_text())
    assert saved["memory"] == mem and saved["status"] == "ok"


def test_long_500k_of_a_full_attention_model_is_skipped():
    rec = dryrun.run_one("gemma-2b", "long_500k")
    assert rec["status"] == "skipped"
    assert rec["skip_reason"].startswith("full-attention architecture without a "
                                         "sliding-window/SSM variant")


def test_one_card_step_memory_is_the_meta_peak():
    """On one device with one microbatch the estimate is the meta step's
    peak of live bytes, less the batch: parameters, AdamW's moments, then
    the gradients and activations at the backward's end, or the update's
    temporaries -- whichever is more."""
    cfg = PC.reduced(PC.get("qwen3-4b"))
    shape = PC.InputShape("t", 32, 2, "train")
    rec = dryrun.run_one("qwen3-4b", shape, mesh=make_host_mesh(), cfg=cfg, keep_meta=True)
    grad, update = rec["meta"]["grad"], rec["meta"]["update"]
    batch = 2 * 2 * 32 * 4                           # int32 tokens and labels
    mem = rec["memory"]
    assert rec["counted_costs"]["microbatches"] == 1
    assert mem["peak_estimate_bytes"] == max(grad.peak_bytes - batch, update.peak_bytes)
    params = PT.param_count(cfg) * 4
    assert mem["param_bytes"] == mem["grad_bytes"] == params and mem["opt_bytes"] == 2 * params
    assert rec["counted_costs"]["flops"] == grad.flops + update.flops
    assert grad.launches == {"flash_attention": 2, "flash_attention_bwd": 2}
    assert rec["roofline"]["model_flops"] == 6 * PT.active_param_count(cfg) * 64


def test_fl_round_dry_run_charges_eq6():
    cfg = PC.reduced(PC.get("granite-moe-3b-a800m"))
    shape = PC.InputShape("t", 64, 4, "train")
    rec = dryrun.run_one("granite-moe-3b-a800m", shape, fl_round=True, cfg=cfg,
                         mesh=AbstractMesh(("data", "model"), (2, 1)))
    assert rec["status"] == "ok" and rec["kind"] == "fl_round" and rec["rows_per_device"] == 2
    launches = {k: v["launches"] for k, v in rec["counted_costs"]["kernels"].items()}
    assert launches == {"fedavg_agg": len(PT.train_params(PT.Transformer(cfg, "meta"))),
                        "flash_attention": 4, "flash_attention_bwd": 4}


def _moment_bytes(state: dict, specs: dict, mesh, rules) -> int:
    """One device's bytes of AdamW's moments as the step left them."""
    shards = dryrun.S.per_parameter(specs, dryrun.S.param_shardings(specs, mesh, rules))
    return sum(shards[k].nbytes(t.dtype) for key in ("mu", "nu")
               for k, t in state[key].items())


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_train_state_bytes_are_the_steps(mesh):
    """On a sharded mesh with two microbatches (a bf16 model at a sequence
    long enough for ``suggest_microbatches`` to split it) the record's
    state is ``train_state_bytes``': bf16 parameters, their gradients and
    the fp32 sum, and AdamW's moments in fp32 as the meta update leaves
    them -- about 16 bytes a parameter, against 8 with one microbatch; and
    ``cards_needed`` counts that state."""
    cfg = dataclasses.replace(PC.reduced(PC.get("qwen3-4b")), dtype="bfloat16")
    shape = PC.InputShape("t", 524_288, 16, "train")
    amesh = AbstractMesh(("data", "model"), mesh)
    rec = dryrun.run_one("qwen3-4b", shape, mesh=amesh, cfg=cfg, keep_meta=True)
    m = rec["counted_costs"]["microbatches"]
    assert m == (2 if mesh == (2, 2) else 8)
    max_seq = max(shape.seq_len, PT.MAX_SEQ)
    specs = PT.param_specs(cfg, max_seq)
    rules = dryrun.S.TRAIN_RULES
    want = dryrun.train_state_bytes(specs, amesh, rules, m)
    mem = rec["memory"]
    assert {k: mem[k] for k in want} == want
    state = rec["meta"]["update"].result[1]
    assert mem["opt_bytes"] == _moment_bytes(state, specs, amesh, rules)
    acc = mem["grad_bytes"] - mem["param_bytes"]               # the fp32 sum
    assert mem["opt_bytes"] == 2 * acc and 1.9 * mem["param_bytes"] < acc <= 2 * mem["param_bytes"]
    if mesh == (2, 2):
        assert mem["param_bytes"] < 2 * PT.param_count(cfg)      # sharded
    state_b = sum(want.values())
    cards = dryrun.cards_needed(cfg, shape, max_seq, card_bytes=state_b)["sharded"]
    assert cards["per_device_bytes"] <= state_b and cards["cards"] <= math.prod(mesh)
    one = dryrun.train_state_bytes(specs, amesh, rules, 1)
    assert sum(one.values()) == 4 * one["param_bytes"] < 0.55 * state_b


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "grok-1-314b"])
def test_cards_needed_for_the_largest_models(arch):
    """Parameters, gradients and AdamW moments in bf16 (8 bytes a
    parameter) need at least that over 80 GB of cards; the count found
    fits at its mesh's microbatches, and half of it fits in no layout."""
    cfg = PC.get(arch)
    shape = PC.INPUT_SHAPES["train_4k"]
    got = dryrun.cards_needed(cfg, shape)
    specs = PT.param_specs(cfg)
    floor = math.ceil(8 * PT.param_count(cfg) / 80e9)
    for layout, rules in (("replicated", dryrun.S.model_only_rules()),
                          ("sharded", dryrun.S.TRAIN_RULES)):
        best = got[layout]
        assert best["cards"] >= floor and best["per_device_bytes"] <= 80e9
        d, t = best["mesh"]
        assert d * t == best["cards"]
        half = best["cards"] // 2
        meshes = [(1, half)] if layout == "replicated" else \
            [(half // t, t) for t in (2 ** i for i in range(int(math.log2(half)) + 1))]
        for d, t in meshes:
            mesh = AbstractMesh(("data", "model"), (d, t))
            per = dryrun.train_state_bytes(specs, mesh, rules,
                                           dryrun.microbatches(cfg, shape, mesh))
            assert sum(per.values()) > 80e9


def test_train_step_parts_equal_the_step():
    """``grad_of`` over each microbatch, summed, then ``finish`` -- the
    parts the dry run counts -- give the step's parameters bit for bit."""
    cfg = PC.reduced(PC.get("qwen3-4b"))
    batch = PC.make_batch(cfg, PC.InputShape("t", 16, 4, "train"), seed=3)["batch"]
    outs = []
    for split in (False, True):
        model = PT.init_model(cfg, torch.Generator().manual_seed(0))
        params = PT.train_params(model)
        opt = adam(1e-3)
        state = opt.init(params)
        step = steps.make_train_step(model, opt, microbatches=2)
        if split:
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            for i in range(2):
                mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
                for k, g in step.grad_of(params, mb)[1].items():
                    grads[k].add_(g)
            step.finish(params, state, grads)
        else:
            step(params, state, batch)
        outs.append(params)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_dry_run_imports_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.roofline, "
            "repro_torch.examples.quickstart, repro_torch.launch.sharding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_quickstart_twin_wan_is_the_closed_form(capsys):
    """FedAvg: ``2 c |w|`` a round; Astraea: ``2 |w| (c E_m + ceil(c /
    gamma))`` a round plus the Alg. 2 plan (one int32 a class to each
    client), 4-byte parameters, in MiB."""
    out = quickstart.main(["--device", "cpu", "--rounds", "2"])
    w = 4 * out["num_params"]
    c, g = quickstart.PER_ROUND, quickstart.GAMMA
    plan = 4 * out["num_classes"] * out["num_clients"]
    fedavg = [h["round"] * 2 * c * w / 2 ** 20 for h in out["fedavg"]]
    astraea = [(plan + h["round"] * 2 * w * (c + math.ceil(c / g))) / 2 ** 20
               for h in out["astraea"]]
    assert [h["round"] for h in out["fedavg"]] == [h["round"] for h in out["astraea"]] == [1, 2]
    assert [h["traffic_mb"] for h in out["fedavg"]] == fedavg
    assert [h["traffic_mb"] for h in out["astraea"]] == astraea
    assert all(np.isfinite(h["accuracy"]) for h in out["fedavg"] + out["astraea"])
    assert "WAN traffic after 2 rounds" in capsys.readouterr().out
    assert out["store_stats"]["model_axis"] == 1 and out["intra_pod_bytes"] == 0
    with pytest.raises(SystemExit):
        quickstart.main(["--model-parallel", "0"])


def test_finish_releases_the_unclipped_gradients():
    """``finish`` empties the gradient dict once the clipped copy exists:
    through the update the step holds one copy of the gradients, and its
    peak above the parameters, moments and gradients is that clipped copy
    (on meta).  A caller that keeps the unclipped ones adds the update's
    per-leaf temporaries on top -- what the count would show."""
    cfg = PC.reduced(PC.get("qwen3-4b"))
    model = PT.Transformer(cfg, device="meta")
    params = PT.train_params(model)
    opt = adam(1e-4)
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    batch = PC.input_specs(cfg, PC.InputShape("t", 16, 2, "train"))["batch"]
    grads_b = sum(p.numel() * p.element_size() for p in params.values())
    leaf_b = max(p.numel() * p.element_size() for p in params.values())
    rises = []
    for keep in (False, True):
        grads = step_costs(lambda p, s, b: step.grad_of(p, b), params, state, batch).result[1]
        held = list(grads.values()) if keep else []
        update = step_costs(step.finish, params, state, grads)
        assert grads == {}
        rises.append(update.peak_bytes - update.start_bytes)
        del held
    assert rises[0] <= grads_b + 2 * leaf_b < rises[1]
