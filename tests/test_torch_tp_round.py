"""The model axis of the transformer round and its collectives, on the CPU:
``launch/steps.py::make_fl_round(mesh=...)`` tensor-parallel over a model
axis (the reference leaves its ``model`` axis to the compiler:
``repro/launch/steps.py:118-255``), ``launch/model_axis.py`` and the rule
tables on live tensors (``launch/sharding.py``).

* The reduced qwen3-4b, h2o-danube-1.8b and gemma-2b (MQA: its one KV head
  stays whole on every position) run a round at t=2 against the port's
  t=1 round from the same weights and tokens (which
  ``tests/test_torch_train.py`` holds against the reference): every leaf
  within ``TP_TOL`` of that leaf's largest update.  The weights are the
  port's init rescaled to the standard fan-in (as the card's training
  tests run): at the reference's init a 1e-7 relative perturbation of the
  weights moves these rounds' updates by up to 1.4e-3 of their scale
  (``test_torch_train.py::_fan_in``); at the fan-in it moves them by
  ~1e-4, and t=2 lands 1.8e-5 to 2.8e-5 from t=1 (on an x86 Xeon CPU).
* Eq. 6 per shard (one ``fedavg_agg`` a shard, the reference's
  ``psum_eq6``) is the whole leaf's Eq. 6 bit for bit in fp32.
* A family the tensor-parallel forward does not cover raises a
  ``ValueError`` naming its ROADMAP item, never a silent replicated run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.launch import sharding as RS                                 # noqa: E402
from repro.launch.compat import abstract_mesh                           # noqa: E402
import repro.configs as RC                                              # noqa: E402
from repro.models import transformer as RT                              # noqa: E402

from repro_torch import configs as C                                    # noqa: E402
from repro_torch.kernels import ops                                     # noqa: E402
from repro_torch.launch import fl_train, model_axis, sharding, steps    # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_fl_mesh          # noqa: E402
from repro_torch.models import transformer as T                         # noqa: E402

CPU = torch.device("cpu")
TP_TOL = 1e-4           # of each leaf's largest update, t=2 against t=1
TP_ARCHS = ("qwen3-4b", "h2o-danube-1.8b", "gemma-2b")


def _model(arch):
    cfg = C.reduced(C.get(arch))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("layers.") and p.dim() == 2:
                p.mul_((cfg.n_layers / p.shape[0]) ** 0.5)
    return model


def _batch(cfg, rows=4, seq=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (rows, seq), generator=g)
    return tokens, torch.roll(tokens, -1, 1), torch.ones(rows)


def _mesh(t=2):
    return make_fl_mesh(mediator=1, model=t, devices=(CPU,) * t)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_round_matches_t1_round(arch):
    model = _model(arch)
    params = T.train_params(model)
    tokens, labels, w = _batch(model.cfg)
    kw = dict(learning_rate=0.05, local_steps=2)
    one = steps.make_fl_round(model, 2, **kw)(params, tokens, labels, w)
    two = steps.make_fl_round(model, 2, mesh=_mesh(), **kw)(params, tokens, labels, w)
    assert set(two) == set(params)
    for k, p in params.items():
        assert two[k].shape == p.shape and two[k].dtype == p.dtype
        upd = float((one[k] - p).abs().max())
        assert float((two[k] - one[k]).abs().max()) <= TP_TOL * upd, k
    assert max(float((one[k] - params[k]).abs().max()) for k in params) > 0


def test_model_axis_of_one_is_the_plain_round():
    """``model=1``: the mesh changes nothing, bit for bit."""
    model = _model("qwen3-4b")
    params = T.train_params(model)
    tokens, labels, w = _batch(model.cfg)
    a = steps.make_fl_round(model, 2, local_steps=2)(params, tokens, labels, w)
    b = steps.make_fl_round(model, 2, local_steps=2, mesh=_mesh(1))(params, tokens, labels, w)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b"])
def test_tp_forward_matches_forward_train(arch):
    """One loss and gradient through ``forward_train``'s ``TensorParallel``
    hook at t=2 (remat on and off) against ``forward_train`` on the whole
    weights."""
    model = _model(arch)
    params = T.train_params(model)
    tokens, labels, _ = _batch(model.cfg, rows=2)
    batch = {"tokens": tokens, "labels": labels}
    dims = sharding.placements(T.param_specs(model.cfg), _mesh())
    tp = T.TensorParallel(model, dims, (CPU, CPU), CPU)
    tree = {}
    for k, p in params.items():
        if dims[k] is None:
            tree[k] = p
        else:
            for j, s in enumerate(model_axis.split(p, dims[k], (CPU, CPU))):
                tree[f"{k}@{j}"] = s
    loss, grads = steps._loss_and_grads(lambda p: T.forward_train(model, batch, p)[0], params)
    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        tl, tg = steps._loss_and_grads(lambda p: T.forward_train(model, batch, p, tp)[0],
                                       tree)
        torch.testing.assert_close(tl, loss, rtol=1e-5, atol=1e-6)
        for k, d in dims.items():
            got = tg[k] if d is None else torch.cat([tg[f"{k}@{j}"] for j in range(2)], d)
            scale = float(grads[k].abs().max()) + 1e-30
            assert float((got - grads[k]).abs().max()) <= 1e-4 * scale, (remat, k)


@pytest.mark.parametrize("m", [2, 3])
def test_eq6_per_shard_is_the_whole_leafs_bitwise(m):
    """fp32 Eq. 6 on each shard of each leaf of the reduced qwen3-4b (one
    ``fedavg_agg`` a shard) concatenates to the whole leaf's Eq. 6 bit
    for bit: the reduction runs over M, column by column."""
    model = _model("qwen3-4b")
    params = T.train_params(model)
    dims = sharding.placements(T.param_specs(model.cfg), _mesh())
    g = torch.Generator().manual_seed(m)
    wts = torch.rand(m, generator=g) * 100
    for k, p in params.items():
        deltas = torch.randn((m,) + p.shape, generator=g)
        whole = ops.fedavg_agg(deltas.reshape(m, -1), wts).reshape(p.shape)
        d = dims[k]
        if d is None:
            continue
        parts = []
        for s in deltas.chunk(2, 1 + d):
            s = s.contiguous()
            parts.append(ops.fedavg_agg(s.reshape(m, -1), wts).reshape(s.shape[1:]))
        assert torch.equal(torch.cat(parts, d), whole), k


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m", "whisper-base",
                                  "internvl2-1b", "hymba-1.5b"])
def test_tp_round_of_other_families_raises(arch):
    cfg = C.reduced(C.get(arch))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="TP for MoE, SSM, audio and VLM"):
        steps.make_fl_round(model, 2, mesh=_mesh())


def test_tp_round_with_lora_raises():
    model = _model("qwen3-4b")
    mapping = T.adapter_mapping(model.cfg, 2)
    with pytest.raises(ValueError, match="LoRA"):
        steps.make_fl_round(model, 2, mesh=_mesh(), lora_mapping=mapping)


@pytest.mark.parametrize("arch", TP_ARCHS + ("internvl2-1b",))
@pytest.mark.parametrize("t", [2, 4])
def test_transformer_placements_are_the_references(arch, t):
    """``placements`` over a transformer's specs at t positions: the
    reference's ``param_shardings(specs, mesh, model_only_rules())`` for
    every parameter, its layer axis dropped."""
    rcfg = RC.reduced(RC.get(arch))
    pcfg = C.reduced(C.get(arch))
    am = abstract_mesh((1, t), ("mediator", "model"))
    want = RS.param_shardings(RT.param_specs(rcfg), am, RS.model_only_rules())
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    pm = AbstractMesh(("mediator", "model"), (1, t))
    specs = T.param_specs(pcfg)
    dims = sharding.placements(specs, pm)
    for k, sp in specs.items():
        ref = want[k.replace(".", "/")]
        ref_dim = next((i for i, e in enumerate(ref) if e == "model"), None)
        for name in sp.names:
            stacked = not (len(sp.names) == 1 and sp.names[0] == k)
            assert dims[name] == (None if ref_dim is None else ref_dim - stacked), name


def test_collectives_are_exact_and_ordered():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 10, generator=g)
    for dim in (0, 1, None):
        shards = model_axis.split(x, dim, (CPU,) * 2)
        assert all(s.is_contiguous() for s in shards)
        assert torch.equal(model_axis.all_gather(shards, dim, CPU), x)
    with pytest.raises(ValueError, match="does not split"):
        model_axis.split(x, 0, (CPU,) * 4)
    parts = [torch.randn(5, generator=g) for _ in range(3)]
    assert torch.equal(model_axis.all_reduce(parts, CPU), (parts[0] + parts[1]) + parts[2])
    # the autograd pairs: copy / all-reduce, all-reduce / copy, gather / slice
    a = x.clone().requires_grad_(True)
    outs = model_axis.to_positions(a, (CPU, CPU))
    (outs[0] * 2 + outs[1] * 3).sum().backward()
    assert torch.equal(a.grad, torch.full_like(x, 5.0))
    ps = [x.clone().requires_grad_(True) for _ in range(2)]
    model_axis.reduce_from_positions(ps, CPU).mul(torch.arange(10.)).sum().backward()
    assert all(torch.equal(p.grad, torch.arange(10.).expand(6, 10)) for p in ps)
    ss = [s.requires_grad_(True) for s in model_axis.split(x, 1, (CPU, CPU))]
    model_axis.gather_from_positions(ss, 1, CPU).mul(torch.arange(10.)).sum().backward()
    assert torch.equal(ss[1].grad, torch.arange(5., 10.).expand(6, 5))
    # under torch.func (the CNN engine's lockstep rows)
    f = lambda y: model_axis.gather_from_positions(              # noqa: E731
        model_axis.to_positions(y, (CPU, CPU)), 0, CPU).square().sum()
    got = torch.func.vmap(torch.func.grad(f))(x)
    assert torch.equal(got, 4 * x)


def test_fl_train_model_parallel_runs():
    out = fl_train.main(["--device", "cpu", "--rounds", "2", "--model-parallel", "2"])
    solo = fl_train.main(["--device", "cpu", "--rounds", "2"])
    assert all(np.isfinite(out["losses"]))
    assert out["ledger"] == solo["ledger"]
    np.testing.assert_allclose(out["losses"], solo["losses"], rtol=1e-4)
    two = fl_train.main(["--device", "cpu", "--rounds", "1", "--model-parallel", "2",
                         "--devices", "cpu,cpu"])
    assert two["losses"][0] == out["losses"][0]
    with pytest.raises(SystemExit, match="positions"):
        fl_train.main(["--device", "cpu", "--model-parallel", "2", "--devices", "cpu"])
