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
* The MoE (granite-moe-3b-a800m, grok-1-314b: expert-parallel), SSM
  (mamba2-370m) and hybrid (hymba-1.5b) families run the round at t=2 and
  t=4, full-delta and over a LoRA adapter state, at their reduced configs
  and at ``PATTERN`` configs: small, but with the full config's
  divisibility over the model axis (hymba's 25:5 heads and 25 SSD heads,
  an odd ``in_proj`` and an odd vocabulary; granite's 40 experts and 24:8
  heads; mamba2's 32 SSD heads and packed ``in_proj`` split through x), so
  each splits the same leaves along the same dimensions as its full
  config (``test_pattern_configs_split_as_the_full_configs``).  The
  reduced configs hide hymba's pattern: 4:4 heads split cleanly.  Their
  stacked layer weights (the 3-D expert leaves too) are rescaled to the
  fan-in: at the reference's ``1/sqrt(layers)`` an expert weight of ~0.7
  moves by single fp32 ulps of 1e-3 of its round update.
* The ``TensorParallel`` loss and gradients against ``forward_train`` on
  the whole weights, remat on and off; the MoE routes equal over the
  model axis; Eq. 6 per shard (one ``fedavg_agg`` a shard, the
  reference's ``psum_eq6``) is the whole leaf's Eq. 6 bit for bit in fp32.
* An audio model's or a VLM's round on a mesh raises for its missing
  input, as its t=1 round does (the reference's round fails on the same
  missing key); a placement the forward cannot serve raises by name.
"""
import dataclasses
import functools

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
from repro_torch.models import lora as lora_lib                         # noqa: E402
from repro_torch.models import transformer as T                         # noqa: E402

CPU = torch.device("cpu")
TP_TOL = 1e-4           # of each leaf's largest update, t=2 against t=1
TP_ARCHS = ("qwen3-4b", "h2o-danube-1.8b", "gemma-2b")
FAMILIES = ("granite-moe-3b-a800m", "mamba2-370m", "hymba-1.5b")
# each family's full-config divisibility over t = 2 and 4, at CPU size
PATTERN = {
    "granite-moe-3b-a800m": dict(d_model=64, head_dim=8, d_ff=16, vocab=257,
                                 moe_group=64),                   # 24:8 heads, 40 experts
    "mamba2-370m": dict(d_model=64, ssm_heads=32, ssm_head_dim=4, ssm_state=8,
                        ssm_chunk=16, vocab=512),                 # in_proj 304
    "hymba-1.5b": dict(d_model=64, head_dim=8, d_ff=64, ssm_head_dim=8, ssm_state=4,
                       ssm_chunk=16, vocab=257, sliding_window=16),  # 25:5, in_proj 433
}


def _config(arch, kind="reduced"):
    if kind == "reduced":
        return C.reduced(C.get(arch))
    return dataclasses.replace(C.get(arch), n_layers=2, dtype="float32", remat=False,
                               name=f"{arch}-pattern", **PATTERN[arch])


def _model(arch, kind="reduced"):
    cfg = _config(arch, kind)
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("layers.") and p.dim() == 2:
                p.mul_((cfg.n_layers / p.shape[0]) ** 0.5)
            elif name.startswith("layers.") and p.dim() == 3:        # experts
                p.mul_((cfg.n_layers / p.shape[-2]) ** 0.5)
    return model


def _seq(cfg):
    return max(32, cfg.ssm_chunk if cfg.has_ssm else 0)


def _tree(params, dims, t):
    return model_axis.split_tree(params, dims, (CPU,) * t)


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
    tree = _tree(params, dims, 2)
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


@functools.lru_cache(maxsize=None)
def _t1_round(arch, kind, lora):
    """The t=1 round of ``arch``: (model, start, adapter inputs, batch,
    result)."""
    model = _model(arch, kind)
    params = T.train_params(model)
    tokens, labels, w = _batch(model.cfg, seq=_seq(model.cfg))
    kw = dict(learning_rate=0.05, local_steps=2)
    if not lora:
        return model, params, None, (tokens, labels, w), \
            steps.make_fl_round(model, 2, **kw)(params, tokens, labels, w)
    mapping = T.adapter_mapping(model.cfg, 2)
    a_tree = lora_lib.init_adapter_A(lora_lib.A_SALT, mapping)
    state = lora_lib.init_adapter_state(mapping, params)
    fl = steps.make_fl_round(model, 2, lora_mapping=mapping, **kw)
    return model, params, (mapping, a_tree, state), (tokens, labels, w), \
        fl(params, a_tree, state, tokens, labels, w)


ROUND_CASES = [(a, k) for a in FAMILIES for k in ("reduced", "pattern")] \
    + [("grok-1-314b", "reduced"), ("qwen3-4b", "reduced")]


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch,kind", ROUND_CASES)
def test_tp_round_of_every_family_matches_t1(arch, kind, t, lora):
    """The round of every family the round trains, at t=2 and t=4,
    full-delta and over a LoRA rank-2 adapter state, against the port's
    t=1 round from the same start and tokens: every leaf (of the weights,
    or of the adapter state) within ``TP_TOL`` of its largest update."""
    model, params, ad, (tokens, labels, w), one = _t1_round(arch, kind, lora)
    kw = dict(learning_rate=0.05, local_steps=2, mesh=_mesh(t))
    if lora:
        mapping, a_tree, start = ad
        two = steps.make_fl_round(model, 2, lora_mapping=mapping, **kw)(
            params, a_tree, start, tokens, labels, w)
    else:
        start = params
        two = steps.make_fl_round(model, 2, **kw)(params, tokens, labels, w)
    assert set(two) == set(start)
    for k, p in start.items():
        assert two[k].shape == p.shape and two[k].dtype == p.dtype
        upd = float((one[k] - p).abs().max())
        assert float((two[k] - one[k]).abs().max()) <= TP_TOL * upd, k
    assert max(float((one[k] - start[k]).abs().max()) for k in start) > 0


GRAD_CASES = [(a, k) for a in FAMILIES for k in ("reduced", "pattern")]


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch,kind", GRAD_CASES)
def test_tp_gradients_of_every_family(arch, kind, t):
    """One loss and its gradient through the ``TensorParallel`` hook
    (remat on and off) against ``forward_train`` on the whole weights:
    the loss within 1e-5, every leaf's gradient (the shards put together)
    within 1e-4 of its scale; the expert shards' backward, the SSM's
    gathers and the attention's narrowed KV groups included."""
    model = _model(arch, kind)
    params = T.train_params(model)
    tokens, labels, _ = _batch(model.cfg, rows=2, seq=_seq(model.cfg))
    batch = {"tokens": tokens, "labels": labels}
    dims = sharding.placements(T.param_specs(model.cfg), _mesh(t))
    tp = T.TensorParallel(model, dims, (CPU,) * t, CPU)
    loss, grads = steps._loss_and_grads(lambda p: T.forward_train(model, batch, p)[0], params)
    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        tl, tg = steps._loss_and_grads(lambda p: T.forward_train(model, batch, p, tp)[0],
                                       _tree(params, dims, t))
        torch.testing.assert_close(tl, loss, rtol=1e-5, atol=1e-6)
        for k, d in dims.items():
            got = tg[k] if d is None else torch.cat([tg[f"{k}@{j}"] for j in range(t)], d)
            scale = float(grads[k].abs().max()) + 1e-30
            assert float((got - grads[k]).abs().max()) <= 1e-4 * scale, (remat, k)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch,kind", [("granite-moe-3b-a800m", "reduced"),
                                       ("granite-moe-3b-a800m", "pattern"),
                                       ("grok-1-314b", "reduced")])
def test_moe_routes_equal_over_the_model_axis(arch, kind, t):
    """The router's column shards gathered give one position's routes:
    the same experts, queue positions and drops, gates and ``aux``, bit
    for bit (at t=4 one column a position, logits formed from the slices
    would move gates by an ulp); and the expert-parallel MoE's output
    within 1e-5 of ``moe_glu``'s."""
    from repro_torch.models import moe
    cfg = _config(arch, kind)
    g = torch.Generator().manual_seed(t)
    n, grp, d, E = 2, cfg.moe_group, cfg.d_model, cfg.n_experts
    x = torch.randn(n * grp, d, generator=g) + 0.5
    router = torch.randn(d, E, generator=g)
    router[:, 0] += 2.0 / d ** 0.5                # expert 0 crowded: its queue drops
    cap = moe.moe_capacity(grp, cfg.top_k, E, cfg.capacity_factor)
    want = moe._route(moe._softmax(x.view(n, grp, d) @ router), cfg.top_k, cap)
    got = moe.routes(x, list(router.chunk(t, 1)), top_k=cfg.top_k, capacity=cap, n=n,
                     g=grp)
    for a, b, name in zip(got, want, ("gates", "experts", "pos", "keep", "aux")):
        assert torch.equal(a, b), name
    assert not bool(want[3].all())              # some (token, slot)s are dropped
    ws = [torch.randn(E, d, cfg.d_ff, generator=g) / d ** 0.5 for _ in range(2)]
    w_down = torch.randn(E, cfg.d_ff, d, generator=g) / cfg.d_ff ** 0.5
    xb = x.view(n, grp, d)
    y, aux = moe.moe_glu(xb, router, ws[0], ws[1], w_down, top_k=cfg.top_k, group_size=grp,
                         capacity_factor=cfg.capacity_factor, activation=cfg.activation)
    yp, auxp = moe.moe_glu_sharded(
        xb, list(router.chunk(t, 1)), list(ws[0].chunk(t)), list(ws[1].chunk(t)),
        list(w_down.chunk(t)), (CPU,) * t, top_k=cfg.top_k, group_size=grp,
        capacity_factor=cfg.capacity_factor, activation=cfg.activation)
    assert torch.equal(auxp, aux)
    assert float((yp - y).abs().max()) <= 1e-5 * float(y.abs().max())


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("arch,kind", GRAD_CASES)
def test_eq6_per_shard_of_expert_and_ssm_leaves_is_bitwise(arch, kind, m):
    """fp32 Eq. 6 on each shard of every split leaf at t=2 and t=4 (the
    expert, SSM and narrowed attention leaves among them) concatenates to
    the whole leaf's Eq. 6 bit for bit."""
    model = _model(arch, kind)
    g = torch.Generator().manual_seed(m)
    wts = torch.rand(m, generator=g) * 100
    for t in (2, 4):
        dims = sharding.placements(T.param_specs(model.cfg), _mesh(t))
        for k, p in T.train_params(model).items():
            if dims[k] is None or not k.startswith("layers.0."):
                continue
            deltas = torch.randn((m,) + p.shape, generator=g)
            whole = ops.fedavg_agg(deltas.reshape(m, -1), wts).reshape(p.shape)
            parts = [ops.fedavg_agg(s.contiguous().reshape(m, -1), wts).reshape(s.shape[1:])
                     for s in deltas.chunk(t, 1 + dims[k])]
            assert torch.equal(torch.cat(parts, dims[k]), whole), (t, k)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_pattern_configs_split_as_the_full_configs(arch, t):
    """Each ``PATTERN`` config splits the same leaves along the same
    dimensions as its full config (layer 0 and the top-level leaves), and
    keeps its head, KV-group and SSD-head counts."""
    full, pat = C.get(arch), _config(arch, "pattern")
    want = sharding.placements(T.param_specs(full), AbstractMesh(("mediator", "model"), (1, t)))
    got = sharding.placements(T.param_specs(pat), AbstractMesh(("mediator", "model"), (1, t)))
    for k, d in got.items():
        if not k.startswith("layers.") or k.startswith("layers.0."):
            assert want[k] == d, k
    assert (pat.n_heads, pat.n_kv_heads, pat.ssm_heads, pat.n_experts) == \
        (full.n_heads, full.n_kv_heads, full.ssm_heads, full.n_experts)


@pytest.mark.parametrize("arch,needs", [("whisper-base", "enc_feats"),
                                        ("internvl2-1b", "vision_embeds")])
def test_tp_round_of_other_families_raises(arch, needs):
    """An audio model's or a VLM's round on a mesh raises the same
    ``ValueError`` as its t=1 round (a round's batch holds no frames or
    vision embeddings), full-delta and over an adapter state; the
    tensor-parallel forward given them raises too (no path for them)."""
    cfg = C.reduced(C.get(arch))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    params = T.train_params(model)
    tokens, labels, w = _batch(cfg, rows=2)
    with pytest.raises(ValueError, match=needs):
        steps.make_fl_round(model, 2, local_steps=1, mesh=_mesh())(params, tokens, labels, w)
    mapping = T.adapter_mapping(cfg, 2)
    with pytest.raises(ValueError, match=needs):
        steps.make_fl_round(model, 2, local_steps=1, mesh=_mesh(), lora_mapping=mapping)(
            params, lora_lib.init_adapter_A(1, mapping),
            lora_lib.init_adapter_state(mapping, params), tokens, labels, w)
    dims = sharding.placements(T.param_specs(cfg), _mesh())
    tp = T.TensorParallel(model, dims, (CPU, CPU), CPU)
    batch = {"tokens": tokens, "labels": labels,
             needs: torch.zeros(2, cfg.vision_tokens or cfg.source_positions, cfg.d_model)}
    with pytest.raises(ValueError, match="no tensor-parallel path"):
        T.forward_train(model, batch, _tree(params, dims, 2), tp)


def test_unservable_placement_raises_by_name():
    """Query heads split over the positions with fewer KV groups than
    positions (3:1 at t=2 after a config change), and experts split along
    d_ff (3 experts at t=2), raise a ``ValueError`` naming the config."""
    cfg = dataclasses.replace(_config("hymba-1.5b", "pattern"), n_heads=5, n_kv_heads=1,
                              name="hymba-5-1")
    dims = sharding.placements(T.param_specs(cfg), _mesh())
    with pytest.raises(ValueError, match="hymba-5-1.*whole ones"):
        T.check_tp(cfg, dims, 2)
    moe_cfg = dataclasses.replace(_config("granite-moe-3b-a800m", "pattern"), n_experts=3,
                                  top_k=2, name="granite-3x")
    dims = sharding.placements(T.param_specs(moe_cfg), _mesh())
    with pytest.raises(ValueError, match="granite-3x.*expert axis"):
        T.check_tp(moe_cfg, dims, 2)


@pytest.mark.parametrize("arch", TP_ARCHS + ("internvl2-1b",) + FAMILIES)
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


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_full_config_placements_are_the_references(arch, t):
    """``placements`` over the full configs' specs (hymba's 25:5 heads, its
    odd ``in_proj`` and vocabulary; granite's 40 experts; mamba2's packed
    ``in_proj``) equal the reference's ``spec_for`` under
    ``model_only_rules`` at t positions, the layer axis dropped."""
    am = abstract_mesh((1, t), ("mediator", "model"))
    want = RS.param_shardings(RT.param_specs(RC.get(arch)), am, RS.model_only_rules())
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    specs = T.param_specs(C.get(arch))
    dims = sharding.placements(specs, AbstractMesh(("mediator", "model"), (1, t)))
    for k, sp in specs.items():
        ref = want[k.replace(".", "/")]
        ref_dim = next((i for i, e in enumerate(ref) if e == "model"), None)
        stacked = not (len(sp.names) == 1 and sp.names[0] == k)
        assert dims[sp.names[0]] == (None if ref_dim is None else ref_dim - stacked), k


def test_scatter_and_gather_narrow_are_exact():
    """``scatter_to_positions`` is ``split``'s cut and its backward the
    gather of the slices' gradients; ``gather_narrow`` is the whole
    weight's slice, bit for bit, and its backward lands each gradient
    element in the shard it came from (zero elsewhere)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 12, generator=g, requires_grad=True)
    parts = model_axis.scatter_to_positions(x, 1, (CPU,) * 3)
    for got, want in zip(parts, model_axis.split(x.detach(), 1, (CPU,) * 3)):
        assert torch.equal(got, want)
    sum((p * (i + 1)).sum() for i, p in enumerate(parts)).backward()
    assert torch.equal(x.grad, torch.arange(1., 4.).repeat_interleave(4).expand(4, 12))
    with pytest.raises(ValueError, match="does not split"):
        model_axis.scatter_to_positions(x, 1, (CPU,) * 5)
    w = torch.randn(6, 10, generator=g)
    shards = [s.requires_grad_(True) for s in model_axis.split(w, 1, (CPU, CPU))]
    got = model_axis.gather_narrow(shards, 1, CPU, -1, 3, 4)       # cuts the split at 5
    assert torch.equal(got, w[:, 3:7])
    got.sum().backward()
    assert torch.equal(shards[0].grad, (torch.arange(5) >= 3).float().expand(6, 5))
    assert torch.equal(shards[1].grad, (torch.arange(5) < 2).float().expand(6, 5))
    assert torch.equal(model_axis.gather_narrow([w], None, CPU, 0, 1, 2), w[1:3])


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


@pytest.mark.parametrize("arch,lora", [("granite-moe-3b-a800m", []),
                                       ("hymba-1.5b", ["--lora-rank", "2"])],
                         ids=["granite-full-delta", "hymba-lora"])
def test_fl_train_model_parallel_runs_every_family(arch, lora):
    """``fl_train --model-parallel 2 --arch`` (reduced configs), full-delta
    and with ``--lora-rank``: two rounds against the same at one position,
    the WAN ledgers equal (they do not change with t) and the losses
    within 1e-4."""
    argv = ["--device", "cpu", "--rounds", "2", "--arch", arch] + lora
    out = fl_train.main(argv + ["--model-parallel", "2"])
    solo = fl_train.main(argv)
    assert all(np.isfinite(out["losses"]))
    assert out["ledger"] == solo["ledger"] and out["ratio"] == solo["ratio"]
    np.testing.assert_allclose(out["losses"], solo["losses"], rtol=1e-4)
