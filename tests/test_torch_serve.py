"""Port slice 2 against the JAX reference: serving Hymba (configs, params,
layers, the SSD scan, and the whole prefill + decode) on the CPU.

The reduced Hymba here has grouped KV heads (``n_kv_heads=2`` under 4
query heads; ``reduced`` alone gives 4:4) and the reference's own weights,
drawn by ``repro.models.transformer.init_params`` and converted.  That
init takes the fan-in of a stacked layer weight from the layer axis
(scale 1/sqrt(2) here), so activations run to hundreds and fp32 rounding
of reordered sums shows at ~1e-5 of each tensor's scale; the tolerances
below are relative to the largest value of the tensor compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.models import layers as RL                             # noqa: E402
from repro.models import ssm as RS                                # noqa: E402
from repro.models import transformer as RT                        # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.convert import (transformer_params_from_jax,     # noqa: E402
                                 transformer_params_to_jax)
from repro_torch.kernels import ops                               # noqa: E402
from repro_torch.launch import serve as pserve                    # noqa: E402
from repro_torch.models import layers as PL                       # noqa: E402
from repro_torch.models import ssm as PS                          # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402

# fp32 parity bound, relative to the compared tensor's largest magnitude
REL = 2e-4


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"
    return err


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(**upd):
    """(reference cfg, port cfg): reduced Hymba with GQA, same fields."""
    rcfg = dataclasses.replace(RC.reduced(RC.get("hymba-1.5b")), n_kv_heads=2, **upd)
    pcfg = dataclasses.replace(PC.reduced(PC.get("hymba-1.5b")), n_kv_heads=2, **upd)
    return rcfg, pcfg


def _port_model(pcfg, params):
    model = PT.Transformer(pcfg)
    model.load_state_dict(transformer_params_from_jax(jax.tree.map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def hymba():
    rcfg, pcfg = _pair()
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, pcfg, params, _port_model(pcfg, params)


# ---------------------------------------------------------------- configs

def test_configs_match_reference():
    full = PC.get("hymba-1.5b")
    assert dataclasses.asdict(full) == dataclasses.asdict(RC.get("hymba-1.5b"))
    assert dataclasses.asdict(PC.reduced(full)) == \
        dataclasses.asdict(RC.reduced(RC.get("hymba-1.5b")))
    assert full.torch_dtype() == torch.bfloat16
    assert PC.reduced(full).torch_dtype() == torch.float32
    for arch in ("granite-moe", "no-such-arch"):
        with pytest.raises(KeyError):
            PC.get(arch)


# the families the serving path registers beside Hymba, with their
# parameter counts at full width
ZOO = {"gemma-2b": 2_506_172_416, "qwen3-4b": 4_022_468_096,
       "h2o-danube-1.8b": 1_831_201_280, "mamba2-370m": 368_338_432}


@pytest.mark.parametrize("arch", list(ZOO))
def test_zoo_configs_match_reference(arch):
    """Every field of the full and the reduced config equals the
    reference's; the parameter count too, at full width."""
    full = PC.get(arch)
    assert arch in PC.ARCH_IDS and full.name == arch
    assert dataclasses.asdict(full) == dataclasses.asdict(RC.get(arch))
    assert dataclasses.asdict(PC.reduced(full)) == dataclasses.asdict(RC.reduced(RC.get(arch)))
    assert PT.param_count(full) == RT.param_count(RC.get(arch)) == ZOO[arch]


@pytest.mark.parametrize("variant", ["hymba", "reduced", "ssm", "dense-bias-qknorm-tied"])
def test_param_count_and_specs_match_reference(variant):
    base = dict(hymba=RC.get("hymba-1.5b"), reduced=RC.reduced(RC.get("hymba-1.5b")))
    rcfg = base.get(variant, RC.reduced(RC.get("hymba-1.5b")))
    if variant == "ssm":
        rcfg = dataclasses.replace(rcfg, arch_type="ssm", n_heads=0, n_kv_heads=0)
    if variant.startswith("dense"):
        rcfg = dataclasses.replace(rcfg, arch_type="dense", qkv_bias=True, qk_norm=True,
                                   tie_embeddings=True, ssm_heads=0, ssm_state=0)
    pcfg = PC.ArchConfig(**dataclasses.asdict(rcfg))
    assert PT.param_count(pcfg) == RT.param_count(rcfg)
    if variant == "hymba":
        assert PT.param_count(pcfg) == 1_393_625_120
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = (tuple(v.shape), v.scale)
    walk(RT.param_specs(rcfg))
    ours = {k: (s.shape, s.scale) for k, s in PT.param_specs(pcfg).items()}
    assert ours == flat


def test_unknown_arch_type_raises():
    """Every family of the reference is ported; an arch_type outside them
    raises ``ValueError`` (``Transformer``, ``param_specs``, ``init_cache``)."""
    cfg = dataclasses.replace(PC.reduced(PC.get("hymba-1.5b")), arch_type="diffusion")
    with pytest.raises(ValueError, match="unknown arch_type"):
        PT.Transformer(cfg)
    with pytest.raises(ValueError, match="unknown arch_type"):
        PT.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------- params

def _zoo_pair(arch):
    """(reference cfg, port cfg): the reduced family; gemma at its full
    head dim 256 (``reduced`` sets 64) in both packages."""
    upd = dict(head_dim=256) if arch == "gemma-2b" else {}
    return (dataclasses.replace(RC.reduced(RC.get(arch)), **upd),
            dataclasses.replace(PC.reduced(PC.get(arch)), **upd))


def _round_trip(params, model):
    tree = jax.tree.map(np.asarray, params)
    state = transformer_params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v)
    back = transformer_params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    return state


def test_transformer_params_round_trip(hymba):
    rcfg, pcfg, params, model = hymba
    _round_trip(params, model)


@pytest.mark.parametrize("arch", list(ZOO))
def test_zoo_params_round_trip(arch):
    """The reference's weights carried across and back for each family:
    tied embeddings (no ``lm_head``; danube keeps its own), qwen3's qk-norm
    scales, mamba2's attention-free SSM stack."""
    rcfg, pcfg = _zoo_pair(arch)
    params = RT.init_params(jax.random.PRNGKey(1), rcfg)
    state = _round_trip(params, _port_model(pcfg, params))
    assert ("lm_head" in state) == (arch == "h2o-danube-1.8b") != pcfg.tie_embeddings
    assert ("layers.0.attn.q_norm" in state) == (arch == "qwen3-4b")
    assert ("layers.1.attn.wq" in state) == (arch != "mamba2-370m")
    assert ("layers.1.ssm.A_log" in state) == (arch == "mamba2-370m")
    if arch == "gemma-2b":
        assert state["layers.0.attn.wk"].shape == (pcfg.d_model, 256)


def test_transformer_params_bf16_round_trip():
    rcfg = dataclasses.replace(RC.reduced(RC.get("hymba-1.5b")), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(3), rcfg))
    state = transformer_params_from_jax(tree)
    assert state["layers.1.attn.wq"].dtype == torch.bfloat16
    assert state["final_norm"].dtype == torch.float32
    back = transformer_params_to_jax(state)
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"],
                                  tree["layers"]["attn"]["wq"].astype(np.float32))


def test_init_model_follows_reference_rule():
    rcfg, pcfg = _pair()
    gen = torch.Generator().manual_seed(0)
    model = PT.init_model(pcfg, gen)
    sd = model.state_dict()
    ref = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), rcfg))
    assert torch.equal(sd["layers.0.norm1"], torch.zeros(pcfg.d_model))
    assert torch.equal(sd["layers.1.ssm.dt_bias"], torch.zeros(pcfg.ssm_heads))
    # the fan-in of a stacked weight is the layer count, in both packages
    for name, path in (("layers.0.attn.wq", ("attn", "wq")),
                       ("layers.1.mlp.w_down", ("mlp", "w_down"))):
        want = ref["layers"][path[0]][path[1]].std()
        assert abs(float(sd[name].std()) - want) < 0.05 * want
    assert abs(float(sd["embed"].std()) - pcfg.d_model ** -0.5) < 0.05 * pcfg.d_model ** -0.5
    again = PT.init_model(pcfg, torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(again[k], v) for k, v in sd.items())


# ---------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    _close(PL.rms_norm(_t(x), _t(scale)), RL.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
           rel=1e-6)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    _close(PL.apply_rope(_t(x), _t(pos)), RL.apply_rope(jnp.asarray(x), jnp.asarray(pos)),
           rel=2e-6)
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.2 for s in ((32, 48), (32, 48), (48, 32))]
    for act in ("silu", "gelu"):
        _close(PL.glu_mlp(_t(h), *map(_t, w), act),
               RL.glu_mlp(jnp.asarray(h), *map(jnp.asarray, w), act), rel=2e-6)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 1, 4, 64)).astype(np.float32)
    kc = rng.normal(size=(3, 10, 2, 64)).astype(np.float32)
    vc = rng.normal(size=(3, 10, 2, 64)).astype(np.float32)
    cache_len = np.array([3, 10, 7], np.int32)
    got = PL.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len), window=window)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(cache_len), window=window)
    _close(got, want, rel=2e-6)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_matches_reference(with_tail):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_tail else None
    y, t = PS.causal_conv1d(_t(x), _t(w), _t(b), None if tail is None else _t(tail))
    yr, tr = RS.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if tail is None else jnp.asarray(tail))
    _close(y, yr, rel=1e-6)
    _close(t, tr, rel=0)


# ---------------------------------------------------------------- SSD scan

def _ssd_args(seed, b=2, l=48, h=3, p=16, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(b, l, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, l, n)) * 0.5).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, init


@pytest.mark.parametrize("chunk,with_init", [(16, False), (16, True), (8, True), (48, False)])
def test_ssd_chunked_matches_reference(chunk, with_init):
    """The port's scan (plain ``ssd_chunk`` + chunk loop + ``y_off`` +
    skip) against ``repro.models.ssm.ssd_chunked``, with and without an
    initial state: fp32, 1e-5 of each output's scale."""
    x, dt, A, B, C, D, init = _ssd_args(chunk)
    init = init if with_init else None
    y, state = PS.ssd_chunked(*map(_t, (x, dt, A, B, C, D)), chunk,
                              None if init is None else _t(init))
    yr, sr = RS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk,
                            None if init is None else jnp.asarray(init))
    _close(y, yr, rel=1e-5)
    _close(state, sr, rel=1e-5)


def test_ssd_chunked_rejects_ragged_length():
    x, dt, A, B, C, D, _ = _ssd_args(0, l=20)
    with pytest.raises(ValueError):
        PS.ssd_chunked(*map(_t, (x, dt, A, B, C, D)), 16)


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, D, state = _ssd_args(5, l=1)
    y, s = PS.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(B[:, 0]), _t(C[:, 0]),
                              _t(D), _t(state))
    yr, sr = RS.ssd_decode_step(jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]), jnp.asarray(A),
                                jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]), jnp.asarray(D),
                                jnp.asarray(state))
    _close(y, yr, rel=1e-6)
    _close(s, sr, rel=1e-6)


# ---------------------------------------------------------------- whole slice

@pytest.mark.parametrize("prompt", [64, 128])
def test_prefill_and_decode_match_reference(hymba, prompt):
    """Prompt >= W (64): the port's prefill logits and every cache leaf,
    then 4 teacher-forced decode steps' logits and caches, against the
    reference's ``forward_prefill``/``forward_decode`` on the same params.
    The ring buffer wraps from the first decode step."""
    rcfg, pcfg, params, model = hymba
    b, steps = 2, 4
    toks = np.random.default_rng(prompt).integers(0, rcfg.vocab, (b, prompt + steps))
    lr, cr = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :prompt],
                                                                     jnp.int32)},
                                pad_to=prompt + steps)
    lp, cp = PT.forward_prefill(model, {"tokens": _t(toks[:, :prompt])}, pad_to=prompt + steps)
    _close(lp, lr)
    for blk in ("attn", "ssm"):
        for leaf in cr[blk]:
            _close(cp[blk][leaf], cr[blk][leaf])
    decode = jax.jit(lambda p, bt, c: RT.forward_decode(p, rcfg, bt, c))
    for i in range(steps):
        pos = prompt + i
        tok = toks[:, pos:pos + 1]
        lr, cr = decode(params, {"tokens": jnp.asarray(tok, jnp.int32),
                                 "positions": jnp.full((b,), pos, jnp.int32)}, cr)
        lp, cp = PT.forward_decode(model, {"tokens": _t(tok),
                                           "positions": torch.full((b,), pos)}, cp)
        _close(lp, lr)
    for blk in ("attn", "ssm"):
        for leaf in cr[blk]:
            _close(cp[blk][leaf], cr[blk][leaf])


def test_decode_after_short_prompt_matches_full_prefix_prefill(hymba):
    """Prompt (32) shorter than the window (64).  The reference's
    ``forward_prefill`` skips its ``pad_to`` growth for sliding-window
    models (``transformer.py:641``), so its attention cache has only 32
    slots; ``forward_decode`` then writes slot ``pos % W = 32``, which
    ``dynamic_update_slice`` clamps onto slot 31, and its decode goes wrong
    from the second step.  The port sizes the ring as ``init_cache`` does.
    Each decode step's logits must equal the reference's
    ``forward_prefill`` over the teacher-forced prefix (run with
    ``ssm_chunk=1`` so every prefix length divides; SSD is exact for any
    chunk, and the prompt is prefilled with chunks of 8)."""
    rcfg, pcfg, params, _ = hymba
    rcfg, rcfg1 = (dataclasses.replace(rcfg, ssm_chunk=c) for c in (8, 1))
    model = _port_model(dataclasses.replace(pcfg, ssm_chunk=8), params)
    b, prompt, steps = 2, 32, 4
    toks = np.random.default_rng(7).integers(0, rcfg.vocab, (b, prompt + steps))
    lp, cp = PT.forward_prefill(model, {"tokens": _t(toks[:, :prompt])}, pad_to=prompt + steps)
    assert cp["attn"]["k"].shape[2] == prompt + steps
    _, cr = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :prompt],
                                                                    jnp.int32)},
                               pad_to=prompt + steps)
    ref_errs = []
    for i in range(steps):
        pos = prompt + i
        tok = toks[:, pos:pos + 1]
        lp, cp = PT.forward_decode(model, {"tokens": _t(tok),
                                           "positions": torch.full((b,), pos)}, cp)
        want, _ = RT.forward_prefill(params, rcfg1,
                                     {"tokens": jnp.asarray(toks[:, :pos + 1], jnp.int32)})
        _close(lp, want)
        lr, cr = RT.forward_decode(params, rcfg, {"tokens": jnp.asarray(tok, jnp.int32),
                                                  "positions": jnp.full((b,), pos,
                                                                        jnp.int32)}, cr)
        ref_errs.append(float(np.abs(np.asarray(lr) - np.asarray(want)).max()))
    # the reference defect shows: its own decode departs from its prefill
    assert ref_errs[0] < 1e-3 < max(ref_errs[1:]), ref_errs


def _match_prefill_and_decode(rcfg, params, model, *, prompt, steps, seed):
    """Prefill logits and cache, ``steps`` teacher-forced decode steps'
    logits, and the cache after them: the port against the reference."""
    b = 2
    toks = np.random.default_rng(seed).integers(0, rcfg.vocab, (b, prompt + steps))
    lr, cr = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :prompt],
                                                                     jnp.int32)},
                                pad_to=prompt + steps)
    lp, cp = PT.forward_prefill(model, {"tokens": _t(toks[:, :prompt])}, pad_to=prompt + steps)
    _close(lp, lr)
    ref_leaves = {k: cr[k] for k in ("k", "v", "state", "conv") if k in cr}
    ref_leaves.update({k: v for blk in ("attn", "ssm") for k, v in cr.get(blk, {}).items()})
    port_leaves = {k: v for blk in cp.values() for k, v in blk.items()}
    assert set(port_leaves) == set(ref_leaves)
    for k in ref_leaves:
        _close(port_leaves[k], ref_leaves[k])
    for i in range(steps):
        pos = prompt + i
        tok = toks[:, pos:pos + 1]
        lr, cr = RT.forward_decode(params, rcfg, {"tokens": jnp.asarray(tok, jnp.int32),
                                                  "positions": jnp.full((b,), pos,
                                                                        jnp.int32)}, cr)
        lp, cp = PT.forward_decode(model, {"tokens": _t(tok),
                                           "positions": torch.full((b,), pos)}, cp)
        _close(lp, lr)
    port_leaves = {k: v for blk in cp.values() for k, v in blk.items()}
    ref_leaves = {k: cr[k] for k in ("k", "v", "state", "conv") if k in cr}
    ref_leaves.update({k: v for blk in ("attn", "ssm") for k, v in cr.get(blk, {}).items()})
    for k in ref_leaves:
        _close(port_leaves[k], ref_leaves[k])


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_other_families_prefill_and_decode_match_reference(family):
    """The dense and SSM branches of the stack, on variants of the reduced
    Hymba: dense with QKV bias, qk-norm, tied and scaled embeddings, GeGLU
    and full attention (the cache grows to ``pad_to``); SSM attention-free.
    Prefill logits and cache, then 3 decode steps, against the reference."""
    upd = dict(arch_type="ssm", n_heads=0, n_kv_heads=0) if family == "ssm" else \
        dict(arch_type="dense", qkv_bias=True, qk_norm=True, tie_embeddings=True,
             embed_scale=True, activation="gelu", sliding_window=None, ssm_heads=0,
             ssm_state=0)
    rcfg = dataclasses.replace(RC.reduced(RC.get("hymba-1.5b")), **upd)
    pcfg = PC.ArchConfig(**dataclasses.asdict(rcfg))
    params = RT.init_params(jax.random.PRNGKey(5), rcfg)
    _match_prefill_and_decode(rcfg, params, _port_model(pcfg, params), prompt=64, steps=3,
                              seed=9)


@pytest.mark.parametrize("arch", list(ZOO))
def test_zoo_prefill_and_decode_match_reference(arch):
    """Each registered family, reduced, on the reference's weights: prefill
    logits and every cache leaf, then 4 teacher-forced decode steps,
    against ``forward_prefill``/``forward_decode``.  Gemma at head dim 256
    (the flash wrapper's plain version at that width); danube's prompt is
    2W (128 for the reduced window of 64), since the reference's decode
    after a prompt shorter than W is wrong (see the short-prompt test
    above); mamba2's is two whole chunks."""
    rcfg, pcfg = _zoo_pair(arch)
    params = RT.init_params(jax.random.PRNGKey(2), rcfg)
    _match_prefill_and_decode(rcfg, params, _port_model(pcfg, params), prompt=128, steps=4,
                              seed=11)


def test_prefill_cache_budget_and_checks(hymba):
    rcfg, pcfg, params, model = hymba
    toks = _t(np.zeros((1, 64), np.int64))
    _, cache = PT.forward_prefill(model, {"tokens": toks})
    assert cache["attn"]["k"].shape[2] == pcfg.sliding_window
    _, cache = PT.forward_prefill(model, {"tokens": toks}, pad_to=200)
    assert cache["attn"]["k"].shape[2] == pcfg.sliding_window
    assert cache["ssm"]["state"].dtype == torch.float32
    with pytest.raises(ValueError):
        PT.forward_prefill(model, {"tokens": toks}, pad_to=8)
    with pytest.raises(ValueError):                     # 40 is not a multiple of 64
        PT.forward_prefill(model, {"tokens": toks[:, :40]})


# ---------------------------------------------------------------- entry points

def test_serve_runs_on_cpu():
    ops.reset_launches()
    cfg = dataclasses.replace(PC.reduced(PC.get("hymba-1.5b")), n_kv_heads=2)
    r = pserve.serve(cfg, batch=2, prompt_len=64, tokens=4, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    assert r["tokens"].shape == (2, 4) and r["logits_finite"]
    assert len(r["decode_step_s"]) == 3
    assert r["params"] == PT.param_count(cfg)
    # CPU tensors take the plain versions: no kernel launches
    assert set(r["prefill_launches"].values()) == {0}
    again = pserve.serve(cfg, batch=2, prompt_len=64, tokens=4, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(again["tokens"], r["tokens"])


def test_serve_takes_a_built_model():
    """A model built from the generator and handed in serves the same
    tokens as one ``serve`` builds from that generator itself."""
    cfg = dataclasses.replace(PC.reduced(PC.get("hymba-1.5b")), n_kv_heads=2)
    kw = dict(batch=2, prompt_len=64, tokens=3, device="cpu")
    r = pserve.serve(cfg, generator=torch.Generator().manual_seed(2), **kw)
    gen = torch.Generator().manual_seed(2)
    model = PT.init_model(cfg, gen, device="cpu")
    again = pserve.serve(cfg, generator=gen, model=model, **kw)
    assert torch.equal(again["tokens"], r["tokens"])


def test_serve_cli_on_cpu(capsys):
    r = pserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "64",
                     "--tokens", "3"])
    assert r["tokens"].shape == (2, 3)
    assert "decode:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", list(ZOO))
def test_serve_cli_serves_each_family_on_cpu(arch, capsys):
    """``--arch`` takes every registered family (its reduced variant)."""
    r = pserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                     "--prompt-len", "64", "--tokens", "3"])
    assert r["tokens"].shape == (2, 3) and r["logits_finite"]
    assert r["params"] == PT.param_count(PC.reduced(PC.get(arch)))
    assert "decode:" in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.serve(PC.reduced(PC.get("hymba-1.5b")), batch=1, prompt_len=8, tokens=2)
