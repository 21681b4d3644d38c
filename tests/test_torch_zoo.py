"""Port slice 17 against the JAX reference: the rest of the zoo, served --
MoE (granite-moe-3b-a800m, grok-1-314b), audio (whisper-base), VLM
(internvl2-1b) and qwen1.5-110b -- on the CPU, at the reduced configs in
fp32.

Weights: every leaf is drawn from ``np.random.default_rng(seed)`` over the
reference's ``param_specs`` and carried across by ``convert``, the norm
scales and biases included.  The reference's own init would not do: it
zeroes every norm scale, and Whisper's LayerNorm multiplies by the scale
itself (not ``1 + scale``), so every LayerNorm output -- and with it every
logit -- is exactly 0 at init (``test_whisper_reference_init_gives_zero_logits``).
Matrices are drawn at the standard fan-in ``1/sqrt(d_in)``, LayerNorm
scales around 1, RMS scales, biases and qkv biases around 0.

Tolerance: ``REL``, test_torch_serve.py's fp32 parity bound, relative to
the largest magnitude of the tensor compared.  MoE prompts keep ``b * s`` a
multiple of the reduced group (64) or at most 64, as the reference's
assert asks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.configs.base import make_batch as r_make_batch         # noqa: E402
from repro.models import layers as RL                             # noqa: E402
from repro.models import lora as RLo                              # noqa: E402
from repro.models import moe as RM                                # noqa: E402
from repro.models import transformer as RT                        # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.convert import (transformer_params_from_jax,     # noqa: E402
                                 transformer_params_to_jax)
from repro_torch.launch import serve as pserve                    # noqa: E402
from repro_torch.models import layers as PL                       # noqa: E402
from repro_torch.models import lora as PLo                        # noqa: E402
from repro_torch.models import moe as PM                          # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402

from torch_parity import adapter_tree_to_jax, rand_params         # noqa: E402

# fp32 parity bound, relative to the compared tensor's largest magnitude
# (tests/test_torch_serve.py's REL)
REL = 2e-4

# the five ids this slice registers: (parameters, parameters a token
# touches) at full width, learned positions sized 4,096
NEW = {"granite-moe-3b-a800m": (3_298_793_472, 882_874_368),
       "grok-1-314b": (316_489_340_928, 84_561_106_944),
       "whisper-base": (73_542_144, 73_542_144),
       "internvl2-1b": (493_780_992, 493_780_992),
       "qwen1.5-110b": (111_209_914_368, 111_209_914_368)}


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"
    return err


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch):
    """(reference cfg, port cfg): the reduced family, every field equal."""
    rcfg, pcfg = RC.reduced(RC.get(arch)), PC.reduced(PC.get(arch))
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    return rcfg, pcfg


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _port_model(pcfg, params, max_seq=4096):
    model = PT.Transformer(pcfg, max_seq=max_seq)
    model.load_state_dict(transformer_params_from_jax(jax.tree.map(np.asarray, params)))
    return model


@pytest.fixture(scope="module", params=list(NEW))
def family(request):
    rcfg, pcfg = _pair(request.param)
    params = rand_params(rcfg, 0)
    return request.param, rcfg, pcfg, params, _port_model(pcfg, params)


def _inputs(rcfg, b, rng):
    """A VLM's vision embeddings or an audio model's frame embeddings,
    standard normal, as (reference batch entries, port batch entries)."""
    name, n = {"vlm": ("vision_embeds", rcfg.vision_tokens),
               "audio": ("enc_feats", rcfg.source_positions)}.get(rcfg.arch_type, (None, 0))
    if name is None:
        return {}, {}
    x = rng.normal(size=(b, n, rcfg.d_model)).astype(np.float32)
    return {name: jnp.asarray(x)}, {name: _t(x)}


# ---------------------------------------------------------------- configs

def test_registry_holds_the_ten_ids():
    """The port registers the reference's ten ids in its order, and
    ``Transformer`` builds each at full width (on the meta device: no
    storage) and reduced."""
    assert PC.ARCH_IDS == RC.ARCH_IDS and len(PC.ARCH_IDS) == 10
    for arch in PC.ARCH_IDS:
        full = PC.get(arch)
        model = PT.Transformer(full, device="meta")
        assert sum(p.numel() for p in model.parameters()) == PT.param_count(full)
        PT.Transformer(PC.reduced(full))


@pytest.mark.parametrize("arch", list(NEW))
def test_new_configs_match_reference(arch):
    """Every field of the full and the reduced config, and the parameter
    counts (all and per token) at both widths, equal the reference's."""
    full = PC.get(arch)
    assert full.name == arch
    assert dataclasses.asdict(full) == dataclasses.asdict(RC.get(arch))
    assert dataclasses.asdict(PC.reduced(full)) == dataclasses.asdict(RC.reduced(RC.get(arch)))
    total, active = NEW[arch]
    assert PT.param_count(full) == RT.param_count(RC.get(arch)) == total
    assert PT.active_param_count(full) == RT.active_param_count(RC.get(arch)) == active
    rcfg, pcfg = _pair(arch)
    assert PT.param_count(pcfg) == RT.param_count(rcfg)
    assert PT.active_param_count(pcfg) == RT.active_param_count(rcfg)
    if arch == "whisper-base":                       # learned positions follow max_seq
        assert PT.param_count(full, 448) == RT.param_count(RC.get(arch), 448)


@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", list(NEW))
def test_param_specs_match_reference(arch, width):
    """Leaves, shapes, init scales and dtypes in the reference's order; the
    expert weights batch over ``("layers", "expert")``."""
    rcfg = RC.get(arch) if width == "full" else RC.reduced(RC.get(arch))
    pcfg = PC.ArchConfig(**dataclasses.asdict(rcfg))
    want = _flat_specs(RT.param_specs(rcfg))
    got = PT.param_specs(pcfg)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.scale) == (tuple(w.shape), w.scale), k
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name, k
        batch = tuple(a for a in w.axes[:2] if a in PLo.BATCH_AXES)
        assert g.axes[:len(batch)] == batch, k


def test_make_batch_matches_reference():
    """The VLM's and the audio model's train batches: the reference's keys,
    shapes and dtypes, the stub inputs filled with 0.01 as it fills them;
    the VLM's text span is ``seq_len - vision``."""
    for arch in ("internvl2-1b", "whisper-base"):
        rcfg, pcfg = _pair(arch)
        want = r_make_batch(rcfg, RC.InputShape("t", 64, 2, "train"))["batch"]
        got = PC.make_batch(pcfg, PC.InputShape("t", 64, 2, "train"), seed=3)["batch"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k
            if k not in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert PC.token_split(pcfg, 64) == ((48, 16) if arch == "internvl2-1b" else (64, 0))


# ---------------------------------------------------------------- params

def test_params_round_trip(family):
    """The drawn weights carried across and back: the encoder stack
    unstacked like the decoder's, the reference's names kept."""
    arch, rcfg, pcfg, params, model = family
    tree = jax.tree.map(np.asarray, params)
    state = transformer_params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v)
    back = transformer_params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert ("layers.1.moe.w_gate" in state) == pcfg.is_moe
    assert ("encoder.1.attn.wq" in state) == ("layers.0.xattn.wk" in state) \
        == ("layers.1.mlp.b_in" in state) == (arch == "whisper-base")
    assert ("layers.0.attn.bq" in state) == pcfg.qkv_bias
    if pcfg.is_moe:
        assert state["layers.1.moe.w_gate"].shape == (pcfg.n_experts, pcfg.d_model, pcfg.d_ff)
        assert state["layers.0.moe.router"].dtype == torch.float32


def test_whisper_reference_init_gives_zero_logits():
    """The reference's init zeroes every LayerNorm scale and its LayerNorm
    multiplies by the scale itself, so every logit is exactly 0; the
    port's init follows the same rule and gives the same zeros."""
    rcfg, pcfg = _pair("whisper-base")
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab, (2, 8))
    feats = rng.normal(size=(2, rcfg.source_positions, rcfg.d_model)).astype(np.float32)
    lr, _ = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks, jnp.int32),
                                              "enc_feats": jnp.asarray(feats)})
    assert not np.asarray(lr).any()
    model = PT.init_model(pcfg, torch.Generator().manual_seed(0))
    lp, _ = PT.forward_prefill(model, {"tokens": _t(toks), "enc_feats": _t(feats)})
    assert not lp.any()


# ---------------------------------------------------------------- layers

def test_layer_norm_and_mlp_match_reference():
    """LayerNorm (scale multiplied as it is) and the biased GELU MLP (tanh
    approximation): fp32, 1e-6 of the output's scale."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    for eps in (1e-6, 1e-5):
        _close(PL.layer_norm(_t(x), _t(scale), _t(bias), eps),
               RL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps),
               rel=1e-6)
    w_in = rng.normal(size=(64, 96)).astype(np.float32) / 8
    b_in = rng.normal(size=(96,)).astype(np.float32)
    w_out = rng.normal(size=(96, 64)).astype(np.float32) / 10
    b_out = rng.normal(size=(64,)).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    _close(PL.mlp(*map(_t, args)), RL.mlp(*map(jnp.asarray, args)), rel=1e-6)


# ---------------------------------------------------------------- MoE

# (groups, g, E, top_k, capacity_factor): the reduced config's group, a
# capacity of 0.5 so that tokens drop, granite's full group and experts,
# granite's decode group (4 tokens), grok's experts
ROUTES = [(3, 64, 4, 2, 1.25), (3, 64, 8, 2, 0.5), (2, 512, 40, 8, 1.25), (3, 4, 40, 8, 1.25),
          (3, 64, 8, 2, 1.0)]


@pytest.mark.parametrize("n,g,E,k,cf", ROUTES)
def test_route_topk_matches_reference(n, g, E, k, cf):
    """The router on the same fp32 logits (seeded normals: no two
    probabilities of a token tie, so ``torch.topk`` and ``lax.top_k`` pick
    the same experts in the same order).  Dispatch -- which (token, slot)
    sits in which expert's queue, and which are dropped -- is exactly the
    reference's.  From the reference's own softmax the combine weights are
    too, bit for bit; torch's fp32 ``exp`` and XLA's differ in the last
    bit, so from the logits they agree within 2 ulps of 1.  The aux term
    sums over tokens and experts in another order: within 2^-20 of it."""
    capacity = PM.moe_capacity(g, k, E, cf)
    assert capacity == RM.moe_capacity(g, k, E, cf)
    logits = (np.random.default_rng(g * E + k).normal(size=(n, g, E)) * 2).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for row in probs.reshape(-1, E):
        assert len(np.unique(row)) == E                       # tie-free
    d_r, c_r, a_r = (np.asarray(t) for t in jax.vmap(
        lambda lg: RM.route_topk(lg, k, capacity))(jnp.asarray(logits)))
    d_p, c_p, a_p = PM.route_topk(_t(logits), k, capacity)
    np.testing.assert_array_equal(d_p.numpy(), d_r)
    assert float(np.abs(c_p.numpy() - c_r).max()) <= 2 ** -23
    np.testing.assert_allclose(a_p.numpy(), a_r, rtol=2 ** -20, atol=0)
    d_q, c_q, a_q = PM.route_topk_from_probs(_t(probs), k, capacity)
    np.testing.assert_array_equal(d_q.numpy(), d_r)
    np.testing.assert_array_equal(c_q.numpy(), c_r)
    np.testing.assert_allclose(a_q.numpy(), a_r, rtol=2 ** -20, atol=0)
    kept = int(d_r.sum())
    assert kept <= n * g * k
    if cf < 1.0:                                          # the queues overflow
        assert kept < n * g * k


@pytest.mark.parametrize("b,s,E,k,cf,act", [(2, 64, 4, 2, 1.25, "silu"),
                                            (2, 64, 8, 2, 0.5, "gelu"),
                                            (1, 4, 8, 2, 1.25, "silu")])
def test_moe_glu_matches_reference(b, s, E, k, cf, act):
    """``moe_glu`` by index (the port's path) and by the reference's one-hot
    einsums, against ``repro.models.moe.moe_glu``: output within 1e-6 of
    its scale, the mean aux term within 2^-20 of it; the two forms agree
    with each other within 1e-6 too.  Two groups, one with drops, and a
    4-token group (decode)."""
    d, f = 32, 16
    rng = np.random.default_rng(b * s + E)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32)
    w_gate, w_up = ((rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32)
                    for _ in range(2))
    w_down = (rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32)
    args = (x, router, w_gate, w_up, w_down)
    kw = dict(top_k=k, group_size=64, capacity_factor=cf, activation=act)
    y_r, a_r = RM.moe_glu(*map(jnp.asarray, args), **kw)
    y_i, a_i = PM.moe_glu(*map(_t, args), **kw)
    y_o, a_o = PM.moe_glu(*map(_t, args), **kw, onehot=True)
    for y, a in ((y_i, a_i), (y_o, a_o)):
        _close(y, y_r, rel=1e-6)
        np.testing.assert_allclose(float(a), float(a_r), rtol=2 ** -20)
    _close(y_i, y_o.numpy(), rel=1e-6)


@pytest.mark.parametrize("b,s,E,k,cf,act", [(2, 64, 4, 2, 1.25, "silu"),
                                            (2, 64, 8, 2, 0.5, "gelu"),
                                            (2, 64, 8, 3, 0.5, "silu"),
                                            (1, 4, 8, 2, 1.25, "silu")])
def test_moe_glu_gradients_match_onehot_and_reference(b, s, E, k, cf, act):
    """The index form's backward (``moe._Gather``: each token's gradient its
    ``top_k`` buffer rows' summed in fp32, each buffer row's its one
    (token, slot)'s) against autograd through the one-hot einsums and
    against ``jax.grad`` of the reference's ``moe_glu``: the gradients of x,
    the router and the three expert weights of ``<y, dy> + 0.37 aux``, each
    within 1e-6 of its largest magnitude (at least 1, as ``_close`` takes
    it; fp32 sums in other orders).  Drops (cf 0.5),
    top 3 and a 4-token group among the cases."""
    d, f = 32, 16
    rng = np.random.default_rng(b * s + E + k)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32)
    w_gate, w_up = ((rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32)
                    for _ in range(2))
    w_down = (rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32)
    dy = rng.normal(size=(b, s, d)).astype(np.float32)
    args = (x, router, w_gate, w_up, w_down)
    kw = dict(top_k=k, group_size=64, capacity_factor=cf, activation=act)

    def port_grads(onehot):
        leaves = [_t(a).requires_grad_(True) for a in args]
        y, aux = PM.moe_glu(*leaves, **kw, onehot=onehot)
        return torch.autograd.grad((y * _t(dy)).sum() + 0.37 * aux, leaves)

    def ref_loss(*a):
        y, aux = RM.moe_glu(*a, **kw)
        return (y * jnp.asarray(dy)).sum() + 0.37 * aux

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    by_index, by_onehot = port_grads(False), port_grads(True)
    for g, o, w in zip(by_index, by_onehot, want):
        _close(g, o.numpy(), rel=1e-6)
        _close(g, w, rel=1e-6)
    assert all(bool(g.abs().max() > 0) for g in by_index)


def test_moe_group_must_divide_the_tokens():
    x = torch.zeros(1, 96, 8)
    w = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="not divisible"):
        PM.moe_glu(x, torch.zeros(8, 4), w, w, w, top_k=2, group_size=64)


# ---------------------------------------------------------------- training

def _lm_batch(rcfg, seed, b, s):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    ref_in, port_in = _inputs(rcfg, b, rng)
    return ({**{k: jnp.asarray(v) for k, v in batch.items()}, **ref_in},
            {**{k: _t(v) for k, v in batch.items()}, **port_in})


def test_forward_train_matches_reference(family):
    """Loss, aux and every parameter's gradient against
    ``jax.value_and_grad(forward_train)``: the loss within 1e-6 of it, the
    MoE aux within 2^-20, each gradient within ``REL`` of its scale.  The
    VLM's loss covers only its text span; MoE adds ``0.01 * aux``."""
    arch, rcfg, pcfg, params, model = family
    rb, pb = _lm_batch(rcfg, 1, 2, 32)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: RT.forward_train(p, rcfg, rb), has_aux=True)(params)
    leaves = {k: t.clone().requires_grad_(True) for k, t in PT.train_params(model).items()}
    loss, met = PT.forward_train(model, pb, leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(rloss)) <= 1e-6 * abs(float(rloss))
    aux = float(met["aux"].detach())
    np.testing.assert_allclose(aux, float(rmet["aux"]), rtol=2 ** -20)
    assert (aux > 0) == pcfg.is_moe
    want = transformer_params_from_jax(jax.tree.map(np.asarray, rgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        err = float((g - want[name]).abs().max())
        assert err <= REL * scale, f"{arch} {name}: {err} > {REL} x {scale}"


def test_vlm_loss_covers_the_text_after_the_vision_span_given():
    """``make_batch`` at a sequence shorter than twice a VLM's vision tokens
    gives them half of it (``token_split``: 8 of the reduced 16 at seq 16,
    64 of internvl2-1b's 256 at phase 11's 128).  The port's loss covers
    the text after the span given and equals the reference's with
    ``vision_tokens`` set to that span (loss within 1e-6, gradients within
    ``REL``); the reference's own config slices ``cfg.vision_tokens`` off
    and raises on the empty text span."""
    rcfg, pcfg = _pair("internvl2-1b")
    shape = (2, 16)
    assert PC.token_split(pcfg, shape[1]) == (8, 8)
    params = rand_params(rcfg, 2)
    model = _port_model(pcfg, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab, (2, 8)).astype(np.int32)
    vis = rng.normal(size=(2, 8, rcfg.d_model)).astype(np.float32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1)),
          "vision_embeds": jnp.asarray(vis)}
    with pytest.raises(ValueError):
        RT.forward_train(params, rcfg, rb)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RT.forward_train(p, dataclasses.replace(rcfg, vision_tokens=8), rb),
        has_aux=True)(params)
    leaves = {k: t.clone().requires_grad_(True) for k, t in PT.train_params(model).items()}
    pb = {"tokens": _t(toks), "labels": _t(np.roll(toks, -1, 1)), "vision_embeds": _t(vis)}
    loss, _ = PT.forward_train(model, pb, leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(rloss)) <= 1e-6 * abs(float(rloss))
    want = transformer_params_from_jax(jax.tree.map(np.asarray, rgrads))
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= REL * max(scale, 1e-30), name


# ---------------------------------------------------------------- serving

def test_prefill_and_decode_match_reference(family):
    """Prefill logits and every cache leaf (an audio model's encoder output
    too, against ``_run_encoder``), then 3 teacher-forced decode steps'
    logits and the cache after them, against the reference's
    ``forward_prefill``/``forward_decode``.  Batch 2, a 64-token prompt (two
    MoE groups); decode positions count a VLM's vision tokens, and the
    reference's decode is given the ``_run_encoder`` output."""
    arch, rcfg, pcfg, params, model = family
    b, prompt, steps = 2, 64, 3
    rng = np.random.default_rng(11)
    toks = rng.integers(0, rcfg.vocab, (b, prompt + steps))
    ref_in, port_in = _inputs(rcfg, b, rng)
    start = prompt + (rcfg.vision_tokens if rcfg.arch_type == "vlm" else 0)
    lr, cr = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :prompt],
                                                                     jnp.int32), **ref_in},
                                pad_to=start + steps)
    lp, cp = PT.forward_prefill(model, {"tokens": _t(toks[:, :prompt]), **port_in},
                                pad_to=start + steps)
    _close(lp, lr)
    assert set(cp) == ({"attn", "enc_out"} if arch == "whisper-base" else {"attn"})
    for leaf in ("k", "v"):
        _close(cp["attn"][leaf], cr["attn"][leaf])
    extra = {}
    if arch == "whisper-base":
        enc = RT._run_encoder(rcfg, params, ref_in["enc_feats"])
        _close(cp["enc_out"], enc)
        extra = {"enc_out": enc}
    for i in range(steps):
        tok = toks[:, prompt + i:prompt + i + 1]
        lr, cr = RT.forward_decode(params, rcfg, {
            "tokens": jnp.asarray(tok, jnp.int32),
            "positions": jnp.full((b,), start + i, jnp.int32), **extra}, cr)
        lp, cp = PT.forward_decode(model, {"tokens": _t(tok),
                                           "positions": torch.full((b,), start + i)}, cp)
        _close(lp, lr)
    for leaf in ("k", "v"):
        _close(cp["attn"][leaf], cr["attn"][leaf])


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-base"])
def test_decode_equals_prefill_of_the_prefix(arch):
    """The port's decode logits at step ``i`` equal the last logits of the
    port's prefill of the prompt plus ``i + 1`` tokens (the same vision or
    frame embeddings): decode positions start after the vision tokens, and
    decode cross-attends to the encoder output prefill stored -- the two
    places where the reference's serve driver goes wrong."""
    rcfg, pcfg = _pair(arch)
    model = _port_model(pcfg, rand_params(rcfg, 3))
    b, prompt, steps = 2, 24, 3
    rng = np.random.default_rng(5)
    toks = _t(rng.integers(0, rcfg.vocab, (b, prompt + steps)))
    _, port_in = _inputs(rcfg, b, rng)
    start = pserve.prefix_len(pcfg) + prompt
    _, cache = PT.forward_prefill(model, {"tokens": toks[:, :prompt], **port_in},
                                  pad_to=start + steps)
    for i in range(steps):
        got, cache = PT.forward_decode(model, {"tokens": toks[:, prompt + i:prompt + i + 1],
                                               "positions": torch.full((b,), start + i)},
                                       cache)
        want, _ = PT.forward_prefill(model, {"tokens": toks[:, :prompt + i + 1], **port_in})
        _close(got, want.numpy())


def test_learned_positions_past_max_seq_raise():
    """Whisper's learned positions have ``max_seq`` rows; a prefill, a
    decode budget or a decode position past them raises."""
    rcfg, pcfg = _pair("whisper-base")
    model = PT.init_model(pcfg, torch.Generator().manual_seed(0), max_seq=16)
    feats = torch.zeros(1, pcfg.source_positions, pcfg.d_model)
    toks = torch.zeros(1, 8, dtype=torch.long)
    _, cache = PT.forward_prefill(model, {"tokens": toks, "enc_feats": feats}, pad_to=16)
    with pytest.raises(ValueError, match="max_seq"):
        PT.forward_prefill(model, {"tokens": toks, "enc_feats": feats}, pad_to=17)
    with pytest.raises(ValueError, match="max_seq"):
        PT.forward_prefill(model, {"tokens": torch.zeros(1, 17, dtype=torch.long),
                                   "enc_feats": feats})
    PT.forward_decode(model, {"tokens": toks[:, :1], "positions": torch.tensor([15])}, cache)
    with pytest.raises(ValueError, match="max_seq"):
        PT.forward_decode(model, {"tokens": toks[:, :1], "positions": torch.tensor([16])},
                          cache)


# ---------------------------------------------------------------- LoRA

def test_adapter_mapping_of_granite_equals_reference():
    """``adapter_mapping(granite-moe-3b-a800m, 16)`` entry by entry, in the
    reference's order: the expert weights batch over the layer and expert
    axes, the fp32 router over the layers; and the reduced config's merged
    weights equal the reference's ``merge_params`` on the same A and
    state."""
    want = RT.adapter_mapping(RC.get("granite-moe-3b-a800m"), 16)
    got = PT.adapter_mapping(PC.get("granite-moe-3b-a800m"), 16)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert (g.kind, g.shape, g.batch_shape, g.batch_axes, g.din, g.dout, g.rank,
                g.alpha, g.state_shape, g.state_params) == \
            (w.kind, w.shape, w.batch_shape, w.batch_axes, w.din, w.dout, w.rank,
             w.alpha, w.state_shape, w.state_params), path
        if w.kind == "factorized":
            assert g.a_shape == w.a_shape
    assert got["layers/moe/w_gate"].batch_axes == ("layers", "expert")
    assert PLo.num_trainable_params(got) == RLo.num_trainable_params(want)
    # the merge over the expert axis, reduced
    rcfg, pcfg = _pair("granite-moe-3b-a800m")
    params = rand_params(rcfg, 6)
    rmap, pmap = RT.adapter_mapping(rcfg, 4), PT.adapter_mapping(pcfg, 4)
    a_tree = RLo.init_adapter_A(jax.random.PRNGKey(1), rmap)
    rng = np.random.default_rng(7)
    state = {p: (rng.normal(size=e.state_shape) * 0.1).astype(np.float32)
             for p, e in rmap.items()}
    merged = RLo.merge_params(params, a_tree, {p: jnp.asarray(v) for p, v in state.items()},
                              rmap)
    backbone = transformer_params_from_jax(jax.tree.map(np.asarray, params))
    port = PLo.merge_params(backbone, {p: _t(v) for p, v in a_tree.items()},
                            {p: _t(v) for p, v in state.items()}, pmap)
    want_merged = transformer_params_from_jax(jax.tree.map(np.asarray, merged))
    assert set(port) == set(want_merged)
    for name, w in want_merged.items():
        _close(port[name], w.numpy(), rel=1e-6)
    assert adapter_tree_to_jax(PLo.init_adapter_state(pmap, backbone)).keys() == state.keys()


# ---------------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", list(NEW))
def test_serve_cli_serves_each_new_id_on_cpu(arch, capsys):
    """``--arch`` takes each new id and serves its reduced config: the
    stub inputs drawn, finite logits, the parameter count at the decode
    budget's learned positions."""
    r = pserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                     "--prompt-len", "64", "--tokens", "3"])
    assert r["tokens"].shape == (2, 3) and r["logits_finite"]
    assert len(r["decode_step_s"]) == 2
    cfg = PC.reduced(PC.get(arch))
    assert r["params"] == PT.param_count(cfg, pserve.prefix_len(cfg) + 64 + 3)
    assert "decode:" in capsys.readouterr().out
