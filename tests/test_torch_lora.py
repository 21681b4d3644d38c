"""Port slice 11 against the JAX reference: LoRA mapping tables and the
federated round on a transformer, on the CPU.

The mapping table of the full qwen3-4b and gemma-2b configs (specs only,
nothing allocated), the merge rule, ``make_fl_round`` full-delta and over
a LoRA adapter state against the reference's ``make_fl_round`` on
``make_host_mesh()`` (its frozen ``A`` injected: torch cannot replay
``jax.random``), two mediators against two reference rounds combined by
numpy Eq. 6, and the federated launcher.  The model is the reduced
qwen3-4b with the reference's own weights (its qk-norm keeps the
gradients well conditioned at that init: a 1e-7 perturbation of the
weights moves them by 4.5e-6 of their scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.launch import steps as RS                              # noqa: E402
from repro.launch.compat import use_mesh                          # noqa: E402
from repro.launch.mesh import make_host_mesh                      # noqa: E402
from repro.models import lora as RL                               # noqa: E402
from repro.models import transformer as RT                        # noqa: E402
from jax.sharding import PartitionSpec as P                      # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.convert import (adapter_tree_from_jax,           # noqa: E402
                                 transformer_params_from_jax)
from repro_torch.kernels import ops                               # noqa: E402
from repro_torch.launch import fl_train as pfl                    # noqa: E402
from repro_torch.launch import steps as PS                        # noqa: E402
from repro_torch.models import lora as PL                         # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402
from torch_parity import adapter_tree_to_jax, rand_params         # noqa: E402

LR, LOCAL_STEPS, EPOCHS, SEQ = 0.05, 4, 2, 32
# qwen3-4b and granite-moe-3b-a800m at rank 16: the adapter state a leg
# carries (bf16) against the full model, from the reference's own mapping
# (the card run checks it)
R16_LEGS = {"qwen3-4b": (17_931_776, 35_863_552),
            "granite-moe-3b-a800m": (54_670_848, 109_341_696)}
GRANITE = "granite-moe-3b-a800m"


# ---------------------------------------------------------------- mapping

@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma-2b", GRANITE])
@pytest.mark.parametrize("rank", [16, 1])
def test_mapping_of_full_config_equals_reference(arch, rank):
    """Entry by entry, in the reference's order: kind, shapes, rank, alpha,
    state params; and the leg's bytes and the full rank (granite's expert
    weights batched over the layer and expert axes)."""
    want = RT.adapter_mapping(RC.get(arch), rank)
    got = PT.adapter_mapping(PC.get(arch), rank)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert (g.kind, g.shape, g.batch_shape, g.batch_axes, g.din, g.dout, g.rank,
                g.alpha, g.state_shape, g.state_params) == \
            (w.kind, w.shape, w.batch_shape, w.batch_axes, w.din, w.dout, w.rank,
             w.alpha, w.state_shape, w.state_params), path
        if w.kind == "factorized":
            assert g.a_shape == w.a_shape
    for bpp in (2, 4):
        assert PL.exchange_nbytes(got, bpp) == RL.exchange_nbytes(want, bpp)
    assert PL.num_trainable_params(got) == RL.num_trainable_params(want)
    specs = PT.param_specs(PC.get(arch))
    assert PL.full_rank(specs) == RL.full_rank(RT.param_specs(RC.get(arch)))
    if arch in R16_LEGS and rank == 16:
        assert (PL.num_trainable_params(got), PL.exchange_nbytes(got, 2)) == R16_LEGS[arch]


def test_rank_zero_is_empty_and_negative_raises():
    cfg = PC.reduced(PC.get("qwen3-4b"))
    assert PT.adapter_mapping(cfg, 0) == {} == RT.adapter_mapping(RC.reduced(RC.get("qwen3-4b")), 0)
    assert PL.exchange_nbytes({}) == 0
    with pytest.raises(ValueError):
        PT.adapter_mapping(cfg, -1)


# ---------------------------------------------------------------- the round

@pytest.fixture(scope="module")
def setup():
    rcfg = RC.reduced(RC.get("qwen3-4b"))
    pcfg = PC.reduced(PC.get("qwen3-4b"))
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    model = PT.Transformer(pcfg)
    model.load_state_dict(transformer_params_from_jax(jax.tree.map(np.asarray, params)))
    mesh = make_host_mesh()
    spec_tree = jax.tree.map(lambda _: P(), RT.param_specs(rcfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    full = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, learning_rate=LR,
                                    local_steps=LOCAL_STEPS, mediator_epochs=EPOCHS))
    return rcfg, pcfg, params, model, mesh, spec_tree, full


def _stream(seed, rows, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _close_step(got, want, start, rel=1e-4):
    """A round's result against the reference's: the update ``out - start``
    within ``rel`` of the reference update's largest magnitude (fp32 SGD
    from the same start, gradients summed in other orders) plus two fp32
    spacings of the start's largest value (both results are rounded to
    fp32 on top of ``start``)."""
    got, want, start = (np.asarray(x, np.float32) for x in (got, want, start))
    d_ref = want - start
    tol = rel * float(np.abs(d_ref).max()) + 2 * float(np.spacing(np.abs(start).max()))
    err = float(np.abs((got - start) - d_ref).max())
    assert err <= tol, f"{err} > {tol}"
    return float(np.abs(d_ref).max())


def test_full_delta_round_matches_reference(setup):
    """One mediator, ``local_steps=4`` and ``mediator_epochs=2``: every
    weight's update within 1e-4 of the reference's; one Eq. 6 launch a
    leaf (none on the CPU)."""
    rcfg, pcfg, params, model, mesh, _, full = setup
    toks, labels = _stream(1, LOCAL_STEPS, rcfg.vocab)
    weights = np.full((LOCAL_STEPS,), float(SEQ), np.float32)
    with use_mesh(mesh):
        want = full(params, jnp.asarray(toks), jnp.asarray(labels), jnp.asarray(weights))
    want = transformer_params_from_jax(jax.tree.map(np.asarray, want))
    start = PT.train_params(model)
    fl = PS.make_fl_round(model, 1, learning_rate=LR, local_steps=LOCAL_STEPS,
                          mediator_epochs=EPOCHS)
    got = fl(start, torch.from_numpy(toks), torch.from_numpy(labels),
             torch.from_numpy(weights))
    moved = [_close_step(got[k], want[k], start[k]) for k in start]
    assert max(moved) > 1e-3                 # the round really moved the weights
    assert all(torch.equal(start[k], model.state_dict()[k]) for k in start)


def test_two_mediators_equal_two_reference_rounds_and_numpy_eq6(setup):
    """``n_mediators=2``: row block ``m`` is mediator ``m``; the result
    equals ``start + sum_m n_m (out_m - start) / sum n_m`` over two
    one-mediator reference rounds, ``n_m`` the sum of each block's row
    weights (1e-4 of the update's scale)."""
    rcfg, pcfg, params, model, mesh, _, full = setup
    toks, labels = _stream(2, 2 * LOCAL_STEPS, rcfg.vocab)
    weights = np.repeat(np.array([32.0, 96.0], np.float32), LOCAL_STEPS)
    outs = []
    with use_mesh(mesh):
        for m in range(2):
            rows = slice(m * LOCAL_STEPS, (m + 1) * LOCAL_STEPS)
            out = full(params, jnp.asarray(toks[rows]), jnp.asarray(labels[rows]),
                       jnp.asarray(weights[rows]))
            outs.append(jax.tree.map(lambda a: np.asarray(a, np.float64), out))
    n = np.array([weights[:LOCAL_STEPS].sum(), weights[LOCAL_STEPS:].sum()], np.float64)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    want = jax.tree.map(lambda s, a, b: s + (n[0] * (a - s) + n[1] * (b - s)) / n.sum(),
                        p64, outs[0], outs[1])
    want = transformer_params_from_jax(jax.tree.map(lambda a: a.astype(np.float32), want))
    start = PT.train_params(model)
    fl = PS.make_fl_round(model, 2, learning_rate=LR, local_steps=LOCAL_STEPS,
                          mediator_epochs=EPOCHS)
    got = fl(start, torch.from_numpy(toks), torch.from_numpy(labels),
             torch.from_numpy(weights))
    for k in start:
        _close_step(got[k], want[k], start[k])


def _lora_setup(rcfg, params, rank):
    mapping = RT.adapter_mapping(rcfg, rank)
    a_tree = RL.init_adapter_A(jax.random.fold_in(jax.random.PRNGKey(0), RL.A_SALT), mapping)
    state = RL.init_adapter_state(mapping, params)
    return mapping, a_tree, state


def test_lora_round_matches_reference(setup):
    """Rank 4, the reference's frozen ``A`` injected: every adapter state
    leaf's update within 1e-4 of the reference's (``local_steps=4``,
    ``mediator_epochs=2``), and the merged weights as the reference merges
    them."""
    rcfg, pcfg, params, model, mesh, spec_tree, _ = setup
    mapping, a_tree, state = _lora_setup(rcfg, params, 4)
    fl_ref = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, learning_rate=LR,
                                      local_steps=LOCAL_STEPS, mediator_epochs=EPOCHS,
                                      lora_mapping=mapping))
    toks, labels = _stream(3, LOCAL_STEPS, rcfg.vocab)
    weights = np.full((LOCAL_STEPS,), float(SEQ), np.float32)
    with use_mesh(mesh):
        want = fl_ref(params, a_tree, state, jnp.asarray(toks), jnp.asarray(labels),
                      jnp.asarray(weights))
    merged_want = transformer_params_from_jax(jax.tree.map(
        np.asarray, RL.merge_params(params, a_tree, want, mapping)))

    pmap = PT.adapter_mapping(pcfg, 4)
    backbone = PT.train_params(model)
    p_a = adapter_tree_from_jax(jax.tree.map(np.asarray, a_tree))
    p_state = PL.init_adapter_state(pmap, backbone)
    for path, leaf in adapter_tree_from_jax(jax.tree.map(np.asarray, state)).items():
        assert torch.equal(p_state[path], leaf), path
    fl = PS.make_fl_round(model, 1, learning_rate=LR, local_steps=LOCAL_STEPS,
                          mediator_epochs=EPOCHS, lora_mapping=pmap)
    got = fl(backbone, p_a, p_state, torch.from_numpy(toks), torch.from_numpy(labels),
             torch.from_numpy(weights))
    assert list(got) == list(want)
    moved = [_close_step(got[p], np.asarray(want[p]), p_state[p]) for p in got]
    assert max(moved) > 1e-3
    merged = PL.merge_params(backbone, p_a, got, pmap)
    for k, w in merged_want.items():
        _close_step(merged[k], w, backbone[k])
    back = adapter_tree_to_jax(got)
    assert all(np.array_equal(back[p], got[p].numpy()) for p in got)


@pytest.fixture(scope="module")
def granite():
    """The reduced granite-moe-3b-a800m (4 experts, top 2, groups of 64)
    with every leaf drawn from numpy at the standard fan-in
    (``torch_parity.rand_params``), on the reference's host mesh."""
    rcfg, pcfg = RC.reduced(RC.get(GRANITE)), PC.reduced(PC.get(GRANITE))
    params = jax.tree.map(jnp.asarray, rand_params(rcfg, 0))
    model = PT.Transformer(pcfg)
    model.load_state_dict(transformer_params_from_jax(jax.tree.map(np.asarray, params)))
    spec_tree = jax.tree.map(lambda _: P(), RT.param_specs(rcfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    return rcfg, pcfg, params, model, make_host_mesh(), spec_tree


def test_granite_lora_round_matches_reference(granite):
    """Rank 4 on the MoE family, its expert weights' adapters batched over
    ``(layers, expert)`` and the fp32 router's over the layers, the
    reference's frozen ``A`` injected: every adapter state leaf's update
    within 1e-4 of the reference's (``local_steps=4``,
    ``mediator_epochs=2``; each step one row of 32 tokens, one MoE group,
    the aux term in the loss), and the merged weights as the reference
    merges them."""
    rcfg, pcfg, params, model, mesh, spec_tree = granite
    mapping, a_tree, state = _lora_setup(rcfg, params, 4)
    assert mapping["layers/moe/w_gate"].batch_axes == ("layers", "expert")
    fl_ref = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, learning_rate=LR,
                                      local_steps=LOCAL_STEPS, mediator_epochs=EPOCHS,
                                      lora_mapping=mapping))
    toks, labels = _stream(6, LOCAL_STEPS, rcfg.vocab)
    weights = np.full((LOCAL_STEPS,), float(SEQ), np.float32)
    with use_mesh(mesh):
        want = fl_ref(params, a_tree, state, jnp.asarray(toks), jnp.asarray(labels),
                      jnp.asarray(weights))
    merged_want = transformer_params_from_jax(jax.tree.map(
        np.asarray, RL.merge_params(params, a_tree, want, mapping)))

    pmap = PT.adapter_mapping(pcfg, 4)
    backbone = PT.train_params(model)
    p_a = adapter_tree_from_jax(jax.tree.map(np.asarray, a_tree))
    p_state = PL.init_adapter_state(pmap, backbone)
    fl = PS.make_fl_round(model, 1, learning_rate=LR, local_steps=LOCAL_STEPS,
                          mediator_epochs=EPOCHS, lora_mapping=pmap)
    got = fl(backbone, p_a, p_state, torch.from_numpy(toks), torch.from_numpy(labels),
             torch.from_numpy(weights))
    assert list(got) == list(want)
    moved = {p: _close_step(got[p], np.asarray(want[p]), p_state[p]) for p in got}
    assert moved["layers/moe/w_down"] > 0 and max(moved.values()) > 1e-3
    merged = PL.merge_params(backbone, p_a, got, pmap)
    for k, w in merged_want.items():
        _close_step(merged[k], w, backbone[k])


@pytest.mark.parametrize("arch,needs", [("whisper-base", "enc_feats"),
                                        ("internvl2-1b", "vision_embeds")])
def test_fl_round_of_audio_and_vlm_raises(arch, needs):
    """A mediator's batch is tokens and labels only, so the audio model's
    round (no frames) and the VLM's (no vision embeddings) raise, full-delta
    and over an adapter state, before any step; the reference's round
    fails on the same missing key (``KeyError``) when it is traced."""
    rcfg, pcfg = RC.reduced(RC.get(arch)), PC.reduced(PC.get(arch))
    model = PT.init_model(pcfg, torch.Generator().manual_seed(0))
    backbone = PT.train_params(model)
    toks, labels = _stream(7, LOCAL_STEPS, pcfg.vocab)
    args = (torch.from_numpy(toks), torch.from_numpy(labels), torch.ones(LOCAL_STEPS))
    before = {k: t.clone() for k, t in backbone.items()}
    with pytest.raises(ValueError, match=needs):
        PS.make_fl_round(model, 1, local_steps=LOCAL_STEPS)(backbone, *args)
    mapping = PT.adapter_mapping(pcfg, 4)
    state = PL.init_adapter_state(mapping, backbone)
    with pytest.raises(ValueError, match=needs):
        PS.make_fl_round(model, 1, local_steps=LOCAL_STEPS, lora_mapping=mapping)(
            backbone, PL.init_adapter_A(PL.A_SALT, mapping), state, *args)
    assert all(torch.equal(before[k], backbone[k]) for k in before)
    params = jax.tree.map(jnp.asarray, rand_params(rcfg, 0))
    spec_tree = jax.tree.map(lambda _: P(), RT.param_specs(rcfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    mesh = make_host_mesh()
    fl_ref = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, local_steps=LOCAL_STEPS))
    with use_mesh(mesh), pytest.raises(KeyError, match=needs):
        fl_ref(params, *(jnp.asarray(a.numpy()) for a in args))


def test_full_rank_lora_round_is_the_full_delta_round_bitwise(setup):
    """At full rank every entry is dense: the trained state, merged, is the
    full-delta round's weights bit for bit (two mediators, so Eq. 6's
    one fused launch over the state meets the per-leaf launches)."""
    _, pcfg, _, model, _, _, _ = setup
    toks, labels = _stream(4, 2 * LOCAL_STEPS, pcfg.vocab)
    args = (torch.from_numpy(toks), torch.from_numpy(labels),
            torch.from_numpy(np.repeat(np.array([32.0, 64.0], np.float32), LOCAL_STEPS)))
    backbone = PT.train_params(model)
    full = PS.make_fl_round(model, 2, learning_rate=LR, local_steps=LOCAL_STEPS)(
        backbone, *args)
    mapping = PT.adapter_mapping(pcfg, PL.full_rank(PT.param_specs(pcfg)))
    assert all(e.kind == "dense" for e in mapping.values())
    state = PL.init_adapter_state(mapping, backbone)
    fl = PS.make_fl_round(model, 2, learning_rate=LR, local_steps=LOCAL_STEPS,
                          lora_mapping=mapping)
    merged = PL.merge_params(backbone, {}, fl(backbone, {}, state, *args), mapping)
    for k in full:
        assert torch.equal(merged[k], full[k]), k


def test_rank_zero_round_trains_nothing(setup):
    _, pcfg, _, model, _, _, _ = setup
    toks, labels = _stream(5, LOCAL_STEPS, pcfg.vocab)
    fl = PS.make_fl_round(model, 1, local_steps=LOCAL_STEPS, lora_mapping={})
    ops.reset_launches()
    out = fl(PT.train_params(model), {}, {}, torch.from_numpy(toks),
             torch.from_numpy(labels), torch.ones(LOCAL_STEPS))
    assert out == {} and sum(ops.LAUNCHES.values()) == 0


def test_merge_rule_and_seeded_A():
    """Dense entries pass through bit for bit; a factorized one adds
    ``(alpha/rank) A @ B`` in fp32 (cast back); ``A`` is the same from the
    same seed and path, ``N(0, 1/din)``-scaled, and differs by path."""
    cfg = dataclasses.replace(PC.reduced(PC.get("qwen3-4b")), dtype="bfloat16")
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    backbone = PT.train_params(model)
    mapping = PT.adapter_mapping(cfg, 4, alpha=8.0)
    a1, a2 = (PL.init_adapter_A(PL.A_SALT, mapping) for _ in range(2))
    assert all(torch.equal(a1[p], a2[p]) for p in a1)
    assert not torch.equal(a1["layers/attn/wq"], a1["layers/attn/wk"])
    state = PL.init_adapter_state(mapping, backbone)
    rng = np.random.default_rng(0)
    state = {p: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32)).to(s.dtype)
             for p, s in state.items()}
    merged = PL.merge_params(backbone, a1, state, mapping)
    e = mapping["layers/attn/wq"]
    upd = 2.0 * torch.matmul(a1[e.path], state[e.path])
    for i in range(cfg.n_layers):
        w = backbone[f"layers.{i}.attn.wq"]
        want = (w.float() + upd[i]).to(torch.bfloat16)
        assert merged[f"layers.{i}.attn.wq"].dtype == torch.bfloat16
        assert torch.equal(merged[f"layers.{i}.attn.wq"], want)
        assert torch.equal(merged[f"layers.{i}.norm1"], state["layers/norm1"][i])
    assert torch.equal(merged["final_norm"], state["final_norm"])
    assert float(a1["embed"].std() * np.sqrt(mapping["embed"].din)) == pytest.approx(1.0, rel=0.05)


def test_fl_launcher_runs_on_cpu_with_lora():
    """``python -m repro_torch.launch.fl_train --device cpu --lora-rank 2``:
    finite losses, 2 mediators of 8 clients at gamma 4, the adapter/full
    ratio equal to ``exchange_nbytes`` over the full leg."""
    out = pfl.main(["--device", "cpu", "--lora-rank", "2", "--rounds", "2", "--seq", "32"])
    assert out["mediators"] == 2 and np.isfinite(out["losses"]).all()
    cfg = PC.reduced(PC.get("qwen3-4b"))
    mapping = PT.adapter_mapping(cfg, 2)
    assert out["ratio"] == pytest.approx(PL.exchange_nbytes(mapping, 4)
                                         / (4 * PT.param_count(cfg)), rel=1e-12)
    assert out["ledger"]["wan_full_delta_bytes_total"] == 0
