"""Port parity: EmnistCNN, Adam, client/mediator updates and evaluation
against the JAX reference, on the same inputs, params and draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import fl as jfl                                  # noqa: E402
from repro.core.fl import LocalSpec as JLocalSpec                 # noqa: E402
from repro.core.mediator import make_mediator_update              # noqa: E402
from repro.models import cnn as jcnn                              # noqa: E402
from repro.optim import adam as jadam                             # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax    # noqa: E402
from repro_torch.core.fl import (LocalSpec, client_update,  # noqa: E402
                                 confusion_matrix, evaluate)
from repro_torch.core.mediator import mediator_update             # noqa: E402
from repro_torch.models.cnn import (count_params, cross_entropy_loss,  # noqa: E402
                                    emnist_cnn)
from repro_torch.optim import adam, apply_updates                 # noqa: E402

from torch_parity import JaxClientDraws, reference_params         # noqa: E402

NC, HW = 8, 16


def _jax_params(seed=0, nc=NC, hw=HW):
    return reference_params(nc, hw, seed)


def _max_diff(port_params, jax_tree):
    back = params_to_jax(port_params)
    return max(float(np.max(np.abs(back[l][k] - np.asarray(jax_tree[l][k]))))
               for l in jax_tree for k in jax_tree[l])


def test_param_count_is_paper_width():
    assert count_params(dict(emnist_cnn(47, 28).named_parameters())) == 68_873
    shapes = jax.eval_shape(jcnn.emnist_cnn(47, 28).init, jax.random.PRNGKey(0))
    mine = params_to_jax(dict(emnist_cnn(47, 28).named_parameters()))
    assert jax.tree.map(lambda s: s.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, mine)


def test_convert_round_trips():
    tree = _jax_params(3)
    back = params_to_jax(params_from_jax(tree))
    for layer in tree:
        for k in tree[layer]:
            np.testing.assert_array_equal(back[layer][k], tree[layer][k])


@pytest.mark.parametrize("nc,hw", [(NC, HW), (47, 28)])
def test_logits_match_reference(nc, hw):
    tree = _jax_params(1, nc, hw)
    x = np.random.default_rng(0).normal(size=(6, hw, hw, 1)).astype(np.float32)
    expect = np.asarray(jcnn.emnist_cnn(nc, hw).apply(tree, jnp.asarray(x)))
    got = emnist_cnn(nc, hw).apply(params_from_jax(tree), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_train_logits_with_injected_dropout_match():
    model = emnist_cnn(NC, HW)
    tree = _jax_params(2)
    x = np.random.default_rng(1).normal(size=(5, HW, HW, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    expect = np.asarray(jcnn.emnist_cnn(NC, HW).apply(
        tree, jnp.asarray(x), train=True, rngs=key))
    d1, d2 = jax.random.split(key)
    sites = model.dropout_sites(5)
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(d, 1.0 - rate, s)))
            for d, (s, rate) in zip((d1, d2), sites)]
    got = model.apply(params_from_jax(tree), torch.from_numpy(x), keep)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_masked_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(10, NC)).astype(np.float32)
    labels = rng.integers(0, NC, 10).astype(np.int32)
    mask = (rng.random(10) < 0.6).astype(np.float32)
    for m in (mask, None, np.zeros(10, np.float32)):
        expect = float(jcnn.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(expect, rel=1e-6, abs=1e-7)


def test_adam_steps_match_reference():
    tree = _jax_params(4)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
             for _ in range(3)]
    jopt, opt = jadam(1e-3), adam(1e-3)
    jstate, jp = jopt.init(tree), tree
    params = params_from_jax(tree)
    state = opt.init(params)

    @jax.jit
    def jstep(g, jstate, jp):
        upd, jstate = jopt.update(g, jstate, jp)
        return jax.tree.map(lambda p, u: p + u, jp, upd), jstate

    for g in grads:
        jp, jstate = jstep(g, jstate, jp)
        tupd, state = opt.update(params_from_jax(g), state, params)
        params = apply_updates(params, tupd)
    assert _max_diff(params, jp) < 1e-7


def test_sgd_momentum_steps_match_reference():
    from repro.optim import sgd as jsgd
    from repro_torch.optim import sgd
    tree = _jax_params(5)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
             for _ in range(3)]
    for kw in (dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True)):
        jopt, opt = jsgd(0.05, **kw), sgd(0.05, **kw)
        jstate, jp = jopt.init(tree), tree
        params = params_from_jax(tree)
        state = opt.init(params)
        for g in grads:
            upd, jstate = jopt.update(g, jstate, jp)
            jp = jax.tree.map(lambda p, u: np.asarray(p + u), jp, upd)
            tupd, state = opt.update(params_from_jax(g), state, params)
            params = apply_updates(params, tupd)
        assert _max_diff(params, jp) < 1e-6


def _client_batch(seed, pad=40, nvalid=33):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(pad, HW, HW, 1)).astype(np.float32)
    y = rng.integers(0, NC, pad).astype(np.int32)
    m = (np.arange(pad) < nvalid).astype(np.float32)
    return x, y, m


def test_mediator_update_matches_reference_and_empty_slot_is_noop():
    """One mediator (gamma=3, E_m=2, E=2) with the reference's own draws;
    slot 2 is an all-zero-mask dummy.  (A lone client update is FedAvg's
    row, held to the reference in tests/test_torch_slice.py.)"""
    model, tree = emnist_cnn(NC, HW), _jax_params(6)
    gamma, e_m = 3, 2
    batches = [_client_batch(10 + s) for s in range(gamma)]
    xs = np.stack([b[0] for b in batches])
    ys = np.stack([b[1] for b in batches])
    ms = np.stack([b[2] for b in batches])
    ms[2] = 0.0
    key = jax.random.PRNGKey(21)
    med = jax.jit(make_mediator_update(jcnn.emnist_cnn(NC, HW), jadam(1e-3),
                                       JLocalSpec(10, 2), e_m))
    expect = med(tree, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ms), key)

    def draws_for(epoch, slot):
        ekey = jax.random.split(key, e_m)[epoch]
        return JaxClientDraws(jax.random.split(ekey, gamma)[slot], epochs=2,
                              batch=10, n=40, sites=model.dropout_sites(10))

    params = params_from_jax(tree)
    args = (model, adam(1e-3), LocalSpec(10, 2), e_m, params,
            torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(ms),
            draws_for)
    got = mediator_update(*args)
    assert _max_diff(got, expect) < 1e-5
    # every slot runs, as in the reference; under Adam the empty slot is a
    # no-op: bitwise the same as a mediator without that slot
    fewer = mediator_update(model, adam(1e-3), LocalSpec(10, 2), e_m, params,
                            torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2]),
                            torch.from_numpy(ms[:2]), draws_for)
    for k in got:
        assert torch.equal(got[k], fewer[k])


def test_all_zero_mask_client_leaves_params_bitwise_unchanged():
    model = emnist_cnn(NC, HW)
    params = params_from_jax(_jax_params(8))
    x, y, _ = _client_batch(5)
    draws = JaxClientDraws(jax.random.PRNGKey(0), epochs=2, batch=10, n=40,
                           sites=model.dropout_sites(10))
    out = client_update(model, adam(1e-3), LocalSpec(10, 2), params,
                        torch.from_numpy(x), torch.from_numpy(y),
                        torch.zeros(40), draws)
    for k in params:
        assert torch.equal(out[k], params[k])


def test_evaluate_matches_reference():
    tree = _jax_params(9)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(600, HW, HW, 1)).astype(np.float32)
    y = rng.integers(0, NC, 600).astype(np.int32)
    expect = jfl.evaluate(jcnn.emnist_cnn(NC, HW), tree, x, y)
    got = evaluate(emnist_cnn(NC, HW), params_from_jax(tree),
                   torch.from_numpy(x), torch.from_numpy(y))
    assert got["accuracy"] == expect["accuracy"]
    assert got["loss"] == pytest.approx(expect["loss"], rel=1e-5)
    cm_j, rec_j = jfl.confusion_matrix(jcnn.emnist_cnn(NC, HW), tree, x, y, NC)
    cm_t, rec_t = confusion_matrix(emnist_cnn(NC, HW), params_from_jax(tree),
                                   torch.from_numpy(x), torch.from_numpy(y), NC)
    np.testing.assert_array_equal(cm_t, cm_j)
    np.testing.assert_array_equal(rec_t, rec_j)
