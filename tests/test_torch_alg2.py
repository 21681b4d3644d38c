"""Port parity for the materialized Alg. 2 phase, the custom local loss and
the reweighting baseline.

Materialized: ``random_affine``, ``augment_batch``, ``rebalance_client``,
``rebalance_federation`` and ``resolve_aug_mode`` against the reference's,
fed the reference's own draws (``torch_parity.rebalance_draws``): the
shuffle seed of ``randint(key)`` and the warp parameters of its key
splits.  The port warps with the bilinear four-tap warp where the
reference calls ``map_coordinates(order=1, mode="constant")``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import augmentation as jaug                       # noqa: E402
from repro.core import fl as jfl                                  # noqa: E402
from repro.core import reweighting as jrw                         # noqa: E402
from repro.models import cnn as jcnn                              # noqa: E402
from repro.optim import adam as jadam                             # noqa: E402

from repro_torch.convert import params_from_jax                   # noqa: E402
from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec  # noqa: E402
from repro_torch.core import augmentation as aug                  # noqa: E402
from repro_torch.core import reweighting as rw                    # noqa: E402
from repro_torch.core.fl import client_update, masked_ce_loss     # noqa: E402
from repro_torch.data.federated import CINIC_LIKE, partition      # noqa: E402
from repro_torch.models.cnn import cinic_cnn, emnist_cnn          # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

from torch_parity import (JaxClientDraws, JaxRebalanceDraws,      # noqa: E402
                          cinic_reference_params, max_param_diff,
                          rebalance_draws_of_key, reference_params)

SEED, ALPHA = 0, 0.67
# the warp: the four-tap arithmetic and map_coordinates round the source
# coordinate in another order (tests/test_torch_kernels.py); on these
# images in [0, 1] under the Alg. 2 maps they agree to 1e-5
WARP_ATOL = 1e-5


@pytest.fixture(scope="module")
def federation():
    spec = dataclasses.replace(CINIC_LIKE, image_size=8, noise=0.5, distort=0.35)
    return partition(spec, num_clients=6, total_samples=150, test_samples=20,
                     sizes="instagram", global_dist="normal", local="random",
                     seed=SEED)


def test_random_affine_and_augment_batch_match_reference():
    rng = np.random.default_rng(0)
    imgs = rng.random((3, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    expect = np.asarray(jaug.random_affine(key, jnp.asarray(imgs[0])))
    mat, trans = jaug._affine_params(key, shift=3.0, rot=0.3, shear=0.2, zoom=0.15)
    got = aug.random_affine(torch.from_numpy(imgs[0]), torch.from_numpy(np.array(mat)),
                            torch.from_numpy(np.array(trans)))
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=WARP_ATOL)
    expect = np.asarray(jaug.augment_batch(key, jnp.asarray(imgs), 2))
    keys = jax.random.split(key, 6)            # copy-major: row c * n + i
    mats, transs = jax.vmap(lambda k: jaug._affine_params(
        k, shift=3.0, rot=0.3, shear=0.2, zoom=0.15))(keys)
    got = aug.augment_batch(torch.from_numpy(imgs), 2, torch.from_numpy(np.array(mats)),
                            torch.from_numpy(np.array(transs)))
    assert got.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("plan", [[0, 2, 0, 1, 3, 0, 0, 1, 0, 2],   # 5 copies...
                                  [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
                                  [0] * 10])                         # none: shuffle only
def test_rebalance_client_matches_reference(federation, plan):
    x, y = federation.client_images[1], federation.client_labels[1]
    plan = np.asarray(plan, np.int64)
    key = jax.random.PRNGKey(3)
    ex, ey = jaug.rebalance_client(key, x, y, plan)
    n = int(plan[y].sum())
    seed, mats, trans = rebalance_draws_of_key(key, n)
    gx, gy = aug.rebalance_client(x, y, plan, seed, mats, trans)
    assert gx.shape == ex.shape and gx.shape[0] == x.shape[0] + n
    np.testing.assert_array_equal(gy, ey)
    np.testing.assert_allclose(gx, ex, rtol=0, atol=WARP_ATOL)


def test_rebalance_federation_matches_reference(federation):
    fed = federation
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 17)
    ex, ey, eplan, efrac = jaug.rebalance_federation(
        key, fed.client_images, fed.client_labels, fed.num_classes, ALPHA)
    gx, gy, gplan, gfrac = aug.rebalance_federation(
        fed.client_images, fed.client_labels, fed.num_classes, ALPHA,
        JaxRebalanceDraws(SEED), "cpu")
    np.testing.assert_array_equal(gplan, eplan)
    assert eplan.any() and gfrac == efrac > 0
    for a, b, c, d in zip(gx, ex, gy, ey):
        np.testing.assert_array_equal(c, d)                 # labels and order
        np.testing.assert_allclose(a, b, rtol=0, atol=WARP_ATOL)


def test_resolve_aug_mode_matches_reference(federation):
    fed = federation
    draws = JaxRebalanceDraws(SEED)
    for mode, alpha in (("materialized", ALPHA), ("online", ALPHA), (None, ALPHA),
                        ("materialized", None)):
        e = jaug.resolve_aug_mode(fed, alpha, mode, SEED)
        g = aug.resolve_aug_mode(fed, alpha, mode, draws=draws, device="cpu")
        assert g.mode == e.mode
        assert g.extra_storage_frac == e.extra_storage_frac
        assert g.planned_extra_frac == e.planned_extra_frac
        for a, b in ((g.plan, e.plan), (g.engine_plan, e.engine_plan)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert [c.shape[0] for c in g.data.client_images] == \
            [c.shape[0] for c in e.data.client_images]
        for c, d in zip(g.data.client_labels, e.data.client_labels):
            np.testing.assert_array_equal(c, d)
    with pytest.raises(ValueError):
        aug.resolve_aug_mode(fed, ALPHA, "offline", draws=draws)


@pytest.mark.parametrize("trainer", ["astraea", "fedavg"])
def test_materialized_trainers_rebuild_the_federation(federation, trainer):
    """A materialized trainer trains on the rebuilt federation with no
    in-round plan and charges the plan broadcast once, as the reference's
    trainers do; its extra storage is the reference's."""
    fed = federation
    model = cinic_cnn(10, 8, 3, 4)
    kw = dict(clients_per_round=4, local=LocalSpec(10, 1), alpha=ALPHA,
              aug_mode="materialized", seed=SEED, device="cpu")
    tr = AstraeaTrainer(model, adam(1e-3), fed, gamma=2, **kw) if trainer == "astraea" \
        else FedAvgTrainer(model, adam(1e-3), fed, **kw)
    phase = jaug.resolve_aug_mode(fed, ALPHA, "materialized", SEED)
    assert tr.extra_storage_frac > 0
    assert tr.engine._plan is None
    assert sum(x.shape[0] for x in tr.data.client_images) == \
        sum(x.shape[0] for x in phase.data.client_images)
    plan_bytes = 4 * fed.num_classes * fed.num_clients
    assert tr.comm.total_bytes == plan_bytes
    tr.run_round()
    w = 4 * sum(p.numel() for p in tr.params.values())
    legs = 2 * 4 + 2 * 2 if trainer == "astraea" else 2 * 4
    assert tr.comm.total_bytes == plan_bytes + legs * w
    assert all(bool(torch.isfinite(p).all()) for p in tr.params.values())


def test_materialized_phase_warps_in_one_launch_per_federation(federation, monkeypatch):
    calls = []
    real = aug.ops.affine_warp

    def counting(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(aug.ops, "affine_warp", counting)
    _, _, plan, _ = aug.rebalance_federation(
        federation.client_images, federation.client_labels, 10, ALPHA,
        JaxRebalanceDraws(SEED), "cpu")
    assert calls == [sum(int(plan[y].sum()) for y in federation.client_labels)]


# ---------------------------------------------------------------- local loss

def _batch(seed, n=20, nc=10, hw=8, ch=3, valid=16):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, ch)).astype(np.float32),
            rng.integers(0, nc, n).astype(np.int32),
            (np.arange(n) < valid).astype(np.float32))


def test_inverse_frequency_weights_and_weighted_loss_match_reference():
    counts = np.array([120, 3, 0, 45, 9, 300, 1, 0, 77, 12], np.float64)
    np.testing.assert_array_equal(rw.inverse_frequency_weights(counts),
                                  jrw.inverse_frequency_weights(counts))
    np.testing.assert_array_equal(
        rw.inverse_frequency_weights(counts, smoothing=0.5, normalize=False),
        jrw.inverse_frequency_weights(counts, smoothing=0.5, normalize=False))
    w = jrw.inverse_frequency_weights(counts)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(12, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 12).astype(np.int32)
    mask = (rng.random(12) < 0.7).astype(np.float32)
    loss = rw.weighted_cross_entropy(torch.from_numpy(w))
    jloss = jrw.weighted_cross_entropy(jnp.asarray(w))
    for m in (mask, None, np.zeros(12, np.float32)):
        got = float(loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if m is None else torch.from_numpy(m)))
        expect = float(jloss(jnp.asarray(logits), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m)))
        assert got == pytest.approx(expect, rel=1e-6, abs=1e-7)


def test_reweighted_client_update_matches_reference():
    """The reweighted local loss through ``client_update(loss_fn=...)``
    against the reference's ``make_client_update(loss_fn=...)`` with its
    draws: params within 1e-5."""
    counts = np.array([40, 3, 9, 25, 6, 80, 2, 11, 30, 5], np.float64)
    w = jrw.inverse_frequency_weights(counts)
    jwce = jrw.weighted_cross_entropy(jnp.asarray(w))

    def jloss(model, params, x, y, mask, key):
        return jwce(model.apply(params, x, train=True, rngs=key), y, mask)

    model = cinic_cnn(10, 8, 3, 4)
    tree = cinic_reference_params(10, 8, 4, seed=6)
    x, y, m = _batch(2)
    key = jax.random.PRNGKey(4)
    update = jax.jit(jfl.make_client_update(jcnn.cinic_cnn(10, 8, 3, 4), jadam(1e-3),
                                            jfl.LocalSpec(10, 2), loss_fn=jloss))
    expect = update(tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), key)
    wce = rw.weighted_cross_entropy(torch.from_numpy(w))
    got = client_update(
        model, adam(1e-3), LocalSpec(10, 2), params_from_jax(tree), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(m),
        JaxClientDraws(key, epochs=2, batch=10, n=20, sites=model.dropout_sites(10)),
        loss_fn=lambda mdl, p, xx, yy, mm, keep: wce(mdl.apply(p, xx, keep), yy, mm))
    assert max_param_diff(got, expect) <= 1e-5


def test_explicit_default_loss_equals_the_default_bitwise():
    model = emnist_cnn(8, 16)
    params = params_from_jax(reference_params(8, 16, 3))
    x, y, m = _batch(3, hw=16, ch=1, nc=8)
    draws = JaxClientDraws(jax.random.PRNGKey(1), epochs=1, batch=10, n=20,
                           sites=model.dropout_sites(10))
    args = (model, adam(1e-3), LocalSpec(10, 1), params, torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(m), draws)
    a, b = client_update(*args), client_update(*args, loss_fn=masked_ce_loss)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_reweighted_fedavg_trainer_uses_the_weighted_loss(federation):
    """``ReweightedFedAvgTrainer`` equals ``FedAvgTrainer`` given the same
    weighted loss, and differs from plain FedAvg."""
    fed = federation
    kw = dict(clients_per_round=3, local=LocalSpec(10, 1), seed=SEED, device="cpu")
    model = cinic_cnn(10, 8, 3, 4)
    rwt = rw.ReweightedFedAvgTrainer(model, adam(1e-3), fed, **kw)
    wce = rw.weighted_cross_entropy(torch.from_numpy(
        rw.inverse_frequency_weights(fed.client_counts().sum(0))))
    same = FedAvgTrainer(model, adam(1e-3), fed, loss_fn=lambda mdl, p, x, y, m, keep:
                         wce(mdl.apply(p, x, keep), y, m), **kw)
    plain = FedAvgTrainer(model, adam(1e-3), fed, **kw)
    for tr in (rwt, same, plain):
        tr.run_round()
    for k in rwt.params:
        assert torch.equal(rwt.params[k], same.params[k])
    assert any(not torch.equal(rwt.params[k], plain.params[k]) for k in rwt.params)
