"""Port parity for the CINIC-10 arm: ``cinic_cnn`` (SAME convolutions,
max-pool, three dropout sites at 0.25 / 0.25 / 0.5) against the
reference's model on exported params and injected draws, and the whole
slice -- Astraea and FedAvg on a reduced CINIC-like federation -- against
the reference's mesh-free round loops (``torch_parity``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import fl as jfl                                  # noqa: E402
from repro.data import federated as jfederated                    # noqa: E402
from repro.models import cnn as jcnn                              # noqa: E402
from repro.optim import adam as jadam                             # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax    # noqa: E402
from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec  # noqa: E402
from repro_torch.core.fl import client_update                     # noqa: E402
from repro_torch.data.federated import CINIC_LIKE, partition      # noqa: E402
from repro_torch.examples.astraea_vs_fedavg import configuration  # noqa: E402
from repro_torch.models.cnn import cinic_cnn, count_params        # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

from torch_parity import (JaxClientDraws, JaxDraws, cinic_reference_params,  # noqa: E402
                          max_param_diff, padded_size, reference_astraea,
                          reference_fedavg)

NC, HW, W = 10, 16, 8
LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "dense1", "out")


def test_cinic_param_count_and_layout_are_the_papers():
    model = cinic_cnn(10, 32, 3, 32)
    assert count_params(dict(model.named_parameters())) == 2_168_362
    shapes = jax.eval_shape(jcnn.cinic_cnn(10, 32, 3, 32).init, jax.random.PRNGKey(0))
    mine = params_to_jax(dict(model.named_parameters()))
    assert tuple(sorted(mine)) == tuple(sorted(LAYERS))
    assert jax.tree.map(lambda s: s.shape, shapes) == jax.tree.map(lambda a: a.shape, mine)
    assert [site for site in model.dropout_sites(20)] == [
        ((20, 16, 16, 32), 0.25), ((20, 8, 8, 64), 0.25), ((20, 512), 0.5)]


def test_cinic_convert_round_trips_all_six_layers():
    tree = cinic_reference_params(NC, HW, W, seed=3)
    back = params_to_jax(params_from_jax(tree))
    assert set(back) == set(LAYERS)
    for layer in tree:
        for k in tree[layer]:
            np.testing.assert_array_equal(back[layer][k], tree[layer][k])


@pytest.mark.parametrize("hw,width", [(HW, W), (32, 32)])
def test_cinic_logits_match_reference(hw, width):
    tree = cinic_reference_params(NC, hw, width, seed=1)
    x = np.random.default_rng(0).normal(size=(3, hw, hw, 3)).astype(np.float32)
    expect = np.asarray(jcnn.cinic_cnn(NC, hw, 3, width).apply(tree, jnp.asarray(x)))
    got = cinic_cnn(NC, hw, 3, width).apply(params_from_jax(tree), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_cinic_train_logits_with_injected_three_site_dropout_match():
    model = cinic_cnn(NC, HW, 3, W)
    tree = cinic_reference_params(NC, HW, W, seed=2)
    x = np.random.default_rng(1).normal(size=(5, HW, HW, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    expect = np.asarray(jcnn.cinic_cnn(NC, HW, 3, W).apply(
        tree, jnp.asarray(x), train=True, rngs=key))
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(d, 1.0 - rate, shape)))
            for d, (shape, rate) in zip(jax.random.split(key, 3), model.dropout_sites(5))]
    got = model.apply(params_from_jax(tree), torch.from_numpy(x), keep)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_cinic_adam_step_with_injected_masks_matches_reference():
    """One local Adam step (a padded batch of one B-row step, E=1) with the
    reference's permutation and three keep-masks ``bernoulli(split(
    step_key, 3)[i], keep_i, shape_i)``: params within 1e-5.  Max-pool
    gradient ties (all-zero windows after ReLU) route differently in XLA
    and torch; the ReLU zeroes that gradient, so the params still agree."""
    model = cinic_cnn(NC, HW, 3, W)
    tree = cinic_reference_params(NC, HW, W, seed=4)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, NC, 20).astype(np.int32)
    m = (np.arange(20) < 17).astype(np.float32)
    key = jax.random.PRNGKey(11)
    update = jax.jit(jfl.make_client_update(jcnn.cinic_cnn(NC, HW, 3, W), jadam(1e-3),
                                            jfl.LocalSpec(20, 1)))
    expect = update(tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), key)
    draws = JaxClientDraws(key, epochs=1, batch=20, n=20, sites=model.dropout_sites(20))
    got = client_update(model, adam(1e-3), LocalSpec(20, 1), params_from_jax(tree),
                        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
                        draws)
    assert max_param_diff(got, expect) <= 1e-5


# ---------------------------------------------------------------- whole slice

K, C, GAMMA, ROUNDS, SEED, B, E, E_M, ALPHA = 12, 8, 4, 2, 0, 10, 1, 1, 0.67


@pytest.fixture(scope="module")
def federation():
    spec = dataclasses.replace(CINIC_LIKE, image_size=HW, noise=0.5, distort=0.35)
    return partition(spec, num_clients=K, total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="normal", local="random",
                     seed=SEED)


def test_cinic_astraea_slice_matches_reference_loop(federation):
    fed = federation
    params = cinic_reference_params(NC, HW, W, SEED)
    init = params_from_jax(params)
    params, groups, comm, _, plan = reference_astraea(
        jcnn.cinic_cnn(NC, HW, 3, W), params, fed, clients=C, gamma=GAMMA, batch=B,
        epochs=E, mediator_epochs=E_M, alpha=ALPHA, rounds=ROUNDS, seed=SEED)
    assert plan.any()
    port = AstraeaTrainer(
        cinic_cnn(NC, HW, 3, W), adam(1e-3), fed, clients_per_round=C, gamma=GAMMA,
        local=LocalSpec(B, E), mediator_epochs=E_M, alpha=ALPHA, seed=SEED,
        device="cpu", init_params=init,
        draws=JaxDraws(seed=SEED, mode="astraea", m_real=len(groups), gamma=GAMMA,
                       mediator_epochs=E_M, local_epochs=E, batch=B,
                       model=cinic_cnn(NC, HW, 3, W), pad=padded_size(fed, B)))
    hist = port.fit(ROUNDS, eval_every=ROUNDS)
    assert port.engine.last_groups == groups
    assert port.comm.round_log == comm.round_log
    assert port.comm.total_bytes == comm.total_bytes
    assert max_param_diff(port.params, params) <= 1e-4
    assert np.isfinite(hist[-1]["accuracy"])


def test_cinic_fedavg_slice_matches_reference_loop(federation):
    fed = federation
    params = cinic_reference_params(NC, HW, W, SEED)
    init = params_from_jax(params)
    params, selections, comm = reference_fedavg(
        jcnn.cinic_cnn(NC, HW, 3, W), params, fed, clients=C, batch=B, epochs=E,
        rounds=ROUNDS, seed=SEED)
    port = FedAvgTrainer(
        cinic_cnn(NC, HW, 3, W), adam(1e-3), fed, clients_per_round=C,
        local=LocalSpec(B, E), seed=SEED, device="cpu", init_params=init,
        draws=JaxDraws(seed=SEED, mode="fedavg", m_real=C, gamma=1,
                       mediator_epochs=1, local_epochs=E, batch=B,
                       model=cinic_cnn(NC, HW, 3, W), pad=padded_size(fed, B)))
    groups = []
    for _ in range(ROUNDS):
        port.run_round()
        groups.append(port.engine.last_groups)
    assert groups == selections
    assert port.comm.round_log == comm.round_log
    assert max_param_diff(port.params, params) <= 1e-4


def test_example_cinic_arms_are_the_papers_configurations():
    fed, model, c, _ = configuration(cinic=True, full=True)
    assert count_params(dict(model.named_parameters())) == 2_168_362
    assert (fed.num_clients, c, fed.num_classes) == (64, 16, 10)
    assert fed.client_images[0].shape[1:] == (32, 32, 3)
    ref_fed = jfederated.partition(
        dataclasses.replace(jfederated.CINIC_LIKE, noise=0.5, distort=0.35),
        num_clients=64, total_samples=6400, test_samples=1000, sizes="instagram",
        global_dist="normal", local="random", seed=0)
    assert [x.shape[0] for x in fed.client_images] == \
        [x.shape[0] for x in ref_fed.client_images]
    assert fed.test_images.shape[0] == 1000
    fed, model, c, _ = configuration(cinic=True, full=False)
    assert (fed.num_clients, c) == (16, 8)
    assert model.input_shape == (16, 16, 3) and model.conv1a.out_channels == 16
