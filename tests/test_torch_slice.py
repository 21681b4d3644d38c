"""The whole slice: the port's Astraea and FedAvg trainers against a
reference loop built from the JAX package's mesh-free parts.

The reference trainers route Eq. 6 through a mesh-sharded ``tensordot``
that JAX 0.9.0 rejects (``ShardingTypeError`` at
``core/engine.py:245`` -> ``core/fl.py:95``), so the loop below composes
the parts that run unsharded: selection through
``np.random.default_rng(seed).choice``, ``scheduling.reschedule`` (the
jitted batched pass, equal to ``impl="loop"``; tests/test_torch_kernels.py
holds the port to the loop itself), the round keys of
``engine._round_keys``, ``online_augment_batch`` with the map_coordinates
warp, jitted ``make_mediator_update`` / ``make_client_update``,
``fl.weighted_average`` and ``CommMeter``.  The
port gets the same initial params and the reference's own draws.
Selection, schedule and WAN ledger must be identical; params agree to
atol 1e-4 after two rounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import augmentation as jaug                       # noqa: E402
from repro.core import fl as jfl                                  # noqa: E402
from repro.core import scheduling as jsched                       # noqa: E402
from repro.core.comm import CommMeter as JCommMeter               # noqa: E402
from repro.core.mediator import make_mediator_update              # noqa: E402
from repro.models import cnn as jcnn                              # noqa: E402
from repro.optim import adam as jadam                             # noqa: E402

from repro_torch.convert import params_from_jax, params_to_jax    # noqa: E402
from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec  # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition     # noqa: E402
from repro_torch.models.cnn import emnist_cnn                     # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

from torch_parity import JaxDraws, float64_tie_free, reference_params  # noqa: E402

NC, HW, K, C, GAMMA, ROUNDS, SEED = 8, 16, 12, 8, 4, 2, 0
B, E, E_M, ALPHA = 10, 1, 1, 0.67


@pytest.fixture(scope="module")
def federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=NC, image_size=HW)
    return partition(spec, num_clients=K, total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="letterfreq",
                     local="random", seed=SEED)


def _pad(fed):
    n = max(x.shape[0] for x in fed.client_images)
    return -(-n // B) * B


def _diff(port_params, tree):
    back = params_to_jax(port_params)
    return max(float(np.max(np.abs(back[l][k] - np.asarray(tree[l][k]))))
               for l in tree for k in tree[l])


@jax.jit
def _stack_average(outs, weights):
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *outs)
    return jfl.weighted_average(stacked, jnp.stack(weights))


@jax.jit
def _fold_deltas(params, deltas, weights):
    return jax.tree.map(lambda p, d: p + d, params, _stack_average(deltas, weights))


def _round_keys(rnd, m_real):
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED + 1), rnd),
                            m_real)


def test_astraea_slice_matches_reference_loop(federation):
    fed = federation
    jmodel = jcnn.emnist_cnn(NC, HW)
    params = reference_params(NC, HW, SEED)
    init = params_from_jax(params)
    pad = _pad(fed)
    xs, ys, mask = fed.padded(pad)
    raw = fed.client_counts()
    plan = jaug.augmentation_plan(raw.sum(0), ALPHA)
    assert plan.any()
    rng = np.random.default_rng(SEED)
    sel = rng.choice(K, size=C, replace=False)
    sched_counts = raw[sel] * (1.0 + plan)
    assert float64_tie_free(sched_counts, GAMMA)          # strict comparison
    meds = jsched.reschedule(sched_counts, GAMMA, impl="batched")
    groups = [[int(sel[i]) for i in m.clients] for m in meds]
    m_real = len(groups)

    med_update = make_mediator_update(jmodel, jadam(1e-3), jfl.LocalSpec(B, E), E_M)
    jplan = jnp.asarray(plan, jnp.int32)

    @jax.jit
    def row_program(params, x, y, m, key):
        # the engine's per-row program: online Alg. 2 per slot, then the
        # mediator update; Eq. 6 weight = expected post-augmentation size
        aks = jax.random.split(jax.random.fold_in(key, jaug.AUG_SALT), GAMMA)
        ax, ay = jax.vmap(lambda k, xx, yy, mm: jaug.online_augment_batch(
            k, xx, yy, mm, jplan, impl="reference"))(aks, x, y, m)
        weight = (m * (1.0 + jplan.astype(jnp.float32)[y])).sum()
        return med_update(params, ax, ay, m, key), weight

    comm = JCommMeter(jcnn.count_params(params))
    comm.plan_broadcast(plan.size, K)
    for rnd in range(ROUNDS):
        keys = _round_keys(rnd, m_real)
        deltas, weights = [], []
        for r, g in enumerate(groups):
            idx = np.zeros(GAMMA, np.int64)
            slot = np.zeros(GAMMA, np.float32)
            idx[:len(g)], slot[:len(g)] = g, 1.0
            delta, weight = row_program(params, xs[idx], ys[idx],
                                        mask[idx] * slot[:, None], keys[r])
            deltas.append(delta)
            weights.append(weight)
        params = _fold_deltas(params, deltas, weights)
        comm.astraea_round(C, GAMMA, E_M)
        comm.end_round()

    port = AstraeaTrainer(
        emnist_cnn(NC, HW), adam(1e-3), fed, clients_per_round=C, gamma=GAMMA,
        local=LocalSpec(B, E), mediator_epochs=E_M, alpha=ALPHA, seed=SEED,
        device="cpu", init_params=init,
        draws=JaxDraws(seed=SEED, mode="astraea", m_real=m_real, gamma=GAMMA,
                       mediator_epochs=E_M, local_epochs=E, batch=B,
                       model=emnist_cnn(NC, HW), pad=pad))
    hist = port.fit(ROUNDS, eval_every=ROUNDS)
    assert port.engine.last_groups == groups
    assert port.comm.round_log == comm.round_log
    assert port.comm.total_bytes == comm.total_bytes
    assert _diff(port.params, params) <= 1e-4
    assert set(hist[-1]) == {"accuracy", "loss", "round", "traffic_mb",
                             "mediator_kld_mean"}
    assert np.isfinite(hist[-1]["accuracy"])


def test_fedavg_slice_matches_reference_loop(federation):
    fed = federation
    jmodel = jcnn.emnist_cnn(NC, HW)
    params = reference_params(NC, HW, SEED)
    init = params_from_jax(params)
    pad = _pad(fed)
    xs, ys, mask = fed.padded(pad)
    update = jax.jit(jfl.make_client_update(jmodel, jadam(1e-3), jfl.LocalSpec(B, E)))
    rng = np.random.default_rng(SEED)
    comm = JCommMeter(jcnn.count_params(params))
    selections = []
    for rnd in range(ROUNDS):
        sel = rng.choice(K, size=C, replace=False)
        selections.append([[int(k)] for k in sel])
        keys = _round_keys(rnd, C)
        outs = [update(params, xs[k], ys[k], mask[k], keys[r])
                for r, k in enumerate(sel)]
        params = _stack_average(outs, [jnp.float32(mask[k].sum()) for k in sel])
        comm.fedavg_round(C)
        comm.end_round()

    port = FedAvgTrainer(
        emnist_cnn(NC, HW), adam(1e-3), fed, clients_per_round=C,
        local=LocalSpec(B, E), seed=SEED, device="cpu", init_params=init,
        draws=JaxDraws(seed=SEED, mode="fedavg", m_real=C, gamma=1,
                       mediator_epochs=1, local_epochs=E, batch=B,
                       model=emnist_cnn(NC, HW), pad=pad))
    groups = []
    for _ in range(ROUNDS):
        port.run_round()
        groups.append(port.engine.last_groups)
    assert groups == selections
    assert port.comm.round_log == comm.round_log
    assert _diff(port.params, params) <= 1e-4
