"""The whole slice: the port's Astraea and FedAvg trainers against a
reference loop built from the JAX package's mesh-free parts
(``torch_parity.reference_astraea`` / ``reference_fedavg``: the reference
trainers cannot run under JAX 0.9.0, see there).  The port gets the same
initial params and the reference's own draws.  Selection, schedule and
WAN ledger must be identical; params agree to atol 1e-4 after two rounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import cnn as jcnn                              # noqa: E402

from repro_torch.convert import params_from_jax                   # noqa: E402
from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec  # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition     # noqa: E402
from repro_torch.models.cnn import emnist_cnn                     # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

from torch_parity import (JaxDraws, float64_tie_free, max_param_diff,  # noqa: E402
                          padded_size, reference_astraea, reference_fedavg,
                          reference_params)

NC, HW, K, C, GAMMA, ROUNDS, SEED = 8, 16, 12, 8, 4, 2, 0
B, E, E_M, ALPHA = 10, 1, 1, 0.67


@pytest.fixture(scope="module")
def federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=NC, image_size=HW)
    return partition(spec, num_clients=K, total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="letterfreq",
                     local="random", seed=SEED)


def test_astraea_slice_matches_reference_loop(federation):
    fed = federation
    params = reference_params(NC, HW, SEED)
    init = params_from_jax(params)
    pad = padded_size(fed, B)
    params, groups, comm, sched_counts, plan = reference_astraea(
        jcnn.emnist_cnn(NC, HW), params, fed, clients=C, gamma=GAMMA, batch=B,
        epochs=E, mediator_epochs=E_M, alpha=ALPHA, rounds=ROUNDS, seed=SEED)
    assert plan.any()
    assert float64_tie_free(sched_counts, GAMMA)          # strict comparison
    m_real = len(groups)

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
    assert max_param_diff(port.params, params) <= 1e-4
    assert set(hist[-1]) == {"accuracy", "loss", "round", "traffic_mb",
                             "mediator_kld_mean"}
    assert np.isfinite(hist[-1]["accuracy"])


def test_fedavg_slice_matches_reference_loop(federation):
    fed = federation
    params = reference_params(NC, HW, SEED)
    init = params_from_jax(params)
    pad = padded_size(fed, B)
    params, selections, comm = reference_fedavg(
        jcnn.emnist_cnn(NC, HW), params, fed, clients=C, batch=B, epochs=E,
        rounds=ROUNDS, seed=SEED)

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
    assert max_param_diff(port.params, params) <= 1e-4
