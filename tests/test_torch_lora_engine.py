"""The CNN round engine's LoRA adapter exchange, sync and async, on the CPU.

The reference's tiny federation (``emnist_cnn(8, image_size=16)``, 12
clients, C=8, gamma=4, E_m=1, B=10, E=1, ``sgd(0.05)``, 3 rounds, no Alg. 2
plan), as ``tests/test_lora.py`` runs it:

* the mapping table entry by entry against ``repro.models.lora``'s, and
  the leg's bytes;
* rank-2 Astraea and FedAvg rounds, with the reference's A and draws
  injected, against the mesh-free reference loop
  (``torch_parity.reference_lora``): each of the 3 rounds, from the
  reference's adapter state before it, within ``TOL`` of the reference's
  state after it (see below for a round on ReLU's kink); the merged
  weights within ``TOL``; the same 3 rounds run on from the port's own
  states within ``TRAJECTORY_TOL``; the WAN ledger exactly;
* full rank bit for bit the port's own full-delta round, under ``"map"``
  and ``"vmap"``, in both modes;
* rank 0: an empty state, no WAN byte, a ratio of exactly 0.0;
* the ledger: ``ROUNDS * LEGS * payload``, the counterfactual equal to the
  full-delta run's ``total_bytes``;
* one round program across reschedules; async S=0 bit for bit the sync
  run; the configuration checks.

``TOL`` = 1e-4, the bound the port's engine tests hold it to against the
reference (fp32 sums in another order, carried through the rounds);
everything counted on the host exactly.

A round can sit on ReLU's kink: at ``sgd(0.05)`` the rank-2 Astraea
rounds hold, now and then, a pre-activation within fp32 rounding of zero
(here the third round: a ``dense1`` pre-activation 1.5e-8 from it at one
step; from the reference engine's own init, the second: 4.5e-8).  Any
order of summation may put it on the other side, and the round then lands
8.4e-4 away (both ``"map"`` and ``"vmap"`` do from the reference's own
state; ``"map"`` from its own state, 1.2e-7 away, does not).  Such a
round is held to the reference from the same input moved by 1e-7 --
rounding level -- under up to ``KINK_TRIES`` seeded moves: one of them
must land within ``TOL``, which an implementation fault would not.  A
round may take that path only if it is in ``KINK_ROUNDS``, the rounds
known to sit on the kink, and only if its replay under ``"map"`` from the
reference's state meets a ReLU input within ``KINK_BAND`` of zero;
anything else that misses ``TOL`` fails at once.

The rounds above each start from the reference's state, so they hold no
drift.  The run on from the port's own states does: it is held to
``TRAJECTORY_TOL`` = 1e-3, which admits the one flip on the kink and
little more.  Readings on the CPU: Astraea under ``"vmap"`` lands 8.434e-4
from the reference after the third round (the flip) and within 1.2e-7
before it; Astraea under ``"map"`` and FedAvg under both within 1.2e-7 at
every round.
"""
import copy
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.data import federated as jfederated                     # noqa: E402
from repro.models import cnn as jcnn                               # noqa: E402
from repro.models import lora as RL                                # noqa: E402
from repro.optim.optimizers import sgd as jsgd                     # noqa: E402

from repro_torch.convert import adapter_tree_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import (AstraeaTrainer, AsyncSpec, EngineConfig,  # noqa: E402
                              FedAvgTrainer, FLRoundEngine, LocalSpec, StragglerSpec)
from repro_torch.data.federated import EMNIST_LIKE, partition      # noqa: E402
from repro_torch.kernels import ops                                # noqa: E402
from repro_torch.models import lora as PL                          # noqa: E402
from repro_torch.models.cnn import cinic_cnn, emnist_cnn, init_params  # noqa: E402
from repro_torch.optim import sgd                                  # noqa: E402

from torch_parity import (JaxDraws, adapter_tree_to_jax, padded_size,  # noqa: E402
                          reference_lora, reference_params)

C, GAMMA, EM, ROUNDS, B, E, NC, HW = 8, 4, 1, 3, 10, 1, 8, 16
LEGS = {"astraea": 2 * C * EM + 2 * math.ceil(C / GAMMA), "fedavg": 2 * C}
FED_KW = dict(num_clients=12, total_samples=600, test_samples=160, sizes="instagram",
              global_dist="letterfreq", local="random", seed=0)
FULL = PL.full_rank(emnist_cnn(NC, HW).param_specs())
TOL = 1e-4
TRAJECTORY_TOL = 1e-3
KINK_TRIES = 8
# (kind, row_exec) -> the rounds that sit on ReLU's kink (module docstring)
KINK_ROUNDS = {("astraea", "map"): {2}, ("astraea", "vmap"): {2}}
# a ReLU input this close to zero may change sign under another fp32
# order of summation: one unit in the last place at 1.0
KINK_BAND = 2.0 ** -23


@functools.lru_cache(maxsize=None)
def _federation():
    return partition(dataclasses.replace(EMNIST_LIKE, num_classes=NC, image_size=HW),
                     **FED_KW)


@functools.lru_cache(maxsize=None)
def _reference_federation():
    return jfederated.partition(dataclasses.replace(jfederated.EMNIST_LIKE, num_classes=NC,
                                                    image_size=HW), **FED_KW)


def _trainer(kind, row_exec, rank=None, *, jax_draws=False, init=None, **kw):
    """A port trainer on the tiny federation from ``init`` (default
    ``init_params(model, 0)``), with seeded draws or the reference's
    (``jax_draws``)."""
    model, fed = emnist_cnn(NC, HW), _federation()
    draws = None
    if jax_draws:
        draws = JaxDraws(seed=0, mode=kind, m_real=C // GAMMA if kind == "astraea" else C,
                         gamma=GAMMA if kind == "astraea" else 1, mediator_epochs=EM,
                         local_epochs=E, batch=B, model=model, pad=padded_size(fed, B))
    common = dict(clients_per_round=C, local=LocalSpec(B, E), alpha=None, seed=0,
                  device="cpu", row_exec=row_exec,
                  init_params=init if init is not None else init_params(model, 0),
                  lora_rank=rank, draws=draws, **kw)
    if kind == "fedavg":
        return FedAvgTrainer(model, sgd(0.05), fed, **common)
    return AstraeaTrainer(model, sgd(0.05), fed, gamma=GAMMA, mediator_epochs=EM, **common)


def _rounds(tr, n=ROUNDS):
    for _ in range(n):
        tr.run_round()
    return tr


@functools.lru_cache(maxsize=None)
def _run(kind, row_exec, rank=None):
    """A finished ``ROUNDS``-round run, shared by the tests that only read it."""
    return _rounds(_trainer(kind, row_exec, rank))


def _bitwise(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- mapping

@pytest.mark.parametrize("arm", ["emnist", "cinic"])
@pytest.mark.parametrize("rank", ["0", "2", "full"])
def test_mapping_equals_reference(arm, rank):
    """Entry by entry (path, shape, kind, rank, din, dout, batch), in the
    reference's order, and the leg's bytes and the full rank."""
    if arm == "emnist":
        ours, theirs = emnist_cnn(NC, HW), jcnn.emnist_cnn(NC, image_size=HW)
    else:
        ours, theirs = cinic_cnn(10, 16, 3, 8), jcnn.cinic_cnn(10, 16, 3, 8)
    specs, jspecs = ours.param_specs(), theirs.param_specs()
    assert PL.full_rank(specs) == RL.full_rank(jspecs)
    r = {"0": 0, "2": 2, "full": RL.full_rank(jspecs)}[rank]
    got, want = PL.build_mapping(specs, r), RL.build_mapping(jspecs, r)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert (g.path, g.shape, g.kind, g.rank, g.din, g.dout, g.batch_shape,
                g.batch_axes, g.alpha, g.state_shape) == \
            (w.path, w.shape, w.kind, w.rank, w.din, w.dout, w.batch_shape,
             w.batch_axes, w.alpha, w.state_shape), path
        if w.kind == "factorized":
            assert g.a_shape == w.a_shape
    assert PL.exchange_nbytes(got) == RL.exchange_nbytes(want)
    # every port weight is covered once, in the port's layout
    names = [n for e in got.values() for n in e.names]
    if r:
        assert sorted(names) == sorted(n for n, _ in ours.named_parameters())


def test_merge_permutes_into_the_port_layout():
    """A rank-2 merge with the reference's A and a random state: the port's
    weights are the reference's merge in the port's layout (conv OIHW,
    dense transposed), within fp32 rounding; dense entries bit for bit."""
    model = emnist_cnn(NC, HW)
    jparams = reference_params(NC, HW)
    mapping = PL.build_mapping(model.param_specs(), 2)
    _, a, jmapping, *_ = _reference("astraea")
    rng = np.random.default_rng(0)
    state = {p: rng.standard_normal(e.state_shape).astype(np.float32)
             for p, e in jmapping.items()}
    merge = jax.jit(lambda b, a_, st: RL.merge_params(b, a_, st, jmapping))
    want = params_from_jax(jax.tree.map(np.asarray, merge(jparams, a, state)))
    got = PL.merge_params(params_from_jax(jparams), adapter_tree_from_jax(a),
                          adapter_tree_from_jax(state), mapping)
    for k in want:
        dense = k.endswith("bias")
        assert torch.equal(got[k], want[k]) if dense else \
            torch.allclose(got[k], want[k], rtol=0, atol=1e-6), k
    # the round-0 state is the reference's: zero B, the backbone's biases
    ours = PL.init_adapter_state(mapping, params_from_jax(jparams))
    theirs = RL.init_adapter_state(jmapping, jax.tree.map(np.asarray, jparams))
    assert all(np.array_equal(adapter_tree_to_jax(ours)[p], np.asarray(theirs[p]))
               for p in theirs)


# ---------------------------------------------------------------- against the reference

@functools.lru_cache(maxsize=None)
def _reference(kind):
    fed, out = _reference_federation(), {}
    res = reference_lora(jcnn.emnist_cnn(NC, image_size=HW), reference_params(NC, HW), fed,
                         kind=kind, clients=C, batch=B, epochs=E, rounds=ROUNDS, seed=0,
                         rank=2, opt=jsgd(0.05), gamma=GAMMA, mediator_epochs=EM, out=out)
    return res + (out["states"],)


def _state_err(ours: dict, theirs: dict) -> float:
    got = adapter_tree_to_jax(ours)
    return max(float(np.abs(got[p] - np.asarray(theirs[p])).max()) for p in theirs)


def _reference_start(states, r) -> dict:
    """The reference's adapter state before round ``r``, as the port's."""
    return adapter_tree_from_jax({p: np.array(v) for p, v in states[r].items()})


def _smallest_relu_input(kind, a_tree, states, r, monkeypatch) -> float:
    """The smallest ``|x|`` any ReLU meets in round ``r`` of the reference's
    trajectory, replayed under ``"map"`` (eager, so each input can be read)
    from the reference's states before it."""
    tr = _trainer(kind, "map", 2, jax_draws=True)
    tr.engine.load_lora_a(adapter_tree_from_jax(a_tree))
    for i in range(r):
        tr.engine.server_state = _reference_start(states, i)
        tr.run_round()
    seen, relu = [], torch.nn.functional.relu

    def recording_relu(x, *args, **kwargs):
        seen.append(float(x.detach().abs().min()))
        return relu(x, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(torch.nn.functional, "relu", recording_relu)
        tr.engine.server_state = _reference_start(states, r)
        tr.run_round()
    assert seen, "the replay met no ReLU"
    return min(seen)


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_rank2_rounds_match_reference_loop(kind, row_exec, monkeypatch):
    """The reference's A and draws injected: each round, from the
    reference's adapter state before it, ends within ``TOL`` of the
    reference's state after it -- a round of ``KINK_ROUNDS`` that misses,
    and whose replay meets a ReLU input within ``KINK_BAND`` of zero, from
    that input moved by 1e-7 (module docstring) -- and the last round's
    merged weights within ``TOL`` of the reference's; the rounds that
    retried are exactly ``KINK_ROUNDS``'; the same rounds run on from the
    port's own states within ``TRAJECTORY_TOL`` at every round; the WAN
    ledger (adapter legs and their counterfactual) exactly."""
    _, a_tree, _, comm, merged, states = _reference(kind)
    for x, y in zip(_federation().client_images, _reference_federation().client_images):
        np.testing.assert_array_equal(x, y)
    tr = _trainer(kind, row_exec, 2, jax_draws=True)
    tr.engine.load_lora_a(adapter_tree_from_jax(a_tree))
    assert _state_err(tr.engine.adapters, states[0]) == 0.0
    free = copy.deepcopy(tr)
    retried = set()
    for r in range(ROUNDS):
        start = _reference_start(states, r)
        tr.engine.server_state = start
        before = copy.deepcopy(tr)
        tr.run_round()
        errs = [_state_err(tr.engine.adapters, states[r + 1])]
        if errs[-1] > TOL:
            assert r in KINK_ROUNDS.get((kind, row_exec), set()), \
                f"round {r} misses TOL ({errs[-1]:.3e}) and is not a known kink round"
            smallest = _smallest_relu_input(kind, a_tree, states, r, monkeypatch)
            assert smallest < KINK_BAND, \
                f"round {r} misses TOL ({errs[-1]:.3e}) but no ReLU input is within " \
                f"{KINK_BAND:.3e} of zero (smallest {smallest:.3e})"
            retried.add(r)
        for seed in range(KINK_TRIES):
            if errs[-1] <= TOL:
                break
            moved = copy.deepcopy(before)
            gen = torch.Generator().manual_seed(seed)
            moved.engine.server_state = {p: v + 1e-7 * torch.randn(v.shape, generator=gen)
                                         for p, v in start.items()}
            moved.run_round()
            errs.append(_state_err(moved.engine.adapters, states[r + 1]))
            tr = moved
        assert errs[-1] <= TOL, (r, errs)
        free.run_round()
        drift = _state_err(free.engine.adapters, states[r + 1])
        assert drift <= TRAJECTORY_TOL, (r, drift)
    assert retried == KINK_ROUNDS.get((kind, row_exec), set()), retried
    want = params_from_jax(jax.tree.map(np.asarray, merged))
    mp = tr.engine.merged_params()
    err = max(float((mp[k] - want[k]).abs().max()) for k in want)
    assert err <= TOL, err
    assert tr.comm.round_log == comm.round_log
    assert (tr.comm.wan_adapter_bytes, tr.comm.wan_adapter_full_equiv_bytes) == \
        (comm.wan_adapter_bytes, comm.wan_adapter_full_equiv_bytes)
    assert tr.engine.num_round_traces == (row_exec == "vmap")
    assert free.comm.round_log == comm.round_log


# ---------------------------------------------------------------- the engine's own rounds

@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_full_rank_is_the_full_delta_round_bitwise(kind, row_exec):
    """At full rank every entry is dense: the merged weights equal the
    full-delta run's bit for bit, and the adapter legs cost the full
    model (ratio exactly 1.0)."""
    ref = _run(kind, row_exec)
    tr = _run(kind, row_exec, FULL)
    assert all(e.kind == "dense" for e in tr.engine._lora_mapping.values())
    assert _bitwise(tr.engine.merged_params(), ref.params)
    assert tr.comm.adapter_reduction_ratio == 1.0
    assert tr.comm.round_log == ref.comm.round_log
    # the backbone stays frozen
    assert _bitwise(tr.params, init_params(emnist_cnn(NC, HW), 0))


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
def test_rank0_is_a_frozen_backbone(row_exec):
    """Rank 0: an empty adapter state that no round changes, no Eq. 6
    launch, zero WAN bytes, a reduction ratio of exactly 0.0 (the
    counterfactual still accrues)."""
    tr = _trainer("astraea", row_exec, 0)
    ops.reset_launches()
    _rounds(tr, 2)
    eng = tr.engine
    assert eng.adapters == {} and eng._layout.total == 0
    assert ops.LAUNCHES["fedavg_agg"] == 0
    assert _bitwise(eng.merged_params(), eng.params)
    assert _bitwise(eng.params, init_params(emnist_cnn(NC, HW), 0))
    assert eng.comm.total_bytes == 0 == eng.comm.wan_adapter_bytes
    assert eng.comm.adapter_reduction_ratio == 0.0
    assert eng.num_round_traces == (row_exec == "vmap")


@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_ledger_is_exact(kind):
    """Every leg carries ``exchange_nbytes``: ``ROUNDS * LEGS * payload`` on
    the WAN, the counterfactual equal to the full-delta run's total."""
    tr = _run(kind, "vmap", 2)
    payload = PL.exchange_nbytes(tr.engine._lora_mapping)
    comm = tr.comm
    assert comm.adapter_payload_bytes == payload == 4 * 636
    assert comm.wan_adapter_bytes == ROUNDS * LEGS[kind] * payload == comm.total_bytes
    assert comm.wan_full_delta_bytes == 0
    assert comm.wan_adapter_full_equiv_bytes == ROUNDS * LEGS[kind] * comm.model_bytes \
        == _run(kind, "vmap").comm.total_bytes
    assert comm.adapter_reduction_ratio == payload / comm.model_bytes <= 0.10


def test_one_round_program_across_reschedules():
    """A fresh Alg. 3 schedule every round: one round program (one
    ``trace_log`` entry, ``"initial"``), merging never builds one."""
    tr = _trainer("astraea", "vmap", 2, reschedule_every_round=True)
    _rounds(tr)
    tr.engine.merged_params()
    tr.run_round()
    eng = tr.engine
    assert eng.num_round_traces == 1 and eng.num_schedule_packs == ROUNDS + 1
    assert eng.trace_log == [{"fn": "round_fn", "width": 2, "round": 0,
                              "trace_index": 1, "reason": "initial"}]


@pytest.mark.parametrize("kind,row_exec,dispatch", [("astraea", "vmap", "masked"),
                                                    ("fedavg", "map", "overlapped")])
def test_async_s0_is_the_sync_run_bitwise(kind, row_exec, dispatch):
    """S=0, a wave per mediator (three clients for FedAvg) behind a 4x
    straggler: adapters, merged weights and WAN ledger bit for bit the sync
    run's; the dispatch snapshot and the commits are the adapter state."""
    sync = _run(kind, row_exec, 2)
    spec = AsyncSpec(staleness_bound=0, wave_size=1 if kind == "astraea" else 3,
                     dispatch=dispatch, straggler=StragglerSpec(
                         model="fixed", straggler_frac=0.5, slowdown=4.0, seed=0))
    tr = _trainer(kind, row_exec, 2, async_spec=spec)
    tr.fit(ROUNDS, eval_every=ROUNDS)
    assert _bitwise(tr.engine.adapters, sync.engine.adapters)
    assert _bitwise(tr.engine.merged_params(), sync.engine.merged_params())
    assert tr.comm.round_log == sync.comm.round_log
    assert tr.comm.wan_adapter_bytes == sync.comm.wan_adapter_bytes
    assert tr.runner.num_commits == ROUNDS
    assert all(s == 0 for c in tr.runner.commit_log for s in c["staleness"])


def test_config_checks_raise():
    local = LocalSpec(B, E)
    with pytest.raises(ValueError, match="lora_rank must be >= 0"):
        EngineConfig.astraea(clients_per_round=C, gamma=GAMMA, local=local, lora_rank=-1)
    with pytest.raises(ValueError, match="lora_alpha requires lora_rank"):
        EngineConfig.fedavg(clients_per_round=C, local=local, lora_alpha=2.0)

    class NoSpecs(torch.nn.Module):           # a model without param_specs
        def __init__(self):
            super().__init__()
            self.inner = emnist_cnn(NC, HW)

        def named_parameters(self, *a, **kw):
            return self.inner.named_parameters(*a, **kw)

    cfg = EngineConfig.astraea(clients_per_round=C, gamma=GAMMA, local=local, lora_rank=2)
    with pytest.raises(ValueError, match="param_specs"):
        FLRoundEngine(NoSpecs(), sgd(0.05), _federation(), cfg, device="cpu")
    eng = _trainer("astraea", "map", 2).engine
    with pytest.raises(ValueError, match="A paths"):
        eng.load_lora_a({"conv1/w": torch.zeros(25, 2)})
