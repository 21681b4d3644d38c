"""The sharded client store and locality placement on the CPU
(``core/client_store.py::ShardedStore``, ``core/scheduling.py::
place_mediators``), with four logical shards on the CPU.

``place_mediators`` equals the reference's exactly (arrays and stats).
``ShardedStore.plan`` is host numpy: on the reference's adversarial
schedules and on seeded random ones its plan arrays ``(route, loc, lpos,
rpos)`` are byte for byte the reference's, for both exchanges, and the
reference's brute-force simulator rebuilds every active slot from them.

On the reference's tiny federation (12 clients, 8 classes, 16 px, c=6,
gamma=3, ``pad_mediators_to=4``, two rounds with a reschedule each), the
replicated store and the sharded store under both exchanges give the same
params bit for bit under ``"vmap"`` and ``"map"``, with and without the
online Alg. 2 plan; sharded over 4 shards under ``"map"`` equals
replicated on one; async S=0 over the sharded store equals the sync run.

The reference's ``FLRoundEngine`` raises on its sharded store under JAX
0.9.0 (``ShardingTypeError`` on the sharded gather), so the port's sharded
run is held against the reference's mesh-free loop
(``torch_parity.reference_astraea``) with its replayed draws, within 1e-4
as the other system tests: the draws follow each mediator through
placement.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import client_store as jstore                          # noqa: E402
from repro.core import scheduling as jsched                            # noqa: E402
from repro.models import cnn as jcnn                                   # noqa: E402

from repro_torch.convert import params_from_jax                        # noqa: E402
from repro_torch.core import (AstraeaTrainer, AsyncRoundEngine, AsyncSpec,  # noqa: E402
                              EngineConfig, FLRoundEngine, LocalSpec,
                              StragglerSpec, scheduling)
from repro_torch.core.augmentation import augmentation_plan           # noqa: E402
from repro_torch.core.client_store import ShardedStore, build_client_store  # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition          # noqa: E402
from repro_torch.launch.mesh import make_mediator_mesh                 # noqa: E402
from repro_torch.models.cnn import emnist_cnn                          # noqa: E402
from repro_torch.obs import Telemetry                                  # noqa: E402
from repro_torch.optim import adam                                     # noqa: E402

from torch_parity import (JaxDraws, max_param_diff, padded_size,       # noqa: E402
                          reference_astraea, reference_params)

CPU = torch.device("cpu")
TOL = 1e-4


def _mesh(n):
    return make_mediator_mesh(devices=(CPU,) * n)


# --------------------------------------------------------------------------
# place_mediators
# --------------------------------------------------------------------------

def _same_placement(groups, n, rows, owner):
    got, got_stats = scheduling.place_mediators(groups, n, rows, owner)
    want, want_stats = jsched.place_mediators(groups, n, rows, owner)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got_stats == want_stats
    return got, got_stats


def test_place_mediators_hand_cases():
    """The reference's cases: mediators land on the shard holding their
    clients; an overloaded shard spills deterministically; too many
    mediators raise."""
    owner = lambda cid: cid // 4
    rows, stats = _same_placement([[0, 1], [4, 5], [2, 3], [6, 7]], 2, 2, owner)
    assert {rows[0], rows[1]} == {0, 2} and {rows[2], rows[3]} == {1, 3}
    assert stats["remote_fetches"] == 0 and stats["local_fetches"] == 8
    _, stats = _same_placement([[0, 1], [2, 3], [0, 2], [4, 5]], 2, 2, owner)
    assert stats["remote_fetches"] == 2
    for place in (scheduling.place_mediators, jsched.place_mediators):
        with pytest.raises(ValueError, match="do not fit"):
            place([[0]] * 5, 2, 2, owner)


@pytest.mark.parametrize("seed", range(6))
def test_place_mediators_random_groups(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([1, 2, 3, 4]))
    k_local = int(rng.integers(1, 6))
    rows = int(rng.integers(1, 4))
    m = int(rng.integers(0, n * rows + 1))
    groups = [[int(c) for c in rng.integers(0, n * k_local, rng.integers(1, 5))]
              for _ in range(m)]
    rtg, stats = _same_placement(groups, n, rows, lambda c: c // k_local)
    assert sorted(g for g in rtg if g >= 0) == list(range(m))
    assert stats["local_fetches"] + stats["remote_fetches"] == stats["total_fetches"]


# --------------------------------------------------------------------------
# the plan, byte for byte, and the brute-force reconstruction
# --------------------------------------------------------------------------

def _plan_only(cls, n, k_local, exchange):
    store = cls.__new__(cls)                    # no devices: host plan only
    store._n, store._k_local = n, k_local
    store._slice_nbytes = 8
    store.exchange = exchange
    store.last_placement_stats = {}
    if cls is jstore.ShardedStore:
        store._x = store._y = store._m = None
    return store


def _simulate_slot_values(store, plan, m_pad):
    """Re-run the exchange in numpy on data where row ``j`` of shard ``o``
    holds its global client id ``o * k_local + j`` (the reference's
    simulator): every active slot must come back as its ``idx``."""
    n, k_local = store._n, store._k_local
    m_local = max(1, m_pad // n)
    route, loc, lpos, rpos = (np.asarray(a) for a in plan)
    readers = np.arange(m_pad)[:, None] // m_local
    local_vals = readers * k_local + lpos
    if store.exchange == "gather":
        gathered = (np.arange(n)[:, None] * k_local + route).reshape(-1)
        remote_vals = gathered[rpos]
    else:
        r_cap = route.shape[2]
        recv = np.zeros((n, max(n - 1, 1) * r_cap), np.int64)
        for d in range(n):
            for s in range(1, n):
                o = (d - s) % n
                recv[d, (s - 1) * r_cap:s * r_cap] = o * k_local + route[o, s - 1]
        remote_vals = recv[readers, rpos]
    return np.where(loc, local_vals, remote_vals)


def _check_plan(n, k_local, exchange, idx, slot):
    """The port's plan equals the reference's byte for byte, its stats and
    bytes too, and reconstructs every active slot."""
    port = _plan_only(ShardedStore, n, k_local, exchange)
    ref = _plan_only(jstore.ShardedStore, n, k_local, exchange)
    _, got = port.plan(idx, slot)
    _, want = ref.plan(idx, slot)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert port.last_placement_stats == ref.last_placement_stats
    assert port.exchange_bytes_per_round == ref.exchange_bytes_per_round
    sim = _simulate_slot_values(port, got, idx.shape[0])
    active = slot > 0
    np.testing.assert_array_equal(sim[active], idx[active].astype(np.int64))
    stats = port.last_placement_stats
    assert 0 <= stats["serve_occupied"] <= stats["serve_capacity"]
    return port, got


def _all_remote(n=4, k_local=3, gamma=2):
    rng = np.random.default_rng(0)
    idx = np.empty((n, gamma), np.int32)
    for r in range(n):
        others = [c for c in range(n * k_local) if c // k_local != r]
        idx[r] = rng.choice(others, gamma)
    return n, k_local, idx, np.ones((n, gamma), np.float32)


def _all_duplicate():
    return 4, 3, np.full((8, 3), 4, np.int32), np.ones((8, 3), np.float32)


def _hot_owner():
    rng = np.random.default_rng(1)
    return 4, 8, rng.integers(0, 8, (4, 2)).astype(np.int32), np.ones((4, 2), np.float32)


@pytest.mark.parametrize("exchange", ["gather", "ragged"])
@pytest.mark.parametrize("case", ["all_remote", "all_duplicate", "hot_owner"])
def test_plan_adversarial_schedules_equal_reference(case, exchange):
    n, k_local, idx, slot = {"all_remote": _all_remote, "all_duplicate": _all_duplicate,
                             "hot_owner": _hot_owner}[case]()
    port, plan = _check_plan(n, k_local, exchange, idx, slot)
    loc = plan[1]
    if case == "all_remote":
        assert not loc.any()
    if case == "all_duplicate":
        assert loc[2:4].all() and not loc[[0, 1, 4, 5, 6, 7]].any()
        assert port.last_placement_stats["serve_occupied"] == \
            (1 if exchange == "gather" else n - 1)


@pytest.mark.parametrize("exchange", ["gather", "ragged"])
@pytest.mark.parametrize("n,k_local,m_local,gamma", [
    (1, 3, 2, 2), (2, 1, 1, 3), (2, 4, 3, 2), (3, 5, 2, 3), (4, 2, 1, 1), (4, 5, 3, 3)])
def test_plan_random_schedules_equal_reference(n, k_local, m_local, gamma, exchange):
    """Seeded random schedules and slot masks at several shard layouts."""
    for seed in range(4):
        rng = np.random.default_rng(1000 * n + 100 * k_local + 10 * m_local + seed)
        m_pad = n * m_local
        idx = rng.integers(0, n * k_local, (m_pad, gamma)).astype(np.int32)
        slot = (rng.random((m_pad, gamma)) < 0.7).astype(np.float32)
        _check_plan(n, k_local, exchange, idx, slot)


def test_ragged_bytes_below_gather_on_a_skewed_schedule():
    """Every read local but one: ragged ships one slice, the all-gather its
    whole capacity."""
    n, k_local, gamma, m_pad = 4, 8, 2, 8
    idx = ((np.arange(8)[:, None] // 2) * k_local + np.arange(2)[None, :]).astype(np.int32)
    idx[7, 1] = 3
    slot = np.ones((m_pad, gamma), np.float32)
    ragged, _ = _check_plan(n, k_local, "ragged", idx, slot)
    gather, _ = _check_plan(n, k_local, "gather", idx, slot)
    assert ragged.exchange_bytes_per_round == 8
    assert gather.exchange_bytes_per_round == n * min(m_pad * gamma, k_local) * (n - 1) * 8
    assert ragged.exchange_bytes_per_round < gather.exchange_bytes_per_round


def test_device_exchange_returns_the_replicated_slots():
    """On 4 CPU shards, ``slot_data`` of both exchanges gives exactly the
    replicated store's slots over a random schedule (the dummy clients
    padding K to a multiple of the shard count included)."""
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((10, 5, 3, 3, 1)).astype(np.float32)
    ys = rng.integers(0, 8, (10, 5)).astype(np.int32)
    ms = (rng.random((10, 5)) < 0.8).astype(np.float32)
    idx = rng.integers(0, 10, (8, 3))
    slot = np.ones((8, 3), np.float32)
    rep = build_client_store("replicated", xs, ys, ms, device=CPU)
    want = rep.slot_data(*rep.plan(idx, slot))
    for exchange in ("ragged", "gather"):
        store = build_client_store("sharded", xs, ys, ms, device=CPU, mesh=_mesh(4),
                                   exchange=exchange)
        assert store.per_device_bytes() == 3 * 5 * (9 * 4 + 4 + 4)
        got = store.slot_data(*store.plan(idx, slot))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# --------------------------------------------------------------------------
# the engine over 4 logical shards
# --------------------------------------------------------------------------

BASE = EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1), seed=0,
                            pad_mediators_to=4, reschedule_every_round=True)
ROUNDS = 2


def _federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=600, test_samples=160,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0)


FED = _federation()
PLAN = augmentation_plan(FED.client_counts().sum(0), 0.67)


def _engine(store, shards, row_exec="vmap", exchange="ragged", aug=False, **kw):
    cfg = dataclasses.replace(BASE, store=store, row_exec=row_exec, store_exchange=exchange)
    return FLRoundEngine(emnist_cnn(8, 16), adam(1e-3), FED, cfg, device="cpu",
                         mesh=_mesh(shards), aug_plan=PLAN if aug else None, **kw)


def _rounds(runner, rounds=ROUNDS, per_round=None):
    for _ in range(rounds):
        runner.run_round()
        if per_round is not None:
            per_round(runner)
    return runner


def _equal(a, b) -> bool:
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_stores_bitwise_on_four_shards(row_exec, aug):
    """Replicated, sharded-ragged and sharded-gather on 4 shards: the same
    params bit for bit, the same WAN ledger; the exchange's bytes on the
    intra-pod ledger each round, and a ``store_exchange`` instant a round."""
    rep = _rounds(_engine("replicated", 4, row_exec, aug=aug))
    charged = {}
    for exchange in ("ragged", "gather"):
        tel = Telemetry()
        per_round = []
        eng = _rounds(_engine("sharded", 4, row_exec, exchange, aug=aug, telemetry=tel),
                      per_round=lambda e: per_round.append(e.store.exchange_bytes_per_round))
        assert _equal(eng, rep), exchange
        # one round program a mediator row
        assert eng.num_round_traces == rep.num_round_traces == 4 * (row_exec == "vmap")
        assert eng.comm.round_log == rep.comm.round_log
        assert eng.comm.total_bytes == rep.comm.total_bytes
        ledger = eng.comm.ledger_totals()
        assert ledger["store_exchange_bytes_total"] == sum(per_round) > 0
        assert ledger["intra_pod_bytes_total"] == sum(per_round)
        instants = [e for e in tel.tracer.events if e["name"] == "store_exchange"]
        assert [e["attrs"]["bytes"] for e in instants] == per_round
        charged[exchange] = per_round
        st = eng.last_schedule_stats
        assert st["store_local_fetches"] + st["store_remote_fetches"] == \
            st["store_total_fetches"] == 6
        assert st["store_exchange"] == exchange and st["store_num_shards"] == 4
        assert eng.store.per_device_bytes() * 4 == rep.store.per_device_bytes()
        for shard in eng.store._shards:
            assert sum(t.nbytes for t in shard) == eng.store.per_device_bytes()
    assert rep.comm.ledger_totals()["store_exchange_bytes_total"] == 0
    assert all(r <= g for r, g in zip(charged["ragged"], charged["gather"]))


def test_sharded_four_shards_equals_replicated_on_one():
    """Under ``"map"`` the mesh changes nothing: sharded over 4 shards is
    replicated on one shard, bit for bit."""
    for exchange in ("ragged", "gather"):
        assert _equal(_rounds(_engine("sharded", 4, "map", exchange, aug=True)),
                      _rounds(_engine("replicated", 1, "map", aug=True)))


@pytest.mark.parametrize("dispatch", ["masked", "overlapped"])
def test_async_s0_over_the_sharded_store_equals_sync(dispatch):
    """A wave per mediator at S=0 over the sharded store: the sync run's
    params bit for bit (overlapped dispatch keeps the sharded store's waves
    masked); each masked wave charges the exchange and marks it with a
    ``store_exchange`` instant."""
    sync = _rounds(_engine("sharded", 4, aug=True))
    tel = Telemetry()
    eng = _engine("sharded", 4, aug=True, telemetry=tel)
    spec = AsyncSpec(staleness_bound=0, wave_size=1, dispatch=dispatch,
                     straggler=StragglerSpec(model="lognormal", seed=3))
    runner = _rounds(AsyncRoundEngine(eng, spec))
    assert _equal(eng, sync)
    assert eng.num_round_traces == 4 and not runner._sliced    # one a mediator row
    assert eng.comm.total_bytes == sync.comm.total_bytes
    # two mediators, so two masked waves, a round
    assert eng.comm.store_exchange_bytes == 2 * sync.comm.store_exchange_bytes > 0
    instants = [e["attrs"]["bytes"] for e in tel.tracer.events if e["name"] == "store_exchange"]
    assert len(instants) == 2 * ROUNDS and sum(instants) == eng.comm.store_exchange_bytes


def _loop_trainer(fed, init, store, shards):
    c, gamma, b = 6, 3, 10
    return AstraeaTrainer(
        emnist_cnn(8, 16), adam(1e-3), fed, clients_per_round=c, gamma=gamma,
        local=LocalSpec(b, 1), alpha=0.67, seed=0, device="cpu", init_params=init,
        row_exec="map", store=store, mesh=_mesh(shards), pad_mediators_to=4,
        reschedule_every_round=True,
        draws=JaxDraws(seed=0, mode="astraea", m_real=c // gamma, gamma=gamma,
                       mediator_epochs=1, local_epochs=1, batch=b, model=emnist_cnn(8, 16),
                       pad=padded_size(fed, b)))


def test_sharded_trainer_matches_reference_loop():
    """Astraea with the online plan over the sharded store on 4 shards,
    ``"map"``, the reference's params and draws, against the reference
    loop: the same groups and ledger, params within 1e-4, and bit for bit
    the replicated store's run.  On ``test_torch_engine``'s 300-sample
    federation, where the port's replicated run is held at 1e-4 (on this
    file's 600-sample one the replicated run itself is 2.0e-4 from the
    loop after two rounds; the sharded run equals it there too)."""
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    fed = partition(spec, num_clients=12, total_samples=300, test_samples=80,
                    sizes="instagram", global_dist="letterfreq", local="random", seed=0)
    params = reference_params(8, 16, 0)
    init = params_from_jax(params)
    want, groups, comm, _, _ = reference_astraea(
        jcnn.emnist_cnn(8, 16), params, fed, clients=6, gamma=3, batch=10, epochs=1,
        mediator_epochs=1, alpha=0.67, rounds=ROUNDS, seed=0,
        reschedule_every_round=True)
    port = _loop_trainer(fed, init, "sharded", 4)
    placed = []
    for _ in range(ROUNDS):
        port.run_round()
        placed.append(port.engine._schedule[4])
    assert any(not np.array_equal(rtg[:2], [0, 1]) for rtg in placed), placed
    assert port.engine.last_groups == groups
    assert port.comm.round_log == comm.round_log
    assert max_param_diff(port.params, want) <= TOL
    rep = _loop_trainer(fed, init, "replicated", 1)
    rep.fit(ROUNDS, eval_every=ROUNDS)
    assert _equal(port, rep)


def test_sharded_store_errors():
    with pytest.raises(ValueError, match="unknown store_exchange"):
        dataclasses.replace(BASE, store="sharded", store_exchange="all_to_all")
    with pytest.raises(ValueError, match="needs a mesh"):
        build_client_store("sharded", *FED.padded(), device=CPU)
    with pytest.raises(ValueError, match="pass devices explicitly"):
        make_mediator_mesh(4 + max(torch.cuda.device_count(), 0))
    eng = _engine("sharded", 4)
    eng.run_round()
    with pytest.raises(ValueError, match="run its waves masked"):
        eng.run_rows_sliced(eng.prepare_round(), eng.params, np.array([0]))
