"""The port's bounded-staleness async rounds on the CPU.

* ``core/staleness.py`` and ``scheduling.partition_waves`` against the
  reference's (numpy both): exactly equal over a seeded sweep of specs,
  durations, groups and lag streams.
* S=0 against the port's own sync engine: bit for bit under
  ``row_exec="map"`` in both dispatch modes, and under ``"vmap"`` for
  masked dispatch (the sync round's program, the rows outside a wave
  masked); overlapped ``"vmap"`` within ``TOL`` (its sliced programs batch
  another width).
* S=1, 2 and an adaptive S against the mesh-free reference loop
  (``torch_parity.reference_async``): params within ``TOL``, the
  staleness of every folded row and the WAN ledger exactly.

``TOL`` = 1e-4 in every parameter, the bound the port's engine tests hold
it to against the reference (fp32 sums in another order, carried through
Adam); everything counted on the host (waves, clocks, staleness, ledgers)
exactly.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import scheduling as jsched                        # noqa: E402
from repro.core import staleness as jst                            # noqa: E402
from repro.models import cnn as jcnn                               # noqa: E402

from repro_torch.convert import params_from_jax                    # noqa: E402
from repro_torch.core import (AdaptiveStalenessSpec, AstraeaTrainer,  # noqa: E402
                              AsyncSpec, FedAvgTrainer, LocalSpec, StragglerSpec,
                              scheduling)
from repro_torch.core import staleness as st                       # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition       # noqa: E402
from repro_torch.models.cnn import emnist_cnn, init_params          # noqa: E402
from repro_torch.optim import adam                                  # noqa: E402

from torch_parity import (JaxDraws, max_param_diff, padded_size,   # noqa: E402
                          reference_async, reference_params)

TOL = 1e-4


# ---------------------------------------------------------------- staleness

def _random_spec(rng, mod):
    return mod.StragglerSpec(
        model=str(rng.choice(["none", "fixed", "lognormal"])),
        straggler_frac=float(rng.uniform(0, 1)), slowdown=float(rng.uniform(1, 8)),
        sigma=float(rng.uniform(0, 1.5)), seed=int(rng.integers(0, 1000)),
        level=str(rng.choice(["mediator", "client"])))


@pytest.mark.parametrize("seed", range(8))
def test_staleness_matches_reference(seed):
    """Twenty random fleets per seed: factors, durations (per slot and per
    group), every policy's discount, the adaptive bound after a random lag
    stream, and the waves of those durations -- all exactly equal."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        spec = _random_spec(rng, st)
        jspec = jst.StragglerSpec(**dataclasses.asdict(spec))
        n = int(rng.integers(1, 40))
        k = int(rng.integers(n, 4 * n + 1))
        if spec.level == "client":
            mine, ref = st.StragglerModel(spec, n, k), jst.StragglerModel(jspec, n, k)
            groups = np.array_split(rng.permutation(k), n)
            epochs = int(rng.integers(1, 3))
            d = mine.durations_for_groups(groups, epochs)
            np.testing.assert_array_equal(d, ref.durations_for_groups(groups, epochs))
        else:
            mine, ref = st.StragglerModel(spec, n), jst.StragglerModel(jspec, n)
            work = rng.integers(1, 5, n).astype(np.float64)
            d = mine.durations(work)
            np.testing.assert_array_equal(d, ref.durations(work))
        np.testing.assert_array_equal(mine.factors, ref.factors)
        size = int(rng.integers(0, n + 2))
        waves, stats = scheduling.partition_waves(d, size)
        assert (waves, stats) == jsched.partition_waves(d, size)
        assert sorted(i for w in waves for i in w) == list(range(n))
        for name in st.POLICIES:
            a = float(rng.uniform(0, 2))
            lam, jlam = st.make_staleness_policy(name, a), jst.make_staleness_policy(name, a)
            assert [lam(s) for s in range(7)] == [jlam(s) for s in range(7)]
            assert lam(0) == 1.0
        lo = int(rng.integers(0, 3))
        aspec = dict(s_min=lo, s_max=lo + int(rng.integers(0, 4)),
                     beta=float(rng.uniform(0.05, 1)), init=float(rng.uniform(0, 3)))
        ctl = st.AdaptiveStaleness(st.AdaptiveStalenessSpec(**aspec))
        jctl = jst.AdaptiveStaleness(jst.AdaptiveStalenessSpec(**aspec))
        for lag in rng.integers(0, 4, int(rng.integers(0, 12))):
            ctl.observe(int(lag))
            jctl.observe(int(lag))
            assert (ctl.ewma, ctl.bound) == (jctl.ewma, jctl.bound)


INVALID_SPECS = [
    (st.StragglerSpec, dict(model="gamma")), (st.StragglerSpec, dict(straggler_frac=1.5)),
    (st.StragglerSpec, dict(slowdown=0.5)), (st.StragglerSpec, dict(level="device")),
    (st.AdaptiveStalenessSpec, dict(s_min=-1)),
    (st.AdaptiveStalenessSpec, dict(s_min=3, s_max=2)),
    (st.AdaptiveStalenessSpec, dict(beta=0.0)), (st.AdaptiveStalenessSpec, dict(init=-1.0)),
    (AsyncSpec, dict(staleness_bound=-1)), (AsyncSpec, dict(dispatch="eager")),
    (AsyncSpec, dict(dispatch="overlapped", block_each_wave=True)),
    (AsyncSpec, dict(policy="linear")), (AsyncSpec, dict(policy_alpha=-0.1)),
]


@pytest.mark.parametrize("cls,kw", INVALID_SPECS)
def test_spec_validation(cls, kw):
    """Each invalid field raises ValueError, as the reference's does."""
    with pytest.raises(ValueError):
        cls(**kw)
    ref = {st.StragglerSpec: jst.StragglerSpec,
           st.AdaptiveStalenessSpec: jst.AdaptiveStalenessSpec}.get(cls)
    if ref is not None:
        with pytest.raises(ValueError):
            ref(**kw)


def test_straggler_model_misuse_raises():
    with pytest.raises(ValueError, match="num_clients"):
        st.StragglerModel(st.StragglerSpec(level="client"), 4)
    with pytest.raises(ValueError, match="covers"):
        st.StragglerModel(st.StragglerSpec(), 2).durations(np.ones(3))
    with pytest.raises(ValueError, match="zero mediators"):
        scheduling.partition_waves(np.zeros(0), 1)


# ---------------------------------------------------------------- the engine

SMALL = dict(NC=8, HW=16, K=12, B=10, E=1, SEED=0)


@functools.lru_cache(maxsize=None)
def _federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=SMALL["NC"], image_size=SMALL["HW"])
    return partition(spec, num_clients=SMALL["K"], total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=SMALL["SEED"])


def _trainer(kind, row_exec, async_spec=None, draws=None, init=None, **kw):
    model = emnist_cnn(SMALL["NC"], SMALL["HW"])
    common = dict(clients_per_round=8, local=LocalSpec(SMALL["B"], SMALL["E"]),
                  seed=SMALL["SEED"], device="cpu", row_exec=row_exec,
                  init_params=init if init is not None else init_params(model, 0),
                  async_spec=async_spec, draws=draws)
    if kind == "fedavg":
        return FedAvgTrainer(model, adam(1e-3), _federation(), **common, **kw)
    return AstraeaTrainer(model, adam(1e-3), _federation(), gamma=4, alpha=0.67,
                          **common, **kw)


ROUNDS = 2


@functools.lru_cache(maxsize=None)
def _sync(kind, row_exec, pad=None):
    tr = _trainer(kind, row_exec, pad_mediators_to=pad)
    tr.fit(ROUNDS, eval_every=ROUNDS)
    return tr


# waves: one (the barrier) or many (a wave per mediator for Astraea, of
# three clients for FedAvg) behind a 4x straggler
WAVES = {"single": 0, "multi": None}
FLEET = StragglerSpec(model="fixed", straggler_frac=0.5, slowdown=4.0, seed=0)


@pytest.mark.parametrize("waves", ["single", "multi"])
@pytest.mark.parametrize("dispatch", ["masked", "overlapped"])
@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_s0_equals_sync(kind, row_exec, dispatch, waves):
    """S=0: the same params as the sync engine (bit for bit but under
    overlapped ``"vmap"``, ``TOL`` there), the same WAN ledger, every row
    folded fresh, and the programs built: the sync one under masked
    ``"vmap"``, one per wave width under overlapped, none under ``"map"``."""
    size = WAVES[waves] if WAVES[waves] is not None else (1 if kind == "astraea" else 3)
    spec = AsyncSpec(staleness_bound=0, wave_size=size, straggler=FLEET, dispatch=dispatch)
    tr = _trainer(kind, row_exec, spec)
    hist = tr.fit(ROUNDS, eval_every=ROUNDS)
    ref = _sync(kind, row_exec)
    assert tr.comm.round_log == ref.comm.round_log
    exact = row_exec == "map" or dispatch == "masked"
    if exact:
        assert all(torch.equal(tr.params[k], ref.params[k]) for k in ref.params)
    else:
        err = max(float((tr.params[k] - ref.params[k]).abs().max()) for k in ref.params)
        assert err <= TOL, err
    log = tr.runner.commit_log
    assert [c["round"] for c in log] == list(range(ROUNDS))
    assert all(s == 0 for c in log for s in c["staleness"])
    m = 8 // 4 if kind == "astraea" else 8
    assert [c["folded_rows"] for c in log] == [m] * ROUNDS
    widths = {len(w) for w in np.array_split(np.arange(m), -(-m // (size or m)))}
    built = 0 if row_exec == "map" else (1 if dispatch == "masked" else len(widths))
    assert tr.engine.num_round_traces == built
    assert hist[-1]["sim_speedup"] == 1.0 and hist[-1]["commits"] == ROUNDS


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
def test_s0_dummy_rows_fold_like_sync(row_exec):
    """Three rows for two mediators (a dummy row, weight 0): the masked and
    overlapped S=0 runs fold the dummy tail as the sync round does."""
    ref = _sync("astraea", row_exec, pad=3)
    for dispatch in ("masked", "overlapped"):
        tr = _trainer("astraea", row_exec, AsyncSpec(wave_size=1, straggler=FLEET,
                                                     dispatch=dispatch),
                      pad_mediators_to=3)
        tr.fit(ROUNDS, eval_every=ROUNDS)
        if row_exec == "map" or dispatch == "masked":
            assert all(torch.equal(tr.params[k], ref.params[k]) for k in ref.params)
        else:
            err = max(float((tr.params[k] - ref.params[k]).abs().max())
                      for k in ref.params)
            assert err <= TOL, err


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_noop_row_is_exact(kind, row_exec):
    """A row whose every slot is masked out, through the sliced program:
    exactly zero deltas (Astraea) or exactly the weights it started from
    (FedAvg) -- what ``noop_rows`` gives the dummy tail of a commit."""
    tr = _trainer(kind, row_exec)
    eng = tr.engine
    inp = eng.prepare_round()
    inp = dataclasses.replace(inp, parts=[(x, y, torch.zeros_like(m))
                                          for x, y, m in inp.parts])
    out = eng.run_rows_sliced(inp, eng.params, np.array([0, 1]))
    want = eng.noop_rows(eng.params, 2)
    assert torch.equal(out, want)
    if kind == "astraea":
        assert not bool(want.any())


def test_overlapped_caches_one_program_per_width():
    """A FedAvg cohort of 8 in waves of 3 (widths 3, 3 and 2): one program
    per width, built at its first use and reused every round after."""
    tr = _trainer("fedavg", "vmap", AsyncSpec(wave_size=3, straggler=FLEET,
                                              dispatch="overlapped"))
    tr.run_round()
    progs = dict(tr.engine._wave_programs)
    assert sorted(progs) == [2, 3] and tr.engine.num_round_traces == 2
    tr.run_round()
    assert tr.engine._wave_programs == progs and tr.engine.num_round_traces == 2


def _reference_fleet(spec: StragglerSpec):
    return jst.StragglerSpec(**dataclasses.asdict(spec))


# (kind, staleness_bound, adaptive, wave_size, fleet)
STALE_CASES = [
    ("astraea", 1, None, 1, FLEET),
    ("astraea", 2, None, 1, FLEET),
    ("astraea", 0, AdaptiveStalenessSpec(s_min=0, s_max=2, beta=0.5, init=1.0), 1, FLEET),
    ("fedavg", 1, None, 3, StragglerSpec(model="fixed", straggler_frac=0.25,
                                         slowdown=4.0, seed=1)),
]


@pytest.mark.parametrize("kind,bound,adaptive,size,fleet", STALE_CASES)
def test_stale_rounds_match_reference_loop(kind, bound, adaptive, size, fleet):
    """Three rounds with S=1, S=2 or the adaptive bound, a 4x straggler:
    the staleness of every folded row and the WAN ledger equal the
    reference loop's, the params within ``TOL``; some row folds stale."""
    rounds = 3
    fed = _federation()
    params = reference_params(SMALL["NC"], SMALL["HW"], SMALL["SEED"])
    jadaptive = None if adaptive is None else \
        jst.AdaptiveStalenessSpec(**dataclasses.asdict(adaptive))
    want, comm, log = reference_async(
        jcnn.emnist_cnn(SMALL["NC"], SMALL["HW"]), params, fed, kind=kind, clients=8,
        batch=SMALL["B"], epochs=SMALL["E"], rounds=rounds, seed=SMALL["SEED"],
        staleness_bound=bound, wave_size=size, straggler=_reference_fleet(fleet),
        adaptive=jadaptive, gamma=4 if kind == "astraea" else 1,
        alpha=0.67 if kind == "astraea" else None)
    m_real = 2 if kind == "astraea" else 8
    draws = JaxDraws(seed=SMALL["SEED"], mode=kind, m_real=m_real,
                     gamma=4 if kind == "astraea" else 1, mediator_epochs=1,
                     local_epochs=SMALL["E"], batch=SMALL["B"],
                     model=emnist_cnn(SMALL["NC"], SMALL["HW"]),
                     pad=padded_size(fed, SMALL["B"]))
    spec = AsyncSpec(staleness_bound=bound, wave_size=size, straggler=fleet,
                     adaptive=adaptive, dispatch="overlapped")
    tr = _trainer(kind, "vmap", spec, draws=draws, init=params_from_jax(params))
    tr.fit(rounds, eval_every=rounds)
    got = [{"round": c["round"], "staleness": c["staleness"]} for c in tr.runner.commit_log]
    assert got == log
    assert any(s > 0 for c in log for s in c["staleness"])
    assert tr.comm.round_log == comm.round_log
    assert max_param_diff(tr.params, want) <= TOL


@pytest.mark.parametrize("dispatch,block", [("masked", False), ("masked", True),
                                            ("overlapped", False)])
def test_wave_charges_sum_to_round_formula(dispatch, block):
    """Per round the waves' charges sum to ``2|w|(c E_m + ceil(c/gamma))``,
    plus the plan broadcast, in every dispatch mode; the blocking baseline
    never finds a wave in flight (``overlap_frac`` 0)."""
    spec = AsyncSpec(staleness_bound=2, wave_size=1, straggler=FLEET,
                     dispatch=dispatch, block_each_wave=block)
    tr = _trainer("astraea", "map", spec)
    hist = tr.fit(3, eval_every=3)
    w = 4 * sum(p.numel() for p in tr.params.values())
    plan = 4 * SMALL["NC"] * SMALL["K"]
    per_round = 2 * w * (8 * 1 + math.ceil(8 / 4))
    assert tr.comm.round_log == [plan + per_round * (r + 1) for r in range(3)]
    run = tr.runner
    assert run.num_dispatches == 3 * 2 and run._overlap_checks == 3 * 2 - 1
    assert run.overlap_frac == 0.0 and hist[-1]["overlap_frac"] == 0.0
    stales = [s for c in run.commit_log for s in c["staleness"]]
    assert len(stales) == 3 * 2 and max(stales) <= 2
    assert hist[-1]["sim_speedup"] > 1.0 and run.num_syncs >= 1


def test_async_history_keys_and_flush():
    """``fit`` flushes the pending waves at its end (the last commit folds
    them at round ``rounds``) and writes the reference's history keys."""
    spec = AsyncSpec(staleness_bound=1, wave_size=1, straggler=FLEET)
    tr = _trainer("astraea", "map", spec)
    hist = tr.fit(2, eval_every=1)
    assert [h["round"] for h in hist] == [1, 2]
    keys = {"accuracy", "loss", "round", "traffic_mb", "sim_time", "sync_sim_time",
            "sim_speedup", "commits", "overlap_frac", "staleness_bound",
            "staleness_mean", "staleness_max", "mediator_kld_mean"}
    assert keys <= set(hist[-1])
    run = tr.runner
    assert not run._pending and run.commit_log[-1]["round"] == 2
    assert sum(c["folded_rows"] for c in run.commit_log) == 2 * 2
    run.flush()                          # nothing pending: a no-op
    assert len(run.commit_log) == hist[-1]["commits"]
