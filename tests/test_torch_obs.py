"""The port's round telemetry (``repro_torch/obs``, ``launch/metrics_endpoint``)
on the CPU.

* ``Tracer`` and ``MetricsRegistry`` against the reference's
  (``repro.obs``): the same calls, under the same fake clock, give the
  same ``to_jsonl()``, ``to_chrome_trace()`` and ``to_prometheus()`` text;
  ``Telemetry.observe_round`` / ``observe_async_round`` over the same
  engine surfaces give the same exposition.
* Traced port runs on the reference's tiny federation (``emnist_cnn(8,
  image_size=16)``, C=8, gamma=4, B=10, E=1, ``sgd(0.05)``): their
  ``events.jsonl`` passes the reference's ``validate_events`` with span
  names from its taxonomy; on and off give bitwise-equal trajectories and
  the same round programs, sync and async, with and without LoRA; the
  Prometheus WAN counters equal ``CommMeter``; ``metrics.jsonl`` has a
  row a round; the staleness histogram absorbs every commit.
* ``MetricsServer`` on ``127.0.0.1`` port 0 serves the registry's text at
  ``/metrics`` and a 404 elsewhere.
"""
import dataclasses
import functools
import json
import os
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import obs as R                                         # noqa: E402
from repro.core.comm import CommMeter as JCommMeter                # noqa: E402

from repro_torch import obs as P                                   # noqa: E402
from repro_torch.core import (AstraeaTrainer, AsyncSpec, FedAvgTrainer,  # noqa: E402
                              LocalSpec, StragglerSpec)
from repro_torch.core.comm import CommMeter                        # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition      # noqa: E402
from repro_torch.launch.metrics_endpoint import CONTENT_TYPE, MetricsServer  # noqa: E402
from repro_torch.models.cnn import emnist_cnn, init_params         # noqa: E402
from repro_torch.optim import sgd                                  # noqa: E402

C, GAMMA, ROUNDS = 8, 4, 3
# the reference's span taxonomy (repro/obs/README.md)
TAXONOMY = {"round", "plan_refresh", "reschedule", "pack", "store_stream", "aggregate",
            "wave", "dispatch_gap", "commit", "store_exchange", "commit_lag",
            "store_prefetch"}
FLEET = StragglerSpec(model="fixed", straggler_frac=0.5, slowdown=4.0, seed=0)


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]
    return clock


# ---------------------------------------------------------------- text parity

def _drive_tracer(mod):
    """One span / instant sequence, with every attribute kind the engines
    set (ints, floats, strings, bools, None, numpy scalars, lists)."""
    tr = mod.Tracer(clock=_fake_clock())
    with tr.span("round", round=0, cohort=8, schedule="kld", policy="host") as r:
        with tr.span("reschedule", cohort=8) as s:
            s.set(kld_mean=np.float32(0.125), num_mediators=np.int64(2))
        with tr.span("pack", m_real=2, m_pad=2, policy="host") as p:
            with tr.span("store_stream", policy="host") as ss:
                ss.set(bytes=4096)
            p.set(stream_bytes=4096)
        tr.instant("store_exchange", bytes=0)
        with tr.span("aggregate", mediators=2):
            pass
        r.set(wan_bytes=1.5e6, traces=1, flag=True, none=None, waves=[0, 1])
    with tr.span("commit_lag", round=1, pending=0) as c:
        c.set(waited_s=0.0)
    tr.instant("store_prefetch", hit=False, rows=np.int32(8))
    return tr


def test_tracer_text_equals_reference():
    ours, theirs = _drive_tracer(P), _drive_tracer(R)
    assert ours.to_jsonl() == theirs.to_jsonl()
    assert json.dumps(ours.to_chrome_trace(), sort_keys=True) == \
        json.dumps(theirs.to_chrome_trace(), sort_keys=True)
    R.validate_events(ours.events)
    assert P.SCHEMA_VERSION == R.SCHEMA_VERSION


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("astraea_wan_bytes_total", "wan").set_total(1024)
    reg.counter("astraea_commits_total").inc(3)
    reg.gauge("astraea_round_traces", "programs").set(1)
    reg.gauge("astraea_virtual_time").set(2.5)
    h = reg.histogram("astraea_staleness", (0, 1, 2, 4, 8), "staleness")
    for v in (0, 1, 1, 3, 9):
        h.observe(v)
    reg.histogram("astraea_round_duration_seconds", (0.001, 0.01, 0.1, 1.0, 10.0, 60.0)
                  ).observe(0.05)
    reg.end_round(1)
    reg.counter("astraea_wan_bytes_total").set_total(4096.5)
    reg.gauge("astraea_unset")
    reg.end_round(2)
    return reg


def test_registry_text_equals_reference():
    ours, theirs = _drive_registry(P), _drive_registry(R)
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert ours.to_jsonl() == theirs.to_jsonl()
    with pytest.raises(TypeError):
        ours.gauge("astraea_wan_bytes_total")
    with pytest.raises(ValueError):
        ours.counter("astraea_wan_bytes_total").set_total(1)


def _fake_engines(meter_cls):
    """Engine surfaces as the telemetry reads them, the ledger from
    ``meter_cls`` (the port's or the reference's ``CommMeter``)."""
    comm = meter_cls(num_params=68_873)
    comm.plan_broadcast(47, 64)
    comm.adapter_payload_bytes = 4 * 753
    comm.astraea_round(16, 4, 1)
    comm.store_stream(12_345)
    comm.end_round()
    store = types.SimpleNamespace(stats=lambda: {
        "policy": "spilled", "per_device_bytes": 3_018_240, "streamed_bytes": 12_345,
        "prefetch_hits": 1, "spill_dir": None, "lru_evictions": 0})
    eng = types.SimpleNamespace(
        _round=1, comm=comm, num_round_traces=1, num_schedule_packs=1,
        trace_log=[{"fn": "round_fn", "reason": "initial"}, {"fn": "wave_fn", "reason": "retrace"}],
        last_schedule_stats={"kld_mean": 0.5, "kld_max": 0.75, "num_mediators": 4}, store=store)
    aeng = types.SimpleNamespace(
        engine=eng, num_commits=2, virtual_time=3.0, sync_time=4.5,
        commit_log=[{"staleness": [0, 0, 1], "folded_rows": 3},
                    {"staleness": [2], "folded_rows": 1}],
        last_wave_stats={"num_waves": 4, "barrier_time": 4.0, "blocked_time_saved": 1.5},
        overlap_frac=0.25, staleness_bound=2, num_syncs=1, wall_commit_wait_s=0.125)
    return eng, aeng


def test_telemetry_absorption_equals_reference():
    """``observe_round`` and ``observe_async_round`` over the same engine
    surfaces: the same exposition and the same per-round rows."""
    out = []
    for mod, meter in ((P, CommMeter), (R, JCommMeter)):
        tel = mod.Telemetry(clock=_fake_clock())
        eng, aeng = _fake_engines(meter)
        tel.observe_round(eng, duration_s=0.5)
        tel.observe_async_round(aeng, duration_s=0.25)
        out.append((tel.metrics.to_prometheus(), tel.metrics.to_jsonl()))
    assert out[0] == out[1]
    assert not P.NULL_TELEMETRY.enabled and P.as_telemetry(None) is P.NULL_TELEMETRY
    with P.NULL_TELEMETRY.span("round", x=1) as s:
        assert s.set(y=2) is s and s.sync_on(torch.zeros(1)) is s
    assert P.NULL_TELEMETRY.flush() == {}


def test_device_trace_without_a_card(tmp_path):
    """No CUDA device here: the device trace stays off (False), host spans
    only; waiting on CPU tensors is a no-op."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert P.start_device_trace(str(tmp_path)) is False
    assert P.stop_device_trace() is None
    P.sync_on({"a": torch.zeros(2), "b": [torch.ones(1)]})


# ---------------------------------------------------------------- traced runs

@functools.lru_cache(maxsize=None)
def _federation():
    return partition(dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16),
                     num_clients=12, total_samples=600, test_samples=160, sizes="instagram",
                     global_dist="letterfreq", local="random", seed=0)


def _trainer(kind="astraea", telemetry=None, async_bound=None, **kw):
    model = emnist_cnn(8, 16)
    if async_bound is not None:
        kw["async_spec"] = AsyncSpec(staleness_bound=async_bound, wave_size=1,
                                     straggler=FLEET)
    common = dict(clients_per_round=C, local=LocalSpec(10, 1), seed=0, device="cpu",
                  init_params=init_params(model, 0), telemetry=telemetry, **kw)
    if kind == "fedavg":
        return FedAvgTrainer(model, sgd(0.05), _federation(), **common)
    return AstraeaTrainer(model, sgd(0.05), _federation(), gamma=GAMMA, alpha=0.67,
                          **common)


def _run(tr, rounds=ROUNDS):
    for _ in range(rounds):
        tr.run_round()
    if tr.runner is not tr.engine:
        tr.runner.flush()
    return tr


# the traced sync run: the adaptive plan (a reschedule every round), the
# spilled store, LoRA at rank 2
SYNC_KW = dict(adaptive_plan=True, reschedule_every_round=True, store="spilled",
               lora_rank=2)


@functools.lru_cache(maxsize=None)
def _traced(mode: str, trace_dir: str):
    """A traced run: ``"sync"`` (``SYNC_KW``) or ``"async"`` (S=1, a wave
    per mediator)."""
    tel = P.Telemetry(os.path.join(trace_dir, mode))
    if mode == "sync":
        tr = _trainer(telemetry=tel, **SYNC_KW)
    else:
        tr = _trainer(telemetry=tel, async_bound=1)
    _run(tr)
    return tr, tel, tel.flush()


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("obs"))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_events_pass_reference_validation(trace_dir, mode):
    """The four artifacts exist; the events pass the reference's
    ``validate_events``; their span names come from its taxonomy; one root
    ``round`` span a round, the phases nested in it."""
    tr, tel, paths = _traced(mode, trace_dir)
    assert sorted(paths) == ["events_jsonl", "metrics_jsonl", "metrics_prom", "trace_json"]
    events = R.load_jsonl(paths["events_jsonl"])
    R.validate_events(events)
    names = {e["name"] for e in events}
    assert names <= TAXONOMY, names - TAXONOMY
    rounds = [e for e in events if e["name"] == "round"]
    assert len(rounds) == ROUNDS and all(e["parent"] is None for e in rounds)
    rids = {e["id"] for e in rounds}
    if mode == "sync":
        assert {"plan_refresh", "reschedule", "pack", "store_stream", "aggregate",
                "store_prefetch"} <= names
        for e in events:
            if e["name"] in ("reschedule", "pack", "aggregate", "plan_refresh"):
                assert e["parent"] in rids
    else:
        assert {"wave", "dispatch_gap", "commit", "commit_lag"} <= names
        assert all(e["attrs"]["mode"] == "async" for e in rounds)
        for rspan in rounds:         # the waves' charges are the round's
            waves = [e for e in events if e["name"] == "wave" and e["parent"] == rspan["id"]]
            assert sum(e["attrs"]["wan_bytes"] for e in waves) == rspan["attrs"]["wan_bytes"]
    with open(paths["trace_json"]) as f:
        assert len(json.load(f)["traceEvents"]) == len(events)


# the traced runs' settings, and two more: async S=0, FedAvg on the host store
INVISIBLE = {"sync": SYNC_KW, "async": {"async_bound": 1}, "async-s0": {"async_bound": 0},
             "fedavg-host": {"kind": "fedavg", "store": "host"}}


@pytest.mark.parametrize("case", list(INVISIBLE))
def test_telemetry_is_bitwise_invisible(trace_dir, case):
    """On against off: the same trained state bit for bit, the same WAN
    ledger and the same round programs, every one the first of its width."""
    kw = INVISIBLE[case]
    off = _run(_trainer(**kw))
    if case in ("sync", "async"):
        on = _traced(case, trace_dir)[0]
    else:
        on = _run(_trainer(telemetry=P.Telemetry(os.path.join(trace_dir, case)), **kw))
    a, b = off.engine.server_state, on.engine.server_state
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert off.comm.round_log == on.comm.round_log
    assert off.engine.num_round_traces == on.engine.num_round_traces >= 1
    assert all(t["reason"] == "initial" for t in on.engine.trace_log)
    assert on.engine.store.telemetry is on.engine.telemetry
    assert off.engine.telemetry is P.NULL_TELEMETRY is off.engine.store.telemetry


def _samples(prom: str) -> dict:
    return {line.split()[0]: float(line.split()[1]) for line in prom.splitlines()
            if not line.startswith("#") and "{" not in line}


def test_prometheus_ledgers_equal_comm_meter(trace_dir):
    """Every cumulative ledger mirrored exactly, the adapter ratio too, and
    the flushed ``metrics.prom`` is the live exposition."""
    tr, tel, paths = _traced("sync", trace_dir)
    prom = tel.metrics.to_prometheus()
    sample = _samples(prom)
    for key, total in tr.comm.ledger_totals().items():
        assert sample[f"astraea_{key}"] == total, key
    assert sample["astraea_wan_bytes_total"] == tr.comm.total_bytes > 0
    assert sample["astraea_wan_adapter_reduction_ratio"] == tr.comm.adapter_reduction_ratio
    assert sample["astraea_store_stream_bytes_total"] == tr.comm.store_stream_bytes > 0
    assert sample["astraea_rounds_total"] == ROUNDS
    assert sample["astraea_round_traces"] == 1 and sample["astraea_unexpected_retraces"] == 0
    assert sample["astraea_schedule_packs_total"] == ROUNDS
    with open(paths["metrics_prom"]) as f:
        assert f.read() == prom


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_metrics_jsonl_has_one_row_a_round(trace_dir, mode):
    """One row a round (the async flush adds its own last row), cumulative
    counters never decreasing."""
    _, _, paths = _traced(mode, trace_dir)
    rows = P.load_jsonl(paths["metrics_jsonl"])
    want = list(range(1, ROUNDS + 1)) + ([ROUNDS] if mode == "async" else [])
    assert [r["round"] for r in rows] == want
    for a, b in zip(rows, rows[1:]):
        assert b["astraea_wan_bytes_total"] >= a["astraea_wan_bytes_total"]


def test_staleness_histogram_absorbs_every_commit(trace_dir):
    tr, tel, _ = _traced("async", trace_dir)
    snap = tel.metrics.snapshot()
    stales = [s for c in tr.runner.commit_log for s in c["staleness"]]
    hist = snap["astraea_staleness"]
    assert hist["count"] == hist["le_inf"] == len(stales) > 0
    assert hist["sum"] == sum(stales) and max(stales) == 1
    assert snap["astraea_commits_total"] == tr.runner.num_commits
    assert snap["astraea_commit_folded_rows_total"] == len(stales)


def test_metrics_endpoint_scrape(trace_dir):
    """A live ``GET /metrics`` serves the registry's exposition with the
    Prometheus content type; another path is a 404."""
    tr, tel, _ = _traced("sync", trace_dir)
    with MetricsServer(tel.metrics) as srv:
        resp = urllib.request.urlopen(srv.url, timeout=10)
        assert resp.headers["Content-Type"] == CONTENT_TYPE
        assert resp.read().decode() == tel.metrics.to_prometheus()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://{srv.host}:{srv.port}/other", timeout=10)
        assert err.value.code == 404
    assert srv._httpd is None
