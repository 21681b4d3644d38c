"""The ``telemetry=`` handle: tracer + registry + the no-op default.

The JAX package's ``obs/telemetry.py``, over the port's engines: the same
metric names (``astraea_*``), help strings and four artifacts.
``Telemetry`` is what engines, trainers and stores accept.  It bundles a
``Tracer`` (span timeline) with a ``MetricsRegistry`` (per-round
counters/gauges/histograms) and absorbs the engine's measurement surfaces
once per round:

* both ``CommMeter`` ledgers and their breakdown counters (WAN bytes are
  mirrored with ``set_total`` so the Prometheus sample equals
  ``CommMeter.total_bytes`` exactly);
* ``ClientStore.stats()`` (every numeric key becomes an
  ``astraea_store_*`` metric);
* scheduler stats (KLD mean/max);
* engine health: ``num_round_traces`` (round programs built) plus the
  engine's ``trace_log`` -- a program built for a width that already had
  one counts as an unexpected rebuild;
* the async engine's staleness distribution, wave timings and commits.

**Off by default, and off means zero.** ``as_telemetry(None)`` returns
``NULL_TELEMETRY``, whose spans are a reused no-op context manager and
whose observe hooks return immediately: no clock reads, no device waits,
no attribute formatting.  Nothing here runs inside the round program's
CUDA graph, so telemetry on or off gives bitwise-equal trajectories and
builds no extra program.
"""
from __future__ import annotations

import os

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

#: histogram bucket layouts (documented in obs/README.md)
STALENESS_BUCKETS = (0, 1, 2, 4, 8)
SECONDS_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 60.0)


class _NullSpan:
    """Reused no-op span: the telemetry-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return self

    def sync_on(self, value):
        return self

    duration_s = 0.0


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """Do-nothing stand-in carrying the full ``Telemetry`` surface."""

    enabled = False
    tracer = None
    metrics = None

    def span(self, name, **attrs):
        return _NULL_SPAN

    def instant(self, name, **attrs):
        return None

    def observe_round(self, engine, *, duration_s=None):
        return None

    def observe_async_round(self, aengine, *, duration_s=None):
        return None

    def flush(self):
        return {}


NULL_TELEMETRY = NullTelemetry()


def as_telemetry(handle) -> "Telemetry | NullTelemetry":
    """Normalize the optional ``telemetry=`` argument: ``None``/``False``
    mean off (the shared no-op singleton), a handle passes through."""
    if handle is None or handle is False:
        return NULL_TELEMETRY
    return handle


class Telemetry:
    """Enabled telemetry: host-side spans + per-round metric absorption.

    ``trace_dir`` (optional) is where ``flush()`` writes the artifacts:
    ``events.jsonl``, ``trace.json`` (Chrome/Perfetto), ``metrics.jsonl``
    (per-round timeline) and ``metrics.prom`` (Prometheus text).
    ``profile=True`` wraps each span in ``torch.profiler.record_function``;
    ``clock`` is injectable for deterministic tests.
    """

    enabled = True

    def __init__(self, trace_dir: str | None = None, *,
                 profile: bool = False, clock=None):
        self.trace_dir = trace_dir
        self.tracer = Tracer(clock=clock, profile=profile)
        self.metrics = MetricsRegistry()
        self._absorbed_commits = 0

    # ---- tracing passthrough ----
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def instant(self, name: str, **attrs) -> None:
        self.tracer.instant(name, **attrs)

    # ---- per-round absorption ----
    def observe_round(self, engine, *, duration_s: float | None = None):
        """Absorb the sync engine's measurement surfaces after a round
        (the async wrapper calls this too, then adds its own)."""
        m = self.metrics
        m.counter("astraea_rounds_total",
                  "synchronization rounds completed").set_total(engine._round)
        ledger_help = {
            "wan_bytes_total":
                "WAN ledger: client<->server bytes (CommMeter.total_bytes)",
            "wan_full_delta_bytes_total":
                "WAN exchange legs shipped full-size (no adapter mapping)",
            "wan_adapter_bytes_total":
                "WAN exchange legs shipped as LoRA adapter state",
            "wan_adapter_full_equiv_bytes_total":
                "full-size counterfactual of the adapter exchange legs",
            "intra_pod_bytes_total":
                "datacenter ledger (CommMeter.intra_pod_bytes)",
            "model_axis_tp_bytes_total":
                "2-D mesh tensor-parallel gather bytes",
            "store_stream_bytes_total":
                "host->device client-store streaming bytes",
            "store_exchange_bytes_total":
                "sharded-store serve exchange bytes",
        }
        for key, total in engine.comm.ledger_totals().items():
            m.counter(f"astraea_{key}",
                      ledger_help.get(key, "CommMeter cumulative ledger")
                      ).set_total(total)
        ratio = engine.comm.adapter_reduction_ratio
        if ratio is not None:
            # the scrapeable adapter-vs-full WAN reduction (bytes shipped /
            # full-size counterfactual of the same legs)
            m.gauge("astraea_wan_adapter_reduction_ratio",
                    "LoRA adapter WAN bytes over their full-delta "
                    "equivalent").set(ratio)
        m.gauge("astraea_round_traces",
                "round executable (re)compilations -- must stay 1"
                ).set(engine.num_round_traces)
        m.counter("astraea_schedule_packs_total",
                  "host schedule packing events"
                  ).set_total(engine.num_schedule_packs)
        retraces = [t for t in getattr(engine, "trace_log", [])
                    if t["reason"] != "initial"]
        m.gauge("astraea_unexpected_retraces",
                "round/wave traces beyond the first per entry point"
                ).set(len(retraces))
        stats = engine.last_schedule_stats or {}
        for key in ("kld_mean", "kld_max", "kld_median", "kld_min",
                    "num_mediators"):
            if key in stats:
                m.gauge(f"astraea_schedule_{key}").set(stats[key])
        for key, value in stats.items():
            # satellite fix in engine._pack_schedule namespaces the store
            # placement keys as store_*; mirror the numeric ones
            if key.startswith("store_") and isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                m.gauge(f"astraea_{key}").set(value)
        for key, value in engine.store.stats().items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                m.gauge(f"astraea_store_{key}",
                        "ClientStore.stats() mirror").set(value)
        if duration_s is not None:
            m.histogram("astraea_round_duration_seconds", SECONDS_BUCKETS,
                        "host wall-clock per round (traced runs only)"
                        ).observe(duration_s)
        return m.end_round(engine._round)

    def observe_async_round(self, aengine, *,
                            duration_s: float | None = None):
        """Absorb the async wrapper's staleness/wave/commit surfaces, then
        the wrapped engine's round surfaces (one JSONL row per round)."""
        m = self.metrics
        m.counter("astraea_commits_total",
                  "server commits folded").set_total(aengine.num_commits)
        m.gauge("astraea_virtual_time",
                "async simulated clock").set(aengine.virtual_time)
        m.gauge("astraea_sync_sim_time",
                "synchronous-barrier baseline on the same fleet"
                ).set(aengine.sync_time)
        stale_hist = m.histogram("astraea_staleness", STALENESS_BUCKETS,
                                 "per-contribution commit staleness s_m")
        folded = m.counter("astraea_commit_folded_rows_total",
                           "mediator rows folded across commits")
        for entry in aengine.commit_log[self._absorbed_commits:]:
            for s in entry["staleness"]:
                stale_hist.observe(s)
            folded.inc(entry["folded_rows"])
        self._absorbed_commits = len(aengine.commit_log)
        if aengine.last_wave_stats:
            ws = aengine.last_wave_stats
            m.gauge("astraea_waves_per_round").set(ws["num_waves"])
            m.gauge("astraea_wave_barrier_time").set(ws["barrier_time"])
            m.gauge("astraea_wave_blocked_time_saved"
                    ).set(ws["blocked_time_saved"])
        # dispatch-pipeline surfaces (overlapped mode; zeros when masked)
        m.gauge("astraea_wave_overlap_frac",
                "fraction of wave dispatches issued while the previous "
                "wave's result was still in flight"
                ).set(aengine.overlap_frac)
        m.gauge("astraea_staleness_bound",
                "staleness bound S governing the next commit (adaptive "
                "EWMA bound when configured, else the fixed knob)"
                ).set(aengine.staleness_bound)
        m.counter("astraea_pipeline_syncs_total",
                  "synchronize() pipeline drains (eval/flush boundaries)"
                  ).set_total(aengine.num_syncs)
        m.counter("astraea_commit_wait_seconds_total",
                  "host wall seconds spent draining the commit pipeline"
                  ).set_total(aengine.wall_commit_wait_s)
        return self.observe_round(aengine.engine, duration_s=duration_s)

    # ---- artifacts ----
    def flush(self) -> dict:
        """Write the four artifacts into ``trace_dir`` (no-op without one).
        Returns ``{artifact_name: path}`` for the files written."""
        if not self.trace_dir:
            return {}
        os.makedirs(self.trace_dir, exist_ok=True)
        paths = {
            "events_jsonl": os.path.join(self.trace_dir, "events.jsonl"),
            "trace_json": os.path.join(self.trace_dir, "trace.json"),
            "metrics_jsonl": os.path.join(self.trace_dir, "metrics.jsonl"),
            "metrics_prom": os.path.join(self.trace_dir, "metrics.prom"),
        }
        self.tracer.write_jsonl(paths["events_jsonl"])
        self.tracer.write_chrome_trace(paths["trace_json"])
        self.metrics.write_jsonl(paths["metrics_jsonl"])
        self.metrics.write_prometheus(paths["metrics_prom"])
        return paths
