"""Unified metrics registry: counters / gauges / histograms, one export.

A copy of the JAX package's ``obs/metrics.py`` (plain Python): the port's
exposition text must equal the reference's for the same calls -- the same
names, help strings, bucket bounds and number format.

The telemetry layer (``obs.telemetry``) writes the engine's measurement
surfaces -- ``CommMeter``'s two ledgers, ``ClientStore.stats()``,
``engine.last_schedule_stats``, the async engine's commits -- into named
metrics once per round, and the registry exports them two ways:

* **per-round JSONL** (``metrics.jsonl``): one snapshot per round, every
  metric flattened to scalars;
* **Prometheus text exposition** (``to_prometheus()``): ``# TYPE``-tagged
  text served by ``launch/metrics_endpoint.py``. Counter samples keep
  their conventional ``_total`` suffix, histograms expand to
  ``_bucket{le=...}`` / ``_sum`` / ``_count``.

Counters mirror *cumulative* sources (the ``CommMeter`` ledgers are
already monotone running totals), so they support ``set_total`` with a
monotonicity check in addition to ``inc`` -- the exposition value is then
**exactly** the ledger value.
"""
from __future__ import annotations

import json
import math


class Counter:
    """Monotone cumulative value."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def set_total(self, total: float) -> None:
        """Mirror an external cumulative ledger (must never decrease)."""
        if total < self.value - 1e-9:
            raise ValueError(f"counter {self.name}: set_total({total}) "
                             f"below current {self.value}")
        self.value = total

    def sample(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value (last write wins)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value: float | None = None

    def set(self, value: float) -> None:
        self.value = value

    def sample(self) -> float:
        return 0.0 if self.value is None else self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound, ``+Inf`` counts all)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: tuple = (1, 2, 4, 8, 16),
                 help: str = ""):
        self.name, self.help = name, help
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.bounds) + 1)      # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
        self.counts[-1] += 1

    def sample(self) -> dict:
        row = {f"le_{_fmt(b)}": c
               for b, c in zip(self.bounds, self.counts)}
        row["le_inf"] = self.counts[-1]
        row["sum"] = self.sum
        row["count"] = self.count
        return row


def _fmt(bound: float) -> str:
    return str(int(bound)) if bound == int(bound) else str(bound)


class MetricsRegistry:
    """Get-or-create registry; one instance per telemetry handle."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self.round_rows: list[dict] = []

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help=help, **kwargs)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, buckets: tuple = (1, 2, 4, 8, 16),
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # ---- export ----
    def snapshot(self) -> dict:
        """Flat dict of every metric's current sample (histograms nest)."""
        return {name: m.sample() for name, m in sorted(self._metrics.items())}

    def end_round(self, round_index: int) -> dict:
        """Snapshot the registry at a round boundary (JSONL timeline)."""
        row = {"round": int(round_index), **self.snapshot()}
        self.round_rows.append(row)
        return row

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r, sort_keys=True) + "\n"
                       for r in self.round_rows)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                acc_name = name
                for b, c in zip(m.bounds, m.counts):
                    lines.append(f'{acc_name}_bucket{{le="{_fmt(b)}"}} {c}')
                lines.append(f'{acc_name}_bucket{{le="+Inf"}} '
                             f"{m.counts[-1]}")
                lines.append(f"{acc_name}_sum {_num(m.sum)}")
                lines.append(f"{acc_name}_count {m.count}")
            else:
                lines.append(f"{name} {_num(m.sample())}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


def _num(v: float) -> str:
    """Exact integers render without a trailing ``.0`` so byte totals
    diff cleanly against the integer ledgers."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)
