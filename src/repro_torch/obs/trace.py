"""Host-side span tracing for the federated round path.

The JAX package's ``obs/trace.py`` with its three device hooks in torch.
A ``Tracer`` records a tree of **spans** -- named wall-clock intervals
with attributes -- plus zero-duration **instant** events, all on the
host.  The engine opens spans around its host-side phases (``round`` >
``reschedule``/``plan_refresh``/``pack`` > ``store_stream``, the sync
``aggregate``, the async ``wave``/``dispatch_gap``/``commit``), never
inside the round program's CUDA graph.

Two export formats, both derived from the same event list:

* **JSONL** (``events.jsonl``): one JSON object per line, schema-versioned
  (``SCHEMA_VERSION``); ``validate_events`` checks the schema and the
  nesting invariants (parents exist, child intervals sit inside their
  parent's interval).
* **Chrome trace** (``trace.json``): the Trace Event Format consumed by
  Perfetto / ``chrome://tracing`` -- complete ``"X"`` events with ``ts``/
  ``dur`` in microseconds.

Device-sync discipline: a span waits for the card only on tensors
registered through ``Span.sync_on``, and only at span close -- the
current stream of each tensor's device is synchronized, so the span's
duration covers the device work it launched.  Only an enabled tracer
ever waits: the no-op telemetry (``obs.telemetry.NULL_TELEMETRY``) never
touches a tensor.  A wait inside a CUDA graph capture would break the
capture, so ``sync_on`` refuses to run there.

``Tracer(profile=True)`` wraps every span in
``torch.profiler.record_function`` so a device trace shows the host
spans beside the kernels; ``start_device_trace``/``stop_device_trace``
bracket a run with a ``torch.profiler.profile`` of the CPU and CUDA
activities that writes a Chrome trace into ``log_dir``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import torch

#: bump when the JSONL event schema changes shape (validators pin this)
SCHEMA_VERSION = 1

#: keys every JSONL event must carry
EVENT_KEYS = ("schema", "kind", "id", "parent", "name", "ts_us", "dur_us",
              "attrs")

#: the file ``stop_device_trace`` writes into the traced run's ``log_dir``
DEVICE_TRACE_FILE = "device_trace.json"


def _tensors(value) -> list[torch.Tensor]:
    """The tensors in a (nested dict / list / tuple of) value(s)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def sync_on(value) -> None:
    """Wait until the work queued on the current stream of each CUDA
    device holding a tensor of ``value`` has finished (CPU tensors need no
    wait).  Raises inside a CUDA graph capture, where a wait is illegal."""
    devices = {t.device for t in _tensors(value) if t.device.type == "cuda"}
    if devices and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("sync_on inside a CUDA graph capture: spans wait "
                           "for the card only outside the round program")
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One open interval; use as a context manager via ``Tracer.span``."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "t0", "t1",
                 "_tracer", "_sync", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: int | None, attrs: dict):
        self.name, self.attrs = name, dict(attrs)
        self.span_id, self.parent_id = span_id, parent_id
        self._tracer = tracer
        self._sync: list[Any] = []
        self._annotation = None
        self.t0 = self.t1 = 0.0

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (KLD mean, bytes, ...)."""
        self.attrs.update(attrs)
        return self

    def sync_on(self, value: Any) -> "Span":
        """Register a (dict / list / tuple of) tensor(s) whose device work
        the span waits for at close, so its duration covers it."""
        self._sync.append(value)
        return self

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def __enter__(self) -> "Span":
        tracer = self._tracer
        if tracer.profile:
            self._annotation = tracer._annotate(self.name)
            self._annotation.__enter__()
        tracer._stack.append(self.span_id)
        self.t0 = tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._sync:
            sync_on(self._sync)
        tracer = self._tracer
        self.t1 = tracer.clock()
        assert tracer._stack and tracer._stack[-1] == self.span_id, \
            "span close out of order (spans must nest)"
        tracer._stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
        tracer._emit(self)


class Tracer:
    """Append-only span/instant recorder with JSONL + Chrome-trace export.

    ``clock`` defaults to ``time.perf_counter`` (monotonic); tests inject
    a fake clock for deterministic timestamps.  ``profile=True`` wraps
    each span in ``torch.profiler.record_function``.
    """

    def __init__(self, *, clock: Callable[[], float] | None = None,
                 profile: bool = False):
        self.clock = clock or time.perf_counter
        self.profile = profile
        self.events: list[dict] = []
        self._stack: list[int] = []
        self._next_id = 0
        self._epoch = self.clock()

    # ---- recording ----
    def span(self, name: str, **attrs) -> Span:
        sid, self._next_id = self._next_id, self._next_id + 1
        parent = self._stack[-1] if self._stack else None
        return Span(self, name, sid, parent, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker (e.g. a ledger charge) at the current
        nesting level."""
        sid, self._next_id = self._next_id, self._next_id + 1
        now = self.clock()
        self.events.append(self._event("instant", sid,
                                       self._stack[-1] if self._stack
                                       else None,
                                       name, now, now, attrs))

    def _emit(self, span: Span) -> None:
        self.events.append(self._event("span", span.span_id, span.parent_id,
                                       span.name, span.t0, span.t1,
                                       span.attrs))

    def _event(self, kind, sid, parent, name, t0, t1, attrs) -> dict:
        return {"schema": SCHEMA_VERSION, "kind": kind, "id": sid,
                "parent": parent, "name": name,
                "ts_us": (t0 - self._epoch) * 1e6,
                "dur_us": (t1 - t0) * 1e6,
                "attrs": _jsonable(attrs)}

    @staticmethod
    def _annotate(name: str):
        return torch.profiler.record_function(name)

    # ---- export ----
    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, sort_keys=True) + "\n"
                       for e in self.events)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def to_chrome_trace(self) -> dict:
        """Trace Event Format: complete ``"X"`` events, us timestamps --
        loadable in Perfetto / chrome://tracing as-is."""
        trace_events = []
        for e in self.events:
            trace_events.append({
                "name": e["name"], "cat": "astraea",
                "ph": "X" if e["kind"] == "span" else "i",
                "ts": e["ts_us"], "dur": e["dur_us"],
                "pid": 0, "tid": 0,
                "args": dict(e["attrs"], event_id=e["id"],
                             parent=e["parent"]),
            })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA_VERSION}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def _jsonable(attrs: dict) -> dict:
    """Coerce numpy scalars so every event round-trips json.dumps."""
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
            try:
                v = v.item()
            except Exception:
                v = repr(v)
        elif not isinstance(v, (str, int, float, bool, type(None), list,
                                dict, tuple)):
            v = repr(v)
        out[k] = v
    return out


def validate_events(events: list[dict]) -> None:
    """Raise ``ValueError`` unless ``events`` is a schema-valid span tree.

    Checks: every event carries exactly the schema-versioned key set;
    every ``parent`` id names an emitted span; every child span's
    interval nests inside its parent's.
    """
    spans: dict[int, dict] = {}
    for i, e in enumerate(events):
        missing = [k for k in EVENT_KEYS if k not in e]
        if missing:
            raise ValueError(f"event {i} missing keys {missing}: {e}")
        if e["schema"] != SCHEMA_VERSION:
            raise ValueError(f"event {i} schema {e['schema']} != "
                             f"{SCHEMA_VERSION}")
        if e["kind"] not in ("span", "instant"):
            raise ValueError(f"event {i} bad kind {e['kind']!r}")
        if e["dur_us"] < 0:
            raise ValueError(f"event {i} negative duration")
        if e["kind"] == "span":
            spans[e["id"]] = e
    for e in events:
        p = e["parent"]
        if p is None:
            continue
        if p not in spans:
            raise ValueError(f"event {e['id']} parent {p} never emitted "
                             f"as a span")
        parent = spans[p]
        lo, hi = parent["ts_us"], parent["ts_us"] + parent["dur_us"]
        if not (lo - 1e-3 <= e["ts_us"] and
                e["ts_us"] + e["dur_us"] <= hi + 1e-3):
            raise ValueError(
                f"event {e['id']} ({e['name']}) interval "
                f"[{e['ts_us']}, {e['ts_us'] + e['dur_us']}] escapes "
                f"parent {p} ({parent['name']}) [{lo}, {hi}]")


def load_jsonl(path: str) -> list[dict]:
    """Parse an ``events.jsonl`` file back into the event list."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---- device trace: torch.profiler over the CPU and CUDA activities ----
# one at a time, as the profiler's CUDA tracing is one session a process
_DEVICE_TRACE: dict = {}


def start_device_trace(log_dir: str) -> bool:
    """Begin a ``torch.profiler`` trace of the CPU and CUDA activities
    beside the host spans; ``stop_device_trace`` writes it to
    ``log_dir/device_trace.json``.  Returns False (host spans only) on a
    machine without a CUDA device or without the profiler's CUDA
    activity; on a card it returns True or raises."""
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if not torch.cuda.is_available() or \
            ProfilerActivity.CUDA not in supported_activities():
        return False
    if _DEVICE_TRACE:
        raise RuntimeError("a device trace is already running")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    _DEVICE_TRACE.update(prof=prof, log_dir=log_dir)
    return True


def stop_device_trace() -> str | None:
    """End the device trace ``start_device_trace`` began and write its
    Chrome trace; returns the file's path (None if none was running)."""
    if not _DEVICE_TRACE:
        return None
    prof, log_dir = _DEVICE_TRACE.pop("prof"), _DEVICE_TRACE.pop("log_dir")
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, DEVICE_TRACE_FILE)
    prof.export_chrome_trace(path)
    return path
