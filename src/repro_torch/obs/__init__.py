"""Round-trace telemetry: span tracing + unified metrics registry.

The JAX package's ``obs`` over the port: the same span taxonomy, JSONL
schema, Prometheus metric names and off-by-default contract (its
``obs/README.md``), with the device hooks in torch (``trace.py``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.telemetry import (NULL_TELEMETRY, NullTelemetry,  # noqa: F401
                                       Telemetry, as_telemetry)
from repro_torch.obs.trace import (SCHEMA_VERSION, Span, Tracer,  # noqa: F401
                                   load_jsonl, start_device_trace,
                                   stop_device_trace, sync_on, validate_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TELEMETRY", "NullTelemetry", "Telemetry", "as_telemetry",
    "SCHEMA_VERSION", "Span", "Tracer", "load_jsonl",
    "start_device_trace", "stop_device_trace", "sync_on", "validate_events",
]
