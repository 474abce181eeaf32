"""Telemetry of the port: the metrics registry (counters, gauges,
log-bucketed histograms) and the host span tracer.  Copies of
``paddle_tpu/telemetry/`` with the span annotation moved to
``torch.profiler.record_function``; the serving engine's counters and
SLO histograms live here."""
from __future__ import annotations

from . import metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, CounterSet, Gauge, Histogram, Registry, registry,
)
from .trace import (  # noqa: F401
    Span, Tracer, active, disable, enable, export_chrome_trace, span,
    summarize, traced,
)

__all__ = [
    "metrics", "trace",
    "Counter", "CounterSet", "Gauge", "Histogram", "Registry", "registry",
    "Span", "Tracer", "active", "disable", "enable", "export_chrome_trace",
    "span", "summarize", "traced",
]
