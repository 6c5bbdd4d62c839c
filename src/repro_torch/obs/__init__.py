"""Telemetry spine of the port: run counters, engine-clock spans and
per-epoch metric timelines.

* :class:`MetricsRegistry` / :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` — the single source of truth for run counters
  (always on; plain int cells at feed/segment/event granularity);
* :class:`Tracer` — wall-clock spans and instants;
* :class:`Timeline` — metric series where every sample is stamped
  ``(wall_time, engine_clock, feed_idx, epoch_idx)``;
* :class:`Telemetry` — the bundle engines thread through their layers;
  :func:`enable` / :func:`disable` / :func:`get_telemetry` manage the
  process default (disabled ⇒ strict no-op tracer/timeline singletons).

* Chrome trace-event export (:func:`chrome_trace`, :class:`TraceWriter`)
  viewable in Perfetto, and a CLI (``python -m repro_torch.obs``) that
  summarizes and diffs trace files.
"""

from .export import TraceWriter, chrome_trace, validate_chrome_trace
from .metrics import (GLOBAL_METRICS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .telemetry import Telemetry, disable, enable, get_telemetry, is_enabled
from .timeline import (NULL_TIMELINE, NullTimeline, TelemetryContext,
                       Timeline)
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "GLOBAL_METRICS",
    "Tracer", "NullTracer", "Span", "NULL_TRACER", "NULL_SPAN",
    "Timeline", "NullTimeline", "TelemetryContext", "NULL_TIMELINE",
    "Telemetry", "enable", "disable", "get_telemetry", "is_enabled",
    "chrome_trace", "validate_chrome_trace", "TraceWriter",
]
