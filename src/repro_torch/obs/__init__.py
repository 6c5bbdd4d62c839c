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

Chrome-trace export and the summarizing CLI are not ported yet.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .telemetry import Telemetry, disable, enable, get_telemetry, is_enabled
from .timeline import (NULL_TIMELINE, NullTimeline, TelemetryContext,
                       Timeline)
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "NullTracer", "Span", "NULL_TRACER", "NULL_SPAN",
    "Timeline", "NullTimeline", "TelemetryContext", "NULL_TIMELINE",
    "Telemetry", "enable", "disable", "get_telemetry", "is_enabled",
]
