"""The telemetry bundle and the process default.

A :class:`Telemetry` carries the three surfaces together:

* ``metrics`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry`.  **Always
  real**, enabled or not: the unified report counters (dispatches, shed,
  remap totals…) live here as their single source of truth, and they are
  plain int cells updated at feed/segment/event granularity — cheap enough
  to never gate.
* ``tracer`` / ``timeline`` — real collectors when enabled, shared no-op
  singletons when not.  This is the strict fast path: with telemetry
  disabled no span object is allocated, no clock is read, no sample list
  grows.

Engines resolve their telemetry as ``telemetry or get_telemetry()``:
pass one explicitly to ``Engine.open`` (or ``enable()`` the process
default) and every layer underneath — fused runner, FISH tracker,
open-loop driver, autoscaler — reports into the same bundle.  When the
process default is *disabled*, each session gets a private disabled
bundle (``for_session()``) so per-session counters never bleed across
runs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .metrics import MetricsRegistry
from .timeline import (NULL_TIMELINE, NullTimeline, TelemetryContext,
                       Timeline)
from .trace import NULL_TRACER, Tracer

__all__ = ["Telemetry", "enable", "disable", "get_telemetry", "is_enabled"]


class Telemetry:
    def __init__(self, enabled: bool = True, label: str = "") -> None:
        self.enabled = bool(enabled)
        self.label = label
        self.metrics = MetricsRegistry()
        self.ctx = TelemetryContext()
        if self.enabled:
            self.tracer = Tracer()
            self.timeline = Timeline(self.ctx, clock=self.tracer.clock)
            # one time base: span ts and timeline ts land on the same axis
            self.timeline.t0 = self.tracer.t0
        else:
            self.tracer = NULL_TRACER
            self.timeline = NullTimeline(self.ctx)
        self.meta: Dict = {"label": label}

    # -- session plumbing ---------------------------------------------------
    def for_session(self) -> "Telemetry":
        """The bundle a new session should use.  Enabled telemetry is
        shared (one trace spans the whole run, sessions and all); disabled
        telemetry hands out a private bundle so session counters don't
        accumulate into a process-lifetime registry."""
        return self if self.enabled else Telemetry(enabled=False)

    # -- export -------------------------------------------------------------
    def timeline_dict(self, max_points: int = 512) -> Optional[Dict]:
        """The report ``timeline`` section (None when disabled, so report
        dicts stay bit-identical to pre-telemetry output)."""
        if not self.enabled:
            return None
        out = self.timeline.export(max_points)
        out["metrics"] = self.metrics.snapshot()
        return out

    def chrome_trace(self) -> Dict:
        from .export import chrome_trace
        return chrome_trace(self)

    def save(self, path: str) -> str:
        """Write the Chrome trace-event JSON atomically (never leaves a
        truncated file: full write to a sibling tmp, then rename)."""
        import json

        payload = self.chrome_trace()
        tmp = f"{path}.tmp"
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
        os.replace(tmp, path)
        return path


_default = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    """The process-default bundle (disabled unless ``enable()`` was
    called)."""
    return _default


def enable(label: str = "") -> Telemetry:
    """Turn on process-wide telemetry; returns the new default bundle."""
    global _default
    _default = Telemetry(enabled=True, label=label)
    return _default


def disable() -> None:
    """Back to the no-op default."""
    global _default
    _default = Telemetry(enabled=False)


def is_enabled() -> bool:
    return _default.enabled
