"""Metric timelines: every sample carries both clock domains.

A timeline *point* is ``(wall_time, engine_clock, feed_idx, epoch_idx,
value)``:

* ``wall_time`` — seconds since trace start (host reality: what
  Perfetto plots on its x axis).  In a :class:`~.telemetry.Telemetry`
  bundle the timeline reads the tracer's clock (monotonic, on the
  profiler's Unix-epoch axis) and the bundle sets its ``t0`` to the
  tracer's, so points and spans share one axis; a standalone timeline
  counts from the ``clock()`` reading it takes when built;
* ``engine_clock`` — the engine's own notion of time: *seconds* on the
  DSPE simulator, *scheduler ticks* on the serving engine (DESIGN.md §14
  clock domains).  The two are deliberately not interconvertible;
* ``feed_idx`` — which ``session.feed`` call the sample belongs to
  (-1: outside any feed);
* ``epoch_idx`` — the FISH tracker epoch at sample time (-1: no tracker
  in scope).

Emitters that know their coordinates pass them explicitly; emitters deep
in a layer (the FISH tracker does not know which feed it is in) inherit
the session-maintained :class:`TelemetryContext`.  The disabled path is
the shared :data:`NULL_TIMELINE` singleton — ``point`` is a constant
no-op.

Export downsamples each series to ``max_points`` by stride decimation
that always keeps the first and last point (see §14: peaks inside a
dropped stride are *not* re-aggregated — the full-resolution record is
the Chrome trace, the report timeline is the overview).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .trace import MONOTONIC_CLOCK

__all__ = ["TelemetryContext", "Timeline", "NullTimeline", "NULL_TIMELINE",
           "TIMELINE_COLUMNS"]

TIMELINE_COLUMNS = ("wall_time", "engine_clock", "feed_idx", "epoch_idx",
                    "value")


class TelemetryContext:
    """Mutable current-position stamp shared by every emitter in a run.
    Sessions advance ``engine_clock``/``feed_idx`` at feed boundaries;
    the FISH epoch observer advances ``epoch_idx``."""

    __slots__ = ("engine_clock", "feed_idx", "epoch_idx")

    def __init__(self) -> None:
        self.engine_clock = 0.0
        self.feed_idx = -1
        self.epoch_idx = -1


class Timeline:
    """Named series of context-stamped samples."""

    def __init__(self, ctx: Optional[TelemetryContext] = None,
                 clock=MONOTONIC_CLOCK) -> None:
        self.ctx = ctx if ctx is not None else TelemetryContext()
        self.clock = clock
        self.t0 = clock()
        self.series: Dict[str, List[tuple]] = {}

    @property
    def enabled(self) -> bool:
        return True

    def point(self, name: str, value: float,
              engine_clock: Optional[float] = None,
              feed_idx: Optional[int] = None,
              epoch_idx: Optional[int] = None) -> None:
        """Append one sample; unspecified coordinates come off the shared
        context."""
        ctx = self.ctx
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = []
        s.append((
            self.clock() - self.t0,
            ctx.engine_clock if engine_clock is None else float(engine_clock),
            ctx.feed_idx if feed_idx is None else int(feed_idx),
            ctx.epoch_idx if epoch_idx is None else int(epoch_idx),
            float(value),
        ))

    def export(self, max_points: int = 512) -> Dict:
        """JSON-serializable dict (the report ``timeline`` section)."""
        out: Dict[str, Dict] = {}
        for name, pts in self.series.items():
            n = len(pts)
            if n > max_points:
                stride = -(-n // max_points)
                kept = pts[::stride]
                if kept[-1] is not pts[-1]:
                    kept.append(pts[-1])
            else:
                kept = list(pts)
            out[name] = {
                "n_points": n,
                "n_kept": len(kept),
                "points": [list(p) for p in kept],
            }
        return {"columns": list(TIMELINE_COLUMNS), "series": out}


class NullTimeline:
    """Disabled timeline: ``point`` is a constant no-op."""

    __slots__ = ("ctx",)
    series: Dict = {}  # shared, always empty: never written to

    def __init__(self, ctx: Optional[TelemetryContext] = None) -> None:
        self.ctx = ctx if ctx is not None else TelemetryContext()

    @property
    def enabled(self) -> bool:
        return False

    def point(self, name: str, value: float,
              engine_clock: Optional[float] = None,
              feed_idx: Optional[int] = None,
              epoch_idx: Optional[int] = None) -> None:
        return None

    def export(self, max_points: int = 512) -> Dict:
        return {"columns": list(TIMELINE_COLUMNS), "series": {}}


NULL_TIMELINE = NullTimeline()
