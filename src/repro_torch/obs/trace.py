"""Span tracer: wall-clock intervals + instant events, Perfetto-shaped.

Spans are recorded against a monotonic clock (``time.perf_counter`` by
default) anchored to one wall-clock instant at tracer construction, so
span timestamps are drift-free within a run and still carry an absolute
start.  Both clocks are injected (:data:`MONOTONIC_CLOCK`,
:data:`WALL_CLOCK`): this module and :mod:`.timeline` are the only places
that stamp wall time, and a test can pass a fake clock to make traces
reproducible.  The disabled path is a pair of
shared singletons (:data:`NULL_TRACER` handing out :data:`NULL_SPAN`):
no allocation, no clock read, no list append — the overhead contract in
DESIGN.md §14.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
           "MONOTONIC_CLOCK", "WALL_CLOCK"]

#: The stamp sources: monotonic seconds for intervals, epoch seconds for
#: the trace's absolute start.
MONOTONIC_CLOCK = time.perf_counter
WALL_CLOCK = time.time


class Span:
    """One traced interval.  Used as a context manager; ``set(**kw)``
    attaches args visible in the Perfetto detail pane."""

    __slots__ = ("name", "cat", "t0", "t1", "args", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = tracer.clock()
        self.t1 = -1.0

    def set(self, **kw) -> "Span":
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)
        return self

    def done(self) -> None:
        if self.t1 < 0.0:
            self.t1 = self._tracer.clock()
            self._tracer.spans.append(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.done()
        return False


class Tracer:
    """Collects :class:`Span`s and instant events in memory."""

    def __init__(self, clock=MONOTONIC_CLOCK, wall_clock=WALL_CLOCK) -> None:
        self.clock = clock
        self.t0 = clock()
        self.wall0 = wall_clock()
        self.spans: List[Span] = []
        self.instants: List[tuple] = []  # (t, name, cat, args)

    @property
    def enabled(self) -> bool:
        return True

    def span(self, name: str, cat: str = "run", **args) -> Span:
        return Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "run", **args) -> None:
        self.instants.append((self.clock(), name, cat, args or None))

    def rel_us(self, t: float) -> float:
        """Monotonic instant → microseconds since trace start."""
        return (t - self.t0) * 1e6


class NullTracer:
    """Disabled tracer: every call is a constant-return no-op."""

    __slots__ = ()
    spans: List = []      # shared, always empty: never appended to
    instants: List = []
    t0 = 0.0
    wall0 = 0.0

    @property
    def enabled(self) -> bool:
        return False

    def span(self, name: str, cat: str = "run", **args) -> "_NullSpan":
        return NULL_SPAN

    def instant(self, name: str, cat: str = "run", **args) -> None:
        return None

    def rel_us(self, t: float) -> float:
        return 0.0


class _NullSpan:
    """Shared no-op span — ``span()`` on the null tracer allocates nothing."""

    __slots__ = ()

    def set(self, **kw) -> "_NullSpan":
        return self

    def done(self) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()
NULL_TRACER = NullTracer()
