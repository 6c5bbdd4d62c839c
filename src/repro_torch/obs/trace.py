"""Span tracer: wall-clock intervals + instant events, Perfetto-shaped.

Spans are stamped in seconds on the Unix-epoch axis, the axis on which
``torch.profiler`` (kineto) stamps its host ranges and device events, so
the port's spans can be laid over a profiler trace of the same run and a
device idle gap put down to the span open at the time.  The default
clock (:func:`epoch_clock`) stays monotonic and drift-free within a run:
``time.perf_counter`` plus one offset to ``time.time``, read once when
each :class:`Tracer` is built.  Both clocks are injected (the interval
clock and :data:`WALL_CLOCK` for the trace's absolute start): this
module and :mod:`.timeline` are the only places that stamp wall time,
and a test can pass a fake clock to make traces reproducible.  The
disabled path is a pair of shared singletons (:data:`NULL_TRACER`
handing out :data:`NULL_SPAN`): no allocation, no clock read, no list
append — the overhead contract in DESIGN.md §14.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
           "MONOTONIC_CLOCK", "WALL_CLOCK", "epoch_clock"]

#: The stamp sources: monotonic seconds for intervals, epoch seconds for
#: the trace's absolute start.
MONOTONIC_CLOCK = time.perf_counter
WALL_CLOCK = time.time


def epoch_clock():
    """A monotonic clock in Unix-epoch seconds: ``perf_counter()`` plus
    the offset ``time() - perf_counter()`` read once, here.  Instants
    land within a millisecond of the profiler's epoch stamps.  A float64
    near 1.8e9 s resolves about 0.24 us, so a stamp (and a span's
    length) is rounded to that, coarser than ``perf_counter`` alone."""
    mono = MONOTONIC_CLOCK
    offset = WALL_CLOCK() - mono()
    return lambda: mono() + offset


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
    """Collects :class:`Span`s and instant events in memory.  ``clock``
    defaults to a fresh :func:`epoch_clock`."""

    def __init__(self, clock=None, wall_clock=WALL_CLOCK) -> None:
        if clock is None:
            clock = epoch_clock()
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
        """Clock instant → microseconds since trace start."""
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
