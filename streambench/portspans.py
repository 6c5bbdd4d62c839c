"""Sums over the port's spans in a traced run's ``ctx["trace"]["spans"]``
(``(name, t0, t1)`` on the profiler's clock), shared by the per-layer
readers.  Each returns None where the trace holds no span it reads, as
it does on a program that has none of them."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

__all__ = ["feeds", "seconds", "self_seconds", "union", "overlap"]


def feeds(spans) -> int:
    """The window's feeds: its ``session.feed`` spans."""
    return sum(1 for s in spans if s[0] == "session.feed")


def seconds(spans, names: Iterable[str]) -> Optional[float]:
    """The summed length of every span named in ``names``."""
    names = frozenset(names)
    d = [t1 - t0 for n, t0, t1 in spans if n in names]
    return sum(d) if d else None


def self_seconds(spans, parent: str, prefix: str) -> Optional[float]:
    """The summed length of the ``parent`` spans less the time their
    children named ``prefix*`` cover (nested children counted once)."""
    outer = [s for s in spans if s[0] == parent]
    if not outer:
        return None
    kids = sorted((s for s in spans if s[0].startswith(prefix)),
                  key=lambda s: s[1])
    starts = [k[1] for k in kids]
    own = 0.0
    for _, t0, t1 in outer:
        covered, hi = 0.0, t0
        for _, k0, k1 in kids[bisect.bisect_left(starts, t0):
                              bisect.bisect_right(starts, t1)]:
            k0, k1 = max(k0, hi), min(k1, t1)
            if k1 > k0:
                covered += k1 - k0
                hi = k1
        own += (t1 - t0) - covered
    return own


def union(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(a: List[Tuple[float, float]],
            b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
