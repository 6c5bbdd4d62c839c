"""Instruments + registry: the single source of truth for run counters.

Three instrument kinds, all plain-Python cells (zero dependencies, zero
per-tuple work — instrumented code updates them at feed/segment/event
granularity only):

* :class:`Counter` — cumulative count.  Mutate via ``add``/``set``; *read*
  via ``.value``.  Report fields such as ``FusedEdgeRunner.dispatches``
  are properties over a ``Counter``, so the registry and the report can
  never disagree.
* :class:`Gauge` — last-value (``set``) or running-peak (``peak``) sample.
* :class:`Histogram` — raw observations with summary percentiles.

A :class:`MetricsRegistry` is an *enumeration surface*, not a lookup table:
``registry.counter(name)`` always mints a fresh instrument and remembers
it, so two runners on two edges can both own a ``fused.dispatches``
without clobbering each other; ``snapshot()`` aggregates by name (counters
sum, gauges keep the max of peaks / last of lasts, histograms merge).
Holding the instrument you minted is the fast path — reads and writes
never hash a name after creation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "GLOBAL_METRICS"]


class Counter:
    """A cumulative counter cell.  ``value`` is the current total."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = labels or {}
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        """Overwrite the total (session-scoped resets)."""
        self.value = v

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-value / running-peak sample cell."""

    __slots__ = ("name", "labels", "value", "_peak_mode")
    kind = "gauge"

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = labels or {}
        self.value = 0
        self._peak_mode = False

    def set(self, v) -> None:
        self.value = v

    def peak(self, v) -> None:
        """Keep the running max (queue-depth / in-flight peaks)."""
        self._peak_mode = True
        if v > self.value:
            self.value = v

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Raw-observation histogram; summarised (not bucketed) on export."""

    __slots__ = ("name", "labels", "values")
    kind = "histogram"

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = labels or {}
        self.values: List[float] = []

    def record(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict:
        vs = sorted(self.values)
        n = len(vs)
        if not n:
            return {"count": 0}
        return {
            "count": n,
            "min": vs[0],
            "max": vs[-1],
            "mean": sum(vs) / n,
            "p50": vs[n // 2],
            "p99": vs[min(n - 1, (99 * n) // 100)],
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Histogram({self.name}, n={len(self.values)})"


class MetricsRegistry:
    """Mints and enumerates instruments.  Aggregation happens only at
    ``snapshot()`` time — the hot path touches instrument cells directly."""

    def __init__(self) -> None:
        self._instruments: List = []

    def counter(self, name: str, **labels) -> Counter:
        c = Counter(name, labels)
        self._instruments.append(c)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        g = Gauge(name, labels)
        self._instruments.append(g)
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        h = Histogram(name, labels)
        self._instruments.append(h)
        return h

    def adopt(self, instrument) -> None:
        """Register an instrument minted elsewhere so it shows up in
        snapshots."""
        self._instruments.append(instrument)

    def __iter__(self):
        return iter(self._instruments)

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> Dict[str, Dict]:
        """Aggregate by name: counters sum, peak gauges max / plain gauges
        last-write-wins, histograms merge their observations."""
        out: Dict[str, Dict] = {}
        merged_hists: Dict[str, Histogram] = {}
        for inst in self._instruments:
            if inst.kind == "histogram":
                m = merged_hists.get(inst.name)
                if m is None:
                    m = merged_hists[inst.name] = Histogram(inst.name)
                m.values.extend(inst.values)
                continue
            cur = out.get(inst.name)
            if cur is None:
                out[inst.name] = {"kind": inst.kind, "value": inst.value,
                                  "instruments": 1}
            elif inst.kind == "counter":
                cur["value"] += inst.value
                cur["instruments"] += 1
            else:  # gauge
                if inst._peak_mode:
                    cur["value"] = max(cur["value"], inst.value)
                else:
                    cur["value"] = inst.value
                cur["instruments"] += 1
        for name, h in merged_hists.items():
            out[name] = {"kind": "histogram", **h.summary()}
        return out


#: Process-wide registry for instruments that outlive any one session.
GLOBAL_METRICS = MetricsRegistry()
