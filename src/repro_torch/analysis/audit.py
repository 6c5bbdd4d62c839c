"""Launch/transfer auditor for the fused feed path.

:class:`EdgeAuditor` wraps one
:class:`~repro_torch.kernels.feed_fused.FusedEdgeRunner` instance and
records every call that crosses the host/device boundary:

- each ``begin_feed`` and ``run_segment``, and each ``flush_pane`` /
  ``host_sync`` / ``refresh_membership`` — the device→host sync points —
  tagged with where in the feed they happened;
- around each, the kernel wrappers it called (``ring_rows``,
  ``tracker_update``, ``route_scan``, ``fifo_workers``, ``pane_update``,
  ``pane_from_entries``, ``store_probe_grouped``), and the deltas of
  ``kernels.feed_fused.LAUNCHES`` and ``kernels.store_probe.LAUNCHES``:
  the launches those calls made on the card.

The port has no jit, so the reference's retrace budget becomes a
**launch budget** (DESIGN.md §11,
:data:`~repro_torch.analysis.contracts.SEGMENT_KERNELS`):

- a segment calls each of its scheme's segment kernels exactly once,
  ``pane_update`` once plus once per pane-table growth, and nothing else;
- a pane flush calls ``store_probe`` at most once (one grouped probe per
  pane sync) and no segment kernel;
- ``begin_feed``, ``host_sync`` and ``refresh_membership`` launch nothing;
- on the card every call launched its kernel (``LAUNCHES`` deltas equal
  the calls); on the CPU the plain versions ran and nothing counts a
  launch.

The **sync budget** is the reference's: device→host transfers happen only
at pane-stride boundaries, at declared events, or at close
(:data:`~repro_torch.analysis.contracts.HOST_SYNC_POINTS`).

Use as a context manager::

    runner = ...  # EdgeState.device after a fused open/feed
    with EdgeAuditor(runner, pane_stride=pane) as aud:
        session.feed(batch)
        ...
    aud.assert_launch_budget()
    aud.assert_sync_budget(closed=True)
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

from . import contracts

__all__ = ["AuditEvent", "EdgeAuditor", "LaunchBudget", "KERNEL_WRAPPERS"]

#: (module, wrapper) → the ``LAUNCHES`` name of the kernel it launches.
#: ``pane_from_entries`` is the pane table's growth (``pane_grow``).
KERNEL_WRAPPERS: Dict[tuple, str] = {
    ("feed_fused", "ring_rows"): "ring_rows",
    ("feed_fused", "tracker_update"): "tracker_segment",
    ("feed_fused", "route_scan"): "route_scan",
    ("feed_fused", "fifo_workers"): "fifo_workers",
    ("feed_fused", "pane_update"): "pane_update",
    ("feed_fused", "pane_from_entries"): "pane_update",
    ("store_probe", "store_probe_grouped"): "store_probe",
    ("store_probe", "store_probe"): "store_probe",
}


#: a segment kernel's wrapper (the tracker's is ``tracker_update``)
_WRAPPER_OF = {"ring_rows": "ring_rows", "tracker_segment": "tracker_update",
               "route_scan": "route_scan", "fifo_workers": "fifo_workers"}


def _modules():
    from ..kernels import feed_fused, store_probe

    return {"feed_fused": feed_fused, "store_probe": store_probe}


def _launches() -> Dict[str, int]:
    mods = _modules()
    return dict(mods["feed_fused"].LAUNCHES, **mods["store_probe"].LAUNCHES)


class _CallCounter:
    """Counts the kernel-wrapper calls made while installed, by wrapper
    name (the runner and the device store look the wrappers up as module
    globals at call time).  Installs nest: each restores what it found."""

    def __init__(self) -> None:
        self.calls: Dict[str, int] = {w: 0 for _, w in KERNEL_WRAPPERS}
        self._saved: List[tuple] = []

    def install(self) -> None:
        mods = _modules()
        for (mod_name, fn_name) in KERNEL_WRAPPERS:
            mod = mods[mod_name]
            real = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, real))
            setattr(mod, fn_name, self._counted(fn_name, real))

    def _counted(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)
        return call

    def uninstall(self) -> None:
        while self._saved:
            mod, fn_name, real = self._saved.pop()
            setattr(mod, fn_name, real)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@dataclasses.dataclass
class AuditEvent:
    kind: str                 # begin_feed | segment | flush_pane |
                              # host_sync | refresh_membership
    tuples: int = 0           # segment length / feed length
    offset: int = 0           # cumulative tuples fed when this happened
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    w1: int = 0               # the runner's worker lanes after the call
    context: str = "feed"     # feed | event | close (expect() tag)


class EdgeAuditor:
    """Instrument a live FusedEdgeRunner; restore on exit."""

    _METHODS = ("begin_feed", "run_segment", "flush_pane", "host_sync",
                "refresh_membership")

    def __init__(self, runner, pane_stride: Optional[int] = None,
                 offset: int = 0) -> None:
        self.runner = runner
        self.pane_stride = pane_stride
        self.events: List[AuditEvent] = []
        # tuples fed on the edge, from ``offset`` (those fed before the
        # audit started: the pane grid is the stream's)
        self._offset = offset
        self._context = "feed"
        self._orig = {}
        self._counter = _CallCounter()
        dev = getattr(runner, "device", None)
        self.on_card = getattr(dev, "type", None) == "cuda"

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "EdgeAuditor":
        r = self.runner
        for name in self._METHODS:
            self._orig[name] = getattr(r, name)
        r.begin_feed = self._begin_feed
        r.run_segment = self._run_segment
        r.flush_pane = self._flush_pane
        r.host_sync = self._host_sync
        r.refresh_membership = self._refresh_membership
        self._counter.install()
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def restore(self) -> None:
        self._counter.uninstall()
        for name, fn in self._orig.items():
            setattr(self.runner, name, fn)
        self._orig.clear()

    @contextlib.contextmanager
    def expect(self, context: str):
        """Declare a sanctioned sync context ('event' or 'close') around
        engine calls that legitimately cross the device→host boundary off
        the pane grid."""
        if context not in contracts.HOST_SYNC_POINTS:
            raise ValueError(f"unknown sync context {context!r}; one of "
                             f"{contracts.HOST_SYNC_POINTS}")
        prev, self._context = self._context, context
        try:
            yield self
        finally:
            self._context = prev

    # -- instrumented methods ----------------------------------------------

    def _call(self, kind: str, name: str, *args, tuples: int = 0):
        c0, l0 = dict(self._counter.calls), _launches()
        out = self._orig[name](*args)
        ev = AuditEvent(kind=kind, tuples=tuples, offset=self._offset,
                        calls=_delta(self._counter.calls, c0),
                        launches=_delta(_launches(), l0),
                        w1=getattr(self.runner, "_w1", 0),
                        context=self._context)
        self.events.append(ev)
        return out

    def _begin_feed(self, grouper, state, keys_arr, values, times, sink):
        return self._call("begin_feed", "begin_feed", grouper, state,
                          keys_arr, values, times, sink,
                          tuples=int(keys_arr.shape[0]))

    def _run_segment(self, grouper, state, lo: int, hi: int):
        out = self._call("segment", "run_segment", grouper, state, lo, hi,
                         tuples=hi - lo)
        self._offset += hi - lo
        self.events[-1].offset = self._offset
        return out

    def _flush_pane(self, sink):
        return self._call("flush_pane", "flush_pane", sink)

    def _host_sync(self, grouper):
        return self._call("host_sync", "host_sync", grouper)

    def _refresh_membership(self, grouper, state):
        return self._call("refresh_membership", "refresh_membership",
                          grouper, state)

    # -- budget assertions -------------------------------------------------

    @property
    def dispatches(self) -> int:
        return sum(1 for e in self.events if e.kind == "segment")

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    def totals(self, field: str = "launches") -> Dict[str, int]:
        """Kernel launches (or wrapper ``calls``) summed over the audit."""
        out: Dict[str, int] = {}
        for e in self.events:
            for k, v in getattr(e, field).items():
                out[k] = out.get(k, 0) + v
        return out

    def _budget(self, e: AuditEvent) -> Optional[str]:
        scheme = self.runner.scheme
        c = e.calls
        if e.kind == "segment":
            want = {_WRAPPER_OF[k]: 1
                    for k in contracts.SEGMENT_KERNELS[scheme]}
            want["pane_update"] = 1
            grows = c.get("pane_from_entries", 0)
            if grows:
                want["pane_from_entries"] = grows
            if c != want:
                return f"wrapper calls {c} != {want}"
        elif e.kind == "flush_pane":
            extra = {k: v for k, v in c.items() if k != "store_probe_grouped"}
            if extra or c.get("store_probe_grouped", 0) > 1:
                return f"wrapper calls {c}: at most one grouped store_probe"
        elif c:
            return f"wrapper calls {c}: none allowed"
        # calls → the LAUNCHES each must (card) or must not (CPU) add
        want_l: Dict[str, int] = {}
        if self.on_card:
            for (_, fn), name in KERNEL_WRAPPERS.items():
                if c.get(fn):
                    want_l[name] = want_l.get(name, 0) + c[fn]
        if e.launches != want_l:
            return (f"launches {e.launches} != {want_l} for calls {c} "
                    f"({'card' if self.on_card else 'CPU'})")
        return None

    def assert_launch_budget(self) -> None:
        """Every audited call stayed within the launch budget (module
        docstring)."""
        bad = [f"  {e.kind} @offset={e.offset}: {why}"
               for e in self.events for why in [self._budget(e)] if why]
        if bad:
            raise AssertionError("launch budget exceeded:\n"
                                 + "\n".join(bad))

    def assert_sync_budget(self, closed: bool = False) -> None:
        """Every flush_pane/host_sync sits on a sanctioned sync point:
        a pane-stride boundary, a declared expect('event') /
        expect('close') context, or — when ``closed`` — the trailing
        close-time flush+sync pair."""
        syncs = [e for e in self.events
                 if e.kind in ("flush_pane", "host_sync")]
        tail: List[AuditEvent] = []
        if closed:
            while syncs and syncs[-1].offset == self._offset:
                tail.append(syncs.pop())
                if len(tail) == 2:
                    break
        bad = []
        for e in syncs:
            if e.context in ("event", "close"):
                continue
            if (self.pane_stride
                    and e.offset % self.pane_stride == 0):
                continue
            bad.append(e)
        if bad:
            raise AssertionError(
                "device→host sync off the sanctioned points "
                f"({', '.join(contracts.HOST_SYNC_POINTS)}): "
                + "; ".join(f"{e.kind} @offset={e.offset} "
                            f"context={e.context}" for e in bad))


class LaunchBudget:
    """Assert the kernel work inside the block stays within ``budget``::

        with LaunchBudget(4, what="one PKG segment"):
            ...

    Counts the kernel-wrapper calls (every call on the CPU, where the
    plain versions run) and the ``LAUNCHES`` deltas (the card), and
    holds the larger of the two to the budget.
    """

    def __init__(self, budget: int, what: str = "block") -> None:
        self.budget = budget
        self.what = what
        self.launches = 0
        self.calls = 0
        self._counter = _CallCounter()

    def __enter__(self) -> "LaunchBudget":
        self._l0 = _launches()
        self._counter.install()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._counter.uninstall()
        self.launches = sum(_launches().values()) - sum(self._l0.values())
        self.calls = sum(self._counter.calls.values())
        n = max(self.launches, self.calls)
        if exc_type is None and n > self.budget:
            raise AssertionError(
                f"{self.what}: {n} launches > budget {self.budget}")
