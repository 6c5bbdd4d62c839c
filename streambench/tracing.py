"""The traced run: the port's own spans and counters, and the device
timeline from ``torch.profiler``, over the same window.

The window's sessions are opened with an enabled telemetry bundle of the
port (its tracer's spans ``session.feed``, ``fused.*``).  Around the calls
into each layer the benchmark adds profiler ranges of its own (the
driver's ``session.open`` / ``session.feed`` / ``session.close`` /
``driver.wait``, and the runner's and state store's entry points wrapped
here), so that every idle gap of the device can be put down to what the
host was doing.  The profiler keeps its events in memory and writes no
trace file.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

__all__ = ["Tracing", "busy_seconds", "idle_pct", "breakdown"]

#: the port's entry points wrapped in a profiler range (module, class,
#: method, range name)
_LAYERS = (
    ("repro_torch.kernels.feed_fused", "FusedEdgeRunner", "begin_feed",
     "runner.begin_feed"),
    ("repro_torch.kernels.feed_fused", "FusedEdgeRunner", "run_segment",
     "runner.segment"),
    ("repro_torch.kernels.feed_fused", "FusedEdgeRunner", "flush_pane",
     "runner.pane_flush"),
    ("repro_torch.kernels.feed_fused", "FusedEdgeRunner", "host_sync",
     "runner.host_sync"),
    ("repro_torch.state.window", "KeyedStateManager", "feed_aggregated",
     "state.feed_aggregated"),
    ("repro_torch.state.store", "DeviceStateStore", "merge_many",
     "state.merge_many"),
)


#: the benchmark's own profiler ranges: the driver's and the wrappers'
RANGES = frozenset(["session.open", "session.feed", "session.close",
                    "driver.wait"] + [layer[3] for layer in _LAYERS])
def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()
                                              * 1000)


class Tracing:
    """Profiler, telemetry and range wrappers for one traced window."""

    def __init__(self, torch):
        import importlib

        from repro_torch.obs import Telemetry

        self.torch = torch
        self.telemetry = Telemetry(enabled=True, label="streambench")
        self._undo = []
        rf = torch.profiler.record_function
        for mod, cls, meth, name in _LAYERS:
            owner = getattr(importlib.import_module(mod), cls)
            real = getattr(owner, meth)

            def wrapped(*a, _real=real, _name=name, **k):
                with rf(_name):
                    return _real(*a, **k)

            setattr(owner, meth, wrapped)
            self._undo.append((owner, meth, real))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def mark(self, name: str):
        return self.torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """Profile the block as the traced window (range ``window``)."""
        with self.prof:
            with self.mark("window"):
                yield
        for owner, meth, real in self._undo:
            setattr(owner, meth, real)

    def read(self) -> Dict:
        """The trace as plain data: spans (name, t0, t1) of the port's
        tracer in seconds; device events (name, start, end) and the
        benchmark's ranges (name, start, end) in seconds of the profiler's
        clock; the window's (start, end) there."""
        device: List[Tuple[str, float, float]] = []
        ranges: List[Tuple[str, float, float]] = []
        win = None
        for ev in self.prof.profiler.kineto_results.events():
            t0 = _ns(ev, "start") * 1e-9
            t1 = t0 + _ns(ev, "duration") * 1e-9
            name = ev.name()
            ours = name == "window" or name in RANGES
            if str(ev.device_type()).endswith("CUDA"):
                # a range's device-side shadow (gpu_user_annotation) is
                # not work
                if not ours:
                    device.append((name, t0, t1))
            elif name == "window":
                win = (t0, t1)
            elif ours:
                ranges.append((name, t0, t1))
        device.sort(key=lambda e: e[1])
        ranges.sort(key=lambda e: e[1])
        spans = [(s.name, s.t0, s.t1) for s in self.telemetry.tracer.spans]
        return dict(device=device, ranges=ranges, window=win, spans=spans)


def _busy(trace) -> List[Tuple[float, float]]:
    """The union of the device's activity intervals inside the window."""
    w0, w1 = trace["window"]
    out: List[List[float]] = []
    for _, t0, t1 in trace["device"]:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_seconds(trace) -> float:
    return sum(b - a for a, b in _busy(trace))


def idle_pct(trace) -> float:
    w0, w1 = trace["window"]
    return 100.0 * (1.0 - busy_seconds(trace) / (w1 - w0))


def _short(name: str) -> str:
    """A device operation's name without return type, namespaces,
    template and call arguments: ``route_scan_kernel``, ``Memcpy DtoH``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.rsplit("::", 1)[-1].strip() or "unnamed"


def breakdown(trace, top: int = 10) -> Dict:
    """The device operations that took most time, and the device's idle
    gaps summed by the innermost benchmark range open at each gap's
    middle (``host`` where none was)."""
    ops: Dict[str, float] = {}
    for n, t0, t1 in trace["device"]:
        short = _short(n)
        ops[short] = ops.get(short, 0.0) + (t1 - t0)
    busy = _busy(trace)
    w0, w1 = trace["window"]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    # one sweep over the ranges' starts and ends and the gaps' middles,
    # keeping the open ranges on a stack (ranges nest on one thread)
    marks = []
    for i, (n, r0, r1) in enumerate(trace["ranges"]):
        marks += [(r0, 0, i), (r1, 2, i)]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            marks.append((0.5 * (a + b), 1, b - a))
    marks.sort(key=lambda x: (x[0], x[1]))
    gaps: Dict[str, float] = {}
    open_: List[int] = []
    for _, kind, x in marks:
        if kind == 0:
            open_.append(x)
        elif kind == 2:
            if x in open_:
                open_.remove(x)
        else:
            name = trace["ranges"][open_[-1]][0] if open_ else "host"
            gaps[name] = gaps.get(name, 0.0) + x

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}
