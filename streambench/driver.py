"""The timed path: the configuration's stream, fed to the port in cycles.

One cycle is one pass of the whole stream through a fresh session:
``SimulatorEngine(mode="fused").open(topology, arrival_rate=...)``, one
``SimulatorSession.feed`` per feed of the traffic's size, then
``close()``.  Cycles repeat until the window's seconds have passed; the
window always ends with a close, so every run does whole cycles and pays
every close it starts.  A closed loop hands in the next feed when the last
has returned; an open loop hands in feed ``k`` when its last tuple is
created at the traffic's fixed ``rate`` (at once if the driver is late).

The driver keeps, for the feeds the check samples, what the timed path
produced: each segment's workers and finish times (the runner's
``fifo_workers`` is wrapped while a sampled feed runs) and the session's
state before and after the feed, read between feeds.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional

import numpy as np

__all__ = ["Capture", "SamplePlan", "Deployment", "run_window"]

CLOCK = time.perf_counter


class Capture:
    """Wraps ``feed_fused.fifo_workers`` (looked up by the runner at each
    segment): while :attr:`armed`, keeps each segment's ``(workers,
    finish)`` outputs.  :meth:`remove` puts the original back."""

    def __init__(self, ff):
        self._ff = ff
        self._real = real = ff.fifo_workers
        self.armed = False
        self.segments: List[tuple] = []

        def fifo_workers(scheme, m, **kw):
            workers, fin = real(scheme, m, **kw)
            if self.armed:
                self.segments.append((workers[:m], fin[:m]))
            return workers, fin

        ff.fifo_workers = fifo_workers

    def take(self):
        """The kept segments' workers and finish times as host arrays."""
        segs, self.segments = self.segments, []
        if not segs:
            return np.empty(0, np.int64), np.empty(0)
        return (np.concatenate([w.cpu().numpy().astype(np.int64)
                                for w, _ in segs]),
                np.concatenate([f.cpu().numpy() for _, f in segs]))

    def remove(self) -> None:
        self._ff.fifo_workers = self._real


class SamplePlan:
    """Which feeds the check compares: the first and the last feed of the
    first cycle, and the first feed to start after each of ``count``
    instants drawn from the seed over the window's seconds."""

    def __init__(self, seed_seq, seconds: float, count: int,
                 feeds_per_cycle: int):
        rng = np.random.default_rng(seed_seq)
        self.marks = sorted((rng.random(count) * seconds).tolist())
        self.last = feeds_per_cycle - 1

    def want(self, cycle: int, k: int, elapsed: float) -> bool:
        hit = False
        while self.marks and self.marks[0] <= elapsed:
            self.marks.pop(0)
            hit = True
        return hit or (cycle == 0 and k in (0, self.last))


class Deployment:
    """The configuration as the port runs it: topology, engine, the
    stream's feeds.  ``device`` is the port's device (``"cuda"``;
    ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, config: dict, traffic: dict, stream, device):
        import repro_torch.topology as T

        self.config, self.traffic, self.stream = config, traffic, stream
        self.device = device
        self.scheme = traffic["scheme"]
        win = config["window"]
        op = T.WindowOp(agg=win["agg"], value=win["value"],
                        size=int(win["size"]), backend=win["backend"])
        grouping = dict(config["groupings"][self.scheme])
        self.topology = T.Topology(
            name=config["name"],
            stages=(T.Stage("agg", int(config["workers"]), operator=op),),
            edges=(T.Edge("source", "agg",
                          T.config_for(self.scheme, **grouping)),))
        self.edge = self.topology.edges[0].name
        self.rate = float(config["stream"]["arrival_rate"])
        self.engine = T.SimulatorEngine(device=device, **config["engine"])
        size = int(traffic["feed"])
        self.bounds = [(lo, min(lo + size, len(stream)))
                       for lo in range(0, len(stream), size)]
        self.batches = [T.RecordBatch(stream.keys[lo:hi], stream.times[lo:hi],
                                      stream.values[lo:hi])
                        for lo, hi in self.bounds]

    def open(self, telemetry=None):
        return self.engine.open(self.topology, arrival_rate=self.rate,
                                telemetry=telemetry)

    def snapshot(self, sess, repl: bool = False) -> Optional[dict]:
        """The edge's state between feeds (None before its first feed),
        as host arrays, per-key rows over the configuration's keys."""
        st = sess._st.get(self.edge)
        if st is None:
            return None
        g, es = st.grouper, st.state
        out = dict(offset=int(es.offset), busy=es.busy_until.copy(),
                   counts=g.assigned_counts.copy())
        run = es.device
        keys = int(self.config["stream"]["keys"])

        def rows(t):  # the runner's dense per-key rows, phantom row dropped
            a = t.cpu().numpy()[:run._kcap]
            full = np.zeros((keys,) + a.shape[1:], a.dtype)
            full[:min(keys, a.shape[0])] = a[:keys]
            return full

        if self.scheme == "fish":
            est = g.estimator
            out.update(trk=rows(run.trk),
                       carry=run.trk_carry.cpu().numpy().copy(),
                       mk=rows(run.m_k).astype(np.int64),
                       bl=est.backlog.astype(np.float32),
                       asn=est.assigned.astype(np.float32),
                       t_prior=float(est._t_prior),
                       ecap=est.capacities.copy())
        if repl:
            out["repl"] = rows(run.repl)[:, :int(self.config["workers"])]
        return out


def run_window(dep: Deployment, seconds: float, plan: SamplePlan,
               capture: Capture, sync: Callable[[], None],
               telemetry=None, mark: Callable = None,
               counter: Callable[[], int] = lambda: 0) -> dict:
    """Feed whole cycles until ``seconds`` have passed.  Returns the
    window's record: per feed its cycle, index, due / start / end instants
    (``CLOCK`` seconds, relative to the window's start), the tuples fed,
    the window's length, the instant each cycle's close returned, the
    sampled feeds and the first cycle's report.
    ``counter`` reads a launch counter before and after each sampled
    feed (the traced run finds the feed's launches by it)."""
    open_loop = dep.traffic["loop"] == "open"
    rate = float(dep.traffic.get("rate", 0.0))
    mark = mark or (lambda name: contextlib.nullcontext())
    feeds, samples, cycle_ends = [], [], []
    report0 = partials0 = None
    tuples = cycle = 0
    t0 = CLOCK()
    while True:
        with mark("session.open"):
            sess = dep.open(telemetry)
        for k, batch in enumerate(dep.batches):
            lo, hi = dep.bounds[k]
            due = (tuples + hi - lo) / rate if open_loop else None
            now = CLOCK() - t0
            if open_loop and now < due:
                with mark("driver.wait"):
                    time.sleep(due - now)
            sample = plan.want(cycle, k, CLOCK() - t0)
            # the first cycle's last feed also keeps the replicas before
            # it: the close report's memory overhead is checked from them
            last = sample and cycle == 0 and k == plan.last
            pre = dep.snapshot(sess, repl=last) if sample else None
            capture.armed = sample
            c0 = counter()
            start = CLOCK()
            with mark("session.feed"):
                receipt = sess.feed(batch)
                sync()
            end = CLOCK()
            capture.armed = False
            tuples += hi - lo
            feeds.append((cycle, k, due, start - t0, end - t0))
            if sample:
                workers, fin = capture.take()
                samples.append(dict(
                    cycle=cycle, k=k, pre=pre, workers=workers, finish=fin,
                    post=dep.snapshot(sess), last=last,
                    latency_p99=float(receipt.latency_p99),
                    launches=(c0, counter())))
        with mark("session.close"):
            report = sess.close()
            sync()
        if cycle == 0:
            report0 = report
            st = sess._st[dep.edge]
            partials0 = st.mgr.partials
        cycle += 1
        cycle_ends.append(CLOCK() - t0)
        if cycle_ends[-1] >= seconds:
            break
    return dict(feeds=feeds, tuples=tuples, window_s=cycle_ends[-1],
                cycles=cycle, cycle_ends=cycle_ends, samples=samples,
                report0=report0, partials0=partials0)
