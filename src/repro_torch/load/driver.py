"""Open-loop driver: feed sessions at the arrival schedule.

The driver closes the loop between the other three layers: per arrival
tick it (1) offers the tick's arrivals to the bounded
:class:`~repro_torch.load.admission.IngressQueue`, (2) drains the queue into
``session.feed`` **unless** the engine's backlog exceeds the backpressure
threshold (that is what makes the queue fill and the admission policy
engage under overload), and (3) hands the returned
:class:`~repro_torch.topology.engine.FeedReceipt` to the optional
:class:`~repro_torch.load.autoscale.P99Autoscaler`, registering whatever
membership events it emits.

Queueing delay is billed honestly: a record popped at tick end ``t_feed``
is fed with timestamp ``t_feed`` (keeping the session's nondecreasing-
timestamp contract), and its ``t_feed - arrival`` is recorded as
time-in-queue — so *total* latency = time-in-queue + the engine's service
latency, and the two components never double count.  The close-time
:class:`~repro_torch.topology.engine.TopologyReport` is stamped with the
admission accounting (``offered == fed + shed + residual``), the driver's
queue-delay stats and the autoscaler's action log.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..obs.telemetry import Telemetry
from ..topology.engine import TopologyReport
from ..topology.graph import RecordBatch
from .admission import IngressQueue
from .arrivals import ArrivalProcess
from .autoscale import P99Autoscaler

__all__ = ["OpenLoopDriver", "LoadReport"]


@dataclasses.dataclass
class LoadReport:
    """One open-loop run: the stamped close-time topology report plus the
    driver-side latency decomposition.  ``total_latency_*`` (queue delay +
    service latency, per fed tuple) is exact on the DSPE simulator, whose
    receipts return per-tuple service latencies aligned with the feed;
    the serving engine's receipts report finished-request latencies
    (unaligned under open loop), so totals are ``None`` there — read the
    queue-delay stats and the report's e2e columns separately."""

    topology: TopologyReport
    offered: int
    fed: int
    #: total loss = ``shed_ingress`` (bounded ingress queue, never fed) +
    #: ``shed_engine`` (the serving engine's bounded replica queues).  The
    #: two-level identity: ``offered == fed + shed_ingress + residual`` and,
    #: once drained, every fed record is either finished or shed_engine.
    shed: int
    shed_ingress: int
    shed_engine: int
    deferred: int
    residual: int
    queue_depth_peak: int
    queue_delay_avg: float
    queue_delay_p99: float
    total_latency_avg: Optional[float]
    total_latency_p99: Optional[float]
    autoscale_events: List[Dict] = dataclasses.field(default_factory=list)
    # telemetry: the driver-side metric timeline (queue depth, shed,
    # backpressure engagements) + metrics snapshot — ``None`` (and omitted
    # from ``to_dict``) whenever telemetry is disabled
    timeline: Optional[Dict] = None

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["topology"] = self.topology.to_dict()
        if d.get("timeline") is None:
            d.pop("timeline", None)
        return d


class OpenLoopDriver:
    """Drive one session at an arrival schedule.

    backpressure: engine-backlog threshold (seconds for the simulator,
                  queued requests for the serving engine — the unit of
                  ``FeedReceipt.backlog``) above which the driver stops
                  draining the ingress queue.  ``None`` never pushes back
                  (the queue only fills if ``feed_chunk`` caps drainage).
    backlog_decay: how fast the last receipt's backlog drains per driver
                  second while the driver is *not* feeding (the engine
                  keeps working).  The default 1.0 is exact for the
                  simulator (backlog is seconds and melts one second per
                  second); for the serving engine pass the pool's
                  aggregate service rate in requests/s.  Without decay a
                  stale over-threshold receipt would gate feeding forever.
    feed_chunk:   max records per feed call (``None``: drain everything
                  admitted each tick).
    """

    def __init__(self, session, queue: IngressQueue,
                 backpressure: Optional[float] = None,
                 backlog_decay: float = 1.0,
                 feed_chunk: Optional[int] = None,
                 autoscaler: Optional[P99Autoscaler] = None):
        self.session = session
        self.queue = queue
        self.backpressure = backpressure
        self.backlog_decay = backlog_decay
        self.feed_chunk = feed_chunk
        self.autoscaler = autoscaler
        self._queue_delays: List[np.ndarray] = []
        self._totals: List[np.ndarray] = []
        self._aligned = True
        self._receipt = None
        self._t_last_feed = 0.0
        # share the session's bundle so driver points land on the
        # same trace as the engine's spans (private no-op bundle otherwise)
        tel = getattr(session, "telemetry", None)
        self.tel = tel if tel is not None else Telemetry(enabled=False)
        self._c_bp = self.tel.metrics.counter("load.backpressure_engaged")
        if self.autoscaler is not None and not self.autoscaler.tel.enabled:
            # an autoscaler built without an explicit bundle reports into
            # the session's (same cell, adopted into the session registry)
            self.autoscaler.tel = self.tel
            self.tel.metrics.adopt(self.autoscaler._c_actions)

    # -- one run ---------------------------------------------------------------
    def run(self, arrivals: ArrivalProcess, t0: float, t1: float,
            drain: bool = False) -> LoadReport:
        """Offer arrivals on ``[t0, t1)`` tick by tick, then close.  With
        ``drain=True`` the driver keeps ticking past ``t1`` (no new
        arrivals) until the ingress queue empties — otherwise leftover
        records are reported as ``residual``, never silently dropped."""
        t_feed = t0
        for batch in arrivals.batches(t0, t1):
            t_feed += arrivals.tick
            self.queue.offer(batch.keys, batch.timestamps, batch.values)
            self._step(t_feed)
        if drain:
            while len(self.queue):
                t_feed += arrivals.tick
                self._step(t_feed, force=True)
        return self._close()

    def _step(self, t_feed: float, force: bool = False) -> None:
        """Drain the ingress queue into one feed, unless backpressure.
        The backlog read off the last receipt decays at ``backlog_decay``
        per second of driver time since that feed — the engine does not
        stop working just because the driver stopped feeding.  ``force``
        (the post-arrival drain phase) skips the gate entirely: the run is
        over and the residual is pushed through for accounting."""
        if (not force and self.backpressure is not None
                and self._receipt is not None):
            backlog = (self._receipt.backlog - self.backlog_decay
                       * (t_feed - self._t_last_feed))
            if backlog > self.backpressure:
                # backpressure engaged: the queue keeps filling this tick
                self._c_bp.add(1)
                self.tel.tracer.instant("load.backpressure", cat="load",
                                        backlog=float(backlog),
                                        queued=len(self.queue))
                self.tel.timeline.point("load.queue_depth", len(self.queue),
                                        engine_clock=t_feed)
                return
        chunk = self.feed_chunk or len(self.queue)
        keys, arrivals, values = self.queue.pop(chunk)
        n = keys.shape[0]
        if n == 0:
            return
        ts = np.full(n, t_feed)
        receipt = self.session.feed(RecordBatch(keys, ts, values))
        tl = self.tel.timeline
        tl.point("load.queue_depth", len(self.queue), engine_clock=t_feed)
        tl.point("load.shed_total", self.queue.stats.shed,
                 engine_clock=t_feed)
        self._receipt = receipt
        self._t_last_feed = t_feed
        qd = t_feed - arrivals
        self._queue_delays.append(qd)
        lats = receipt.latencies if receipt is not None else None
        if lats is not None and lats.shape == qd.shape:
            self._totals.append(qd + lats)
        else:  # serving open loop: receipts carry finish-order latencies
            self._aligned = False
        if self.autoscaler is not None and receipt is not None:
            events = self.autoscaler.observe(t_feed, receipt)
            if events:
                self.session.advance(events)

    def _close(self) -> LoadReport:
        run_span = self.tel.tracer.span("load.close", cat="load")
        report = self.session.close()
        run_span.done()
        stats = self.queue.stats
        qd = (np.concatenate(self._queue_delays) if self._queue_delays
              else np.empty(0))
        totals = (np.concatenate(self._totals)
                  if self._aligned and self._totals else None)
        # stamp the open-loop accounting onto the shared report schema
        report.offered = stats.offered
        report.shed += stats.shed  # engine-side shed already aggregated
        report.deferred = stats.deferred
        report.residual = self.queue.residual
        report.queue_depth_peak = max(report.queue_depth_peak,
                                      stats.queue_depth_peak)
        report.time_in_queue_avg = float(qd.mean()) if qd.size else 0.0
        report.time_in_queue_p99 = (float(np.percentile(qd, 99))
                                    if qd.size else 0.0)
        if self.autoscaler is not None:
            report.autoscale_events = list(self.autoscaler.events)
        return LoadReport(
            topology=report,
            offered=stats.offered, fed=stats.fed, shed=report.shed,
            shed_ingress=stats.shed, shed_engine=report.shed - stats.shed,
            deferred=stats.deferred, residual=self.queue.residual,
            queue_depth_peak=report.queue_depth_peak,
            queue_delay_avg=report.time_in_queue_avg,
            queue_delay_p99=report.time_in_queue_p99,
            total_latency_avg=(float(totals.mean())
                               if totals is not None and totals.size
                               else None),
            total_latency_p99=(float(np.percentile(totals, 99))
                               if totals is not None and totals.size
                               else None),
            autoscale_events=report.autoscale_events,
            timeline=self.tel.timeline_dict(),
        )
