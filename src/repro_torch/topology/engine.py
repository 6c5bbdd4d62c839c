"""Topology engines — one protocol, executed through incremental
streaming sessions.

:class:`Engine` is the protocol: ``open(topology) -> Session`` for
incremental record-batch execution, with ``run(topology, source, events) ->
TopologyReport`` kept as the one-shot convenience (open / advance / feed
every batch / close — feeding the whole stream as one batch is
bit-identical to ``run``).  A :class:`Session` carries per-edge state
across feeds: per-worker FIFO backlog (:class:`~repro_torch.core.EdgeState`),
grouper epoch state, remap accountants and keyed-state managers all
survive between ``feed`` calls, so hot-key flips can straddle feed
boundaries exactly like they do in a long-running DSPE.  Events registered
via ``advance`` may address the stream by tuple index or by timestamp
(``at_time``) and fire when the addressed tuple is fed.

:class:`SimulatorEngine` is the DSPE discrete-event simulator.  Each
grouped edge runs through :func:`repro_torch.core.stream.simulate_edge`
(``mode="batched"``: segment-wise closed-form FIFO; ``mode="reference"``:
the per-tuple oracle interpreter; ``mode="fused"``: the device segment
kernels), and the *finish* times of one stage become the arrival times of
the next — per-stage FIFO queues chained through the DAG.  Time is in
seconds.  It returns a :class:`TopologyReport`: per-edge latency
percentiles, imbalance, memory overhead and remap accounting (one
:class:`EdgeReport` per edge) plus end-to-end source→sink latencies.

:class:`ServingTopologyEngine` is the continuous-batching
:class:`~repro_torch.serving.engine.ServingEngine` adapter: every edge is a
replica pool with slot-limited decode, each tuple a 1-token request keyed
by its (session) key.  Time is in scheduler ticks.  The source stream is
subsampled to ``max_requests`` (per-tick scheduling is Python-loop work).
It is a host engine and returns the same :class:`TopologyReport`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.stream import (CapacityEvent, MembershipEvent, edge_metrics,
                           simulate_edge)
from ..obs.telemetry import get_telemetry
from ..obs.trace import NULL_TRACER
from ..state.migration import MigrationBiller
from ..state.window import KeyedStateManager, StateReport
from .configs import build_grouper
from .graph import (SOURCE, Edge, RecordBatch, ScopedEvent, Source, Stage,
                    Topology)

__all__ = [
    "EdgeReport",
    "FeedReceipt",
    "TopologyReport",
    "Engine",
    "Session",
    "RemapAccountant",
    "SimulatorEngine",
    "SimulatorSession",
    "ServingTopologyEngine",
    "ServingSession",
]


# ---------------------------------------------------------------------------
# unified reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdgeReport:
    """One grouped edge's metrics — the same schema from either engine.

    Latency/throughput units are the engine's clock (seconds for the DSPE
    simulator, scheduler ticks for the serving engine); the normalised
    metrics (imbalance, memory_overhead_norm, remap_frac_mean) are unitless
    and comparable across engines.
    """

    edge: str
    src: str
    dst: str
    scheme: str
    workers: int
    n_tuples: int
    execution_time: float
    latency_avg: float
    latency_p50: float
    latency_p95: float
    latency_p99: float
    throughput: float
    memory_overhead: int
    memory_overhead_norm: float
    imbalance: float
    remap_events: List[Dict] = dataclasses.field(default_factory=list)
    remap_frac_mean: Optional[float] = None
    dropped: int = 0
    # host↔device launches this edge made across the session —
    # the fused engine's "one dispatch per steady-state feed" evidence;
    # the host engines report 0
    dispatches: int = 0
    # keyed operator state — populated when the destination stage
    # carries a WindowOp; state_bytes is the peak Σ_w store bytes (the
    # *measured* counterpart of the memory_overhead key-replica proxy)
    state_bytes: Optional[int] = None
    state_entries: Optional[int] = None
    partial_entries: Optional[int] = None
    migration_bytes: int = 0
    tuples_replayed: int = 0
    # observability: ingress-queue pressure + admission + the
    # engine-clock stall billed for migrated keyed state.  The serving
    # engine fills the queue/in-flight/shed columns (its ingress queues are
    # real); the virtual-time simulator reports 0 there but does bill
    # migration_stall (seconds added to destination workers' busy time).
    queue_depth_peak: int = 0
    in_flight_peak: int = 0
    shed: int = 0
    time_in_queue_avg: float = 0.0
    time_in_queue_p99: float = 0.0
    migration_stall: float = 0.0

    def row(self) -> Dict[str, float]:
        """The paper-metric columns (same keys as ``StreamMetrics.row``)."""
        return {
            "execution_time": self.execution_time,
            "latency_avg": self.latency_avg,
            "latency_p50": self.latency_p50,
            "latency_p95": self.latency_p95,
            "latency_p99": self.latency_p99,
            "throughput": self.throughput,
            "memory_overhead": self.memory_overhead,
            "memory_overhead_norm": self.memory_overhead_norm,
            "imbalance": self.imbalance,
        }

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TopologyReport:
    """Whole-topology outcome: per-edge reports + end-to-end latency of each
    sink tuple measured from its *root* source tuple's arrival."""

    engine: str
    topology: str
    n_source_tuples: int
    total_time: float
    e2e_latency_avg: float
    e2e_latency_p50: float
    e2e_latency_p95: float
    e2e_latency_p99: float
    edges: List[EdgeReport] = dataclasses.field(default_factory=list)
    # keyed operator state: per-operator-stage summaries (incl.
    # the merged per-window results) + topology-wide migration cost
    state: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    migration_bytes: int = 0
    tuples_replayed: int = 0
    # open-loop accounting.  ``shed`` / ``queue_depth_peak`` /
    # ``migration_stall`` aggregate the edge columns at close; the offered /
    # deferred / residual / time-in-queue / autoscale columns are stamped by
    # the open-loop driver (the reference's ``repro.load``, not ported
    # yet) — a closed-loop run reports offered == n_source_tuples and zeros
    # elsewhere.
    offered: int = 0
    shed: int = 0
    deferred: int = 0
    residual: int = 0
    queue_depth_peak: int = 0
    time_in_queue_avg: float = 0.0
    time_in_queue_p99: float = 0.0
    migration_stall: float = 0.0
    autoscale_events: List[Dict] = dataclasses.field(default_factory=list)
    # telemetry: the session's downsampled metric timeline +
    # metrics snapshot (``Telemetry.timeline_dict``).  ``None`` whenever
    # telemetry is disabled, and then *omitted* from ``to_dict`` — report
    # dicts stay bit-identical to pre-telemetry output.
    timeline: Optional[Dict] = None

    def edge(self, name: str) -> EdgeReport:
        """Lookup by full edge name (``"src->dst"``) or by dst stage."""
        for er in self.edges:
            if er.edge == name or er.dst == name:
                return er
        raise KeyError(f"no edge {name!r} in topology {self.topology!r}")

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        if d.get("timeline") is None:
            d.pop("timeline", None)
        return d


@dataclasses.dataclass
class FeedReceipt:
    """What ``Session.feed`` hands back per batch: the feedback
    channel an open-loop driver closes its control loops over — admission
    control watches ``backlog``/``queue_depth``, the p99 autoscaler watches
    ``latency_p99`` — without waiting for the close-time report.

    Units are the engine's clock (seconds for the DSPE simulator, scheduler
    ticks for the serving engine).  ``latencies`` holds this feed's raw
    per-tuple source-edge service latencies (serving: the latencies of
    requests that *finished* during this feed); ``backlog`` is how far the
    slowest source-edge worker's busy-until runs past the stream clock
    (serving: current total queued requests)."""

    n: int
    t_end: float
    latency_avg: float = 0.0
    latency_p99: float = 0.0
    backlog: float = 0.0
    latencies: Optional[np.ndarray] = None
    # serving-engine extras (the simulator reports 0: feeding is
    # instantaneous in virtual time, so nothing queues inside the engine)
    queue_depth: int = 0
    in_flight: int = 0
    done: int = 0
    shed: int = 0


@runtime_checkable
class Session(Protocol):
    """One streaming session: incremental execution of one topology.

    Lifecycle: ``Engine.open(topology)`` → any interleaving of
    ``feed(batch)`` (ingest the next :class:`RecordBatch`; batches must be
    time-ordered) and ``advance(events)`` (register membership/capacity
    events, addressed by per-stage tuple index or by ``at_time``) →
    ``close()`` (flush open windows, release operator partial streams
    through their downstream subtrees, and return the same
    :class:`TopologyReport` schema ``run`` produces).  All per-edge state —
    FIFO backlog, grouper epochs, keyed window state, remap accounting —
    carries across feeds.  ``feed`` returns a per-batch
    :class:`FeedReceipt` (``None`` for an empty batch) — 's
    open-loop feedback channel; closed-loop callers are free to ignore it.
    """

    def feed(self, batch: RecordBatch) -> Optional[FeedReceipt]:
        ...

    def advance(self, events: Sequence[ScopedEvent]) -> None:
        ...

    def close(self) -> TopologyReport:
        ...


@runtime_checkable
class Engine(Protocol):
    """One engine protocol: execute a topology against a source stream,
    either one-shot (``run``) or incrementally (``open`` → session)."""

    name: str

    def open(self, topology: Topology, *,
             arrival_rate: Optional[float] = None,
             telemetry: Optional[object] = None) -> Session:
        ...

    def run(self, topology: Topology, source: Source,
            events: Sequence[ScopedEvent] = ()) -> TopologyReport:
        ...


def _run_via_session(engine, topology: Topology, source: Source,
                     events: Sequence[ScopedEvent]) -> TopologyReport:
    """The one-shot path is literally a session: open, register the events,
    feed every batch, close.  With the array-form Source (one batch) this
    is bit-identical to the pre-session engines."""
    session = engine.open(topology, arrival_rate=source.arrival_rate)
    if events:
        session.advance(events)
    for batch in source.iter_batches():
        session.feed(batch)
    return session.close()


def _open_session(cls, engine, topology: Topology, telemetry, **kw):
    """A new ``cls`` session inside the span ``session.open``, on the
    telemetry bundle the session will use."""
    tel = (telemetry if telemetry is not None
           else get_telemetry().for_session())
    with tel.tracer.span("session.open", cat="session",
                         topology=topology.name):
        return cls(engine, topology, telemetry=tel, **kw)


class _BaseSession:
    """Shared session mechanics — event registration, feed validation and
    close-time report assembly; everything engine-specific (how a feed
    executes, what state an edge carries) lives in the subclasses."""

    def __init__(self, engine, topology: Topology, telemetry=None):
        self.engine = engine
        self.topology = topology
        self._edges = topology.ordered_edges()
        self._sinks = set(topology.sinks())
        self._st: Dict[str, object] = {}
        self._pending: Dict[str, List] = {e.dst: [] for e in self._edges}
        self._n_source = 0
        self._last_ts = -np.inf
        self._total_time = 0.0
        self._e2e: List[np.ndarray] = []
        self._report: Optional[TopologyReport] = None
        # explicit bundle wins; otherwise the process default —
        # which, when disabled, hands each session a private no-op bundle
        self.telemetry = (telemetry if telemetry is not None
                          else get_telemetry().for_session())
        self._feed_idx = -1
        tel = self.telemetry
        self._c_feeds = tel.metrics.counter("session.feeds")
        self._c_mem_events = tel.metrics.counter("session.membership_events")
        self._c_cap_events = tel.metrics.counter("session.capacity_events")

    def _session_observer(self):
        """Event-observer stage stamping membership/capacity events into
        the telemetry bundle (counters always; trace instants when
        enabled).  Chained after the per-edge accountant/manager."""
        tel = self.telemetry
        tr = tel.tracer
        c_mem = self._c_mem_events
        c_cap = self._c_cap_events

        def call(kind, grouper, event):
            if kind == "post_membership":
                c_mem.add(1)
                tr.instant("event.membership", cat="session",
                           at=int(event.at), workers=len(event.workers))
            elif kind == "capacity":
                c_cap.add(1)
                tr.instant("event.capacity", cat="session",
                           at=int(event.at), workers=len(event.capacities))

        return call

    def advance(self, events: Sequence[ScopedEvent]) -> None:
        """Register membership/capacity events for subsequent feeds.  Each
        event addresses its stage's *input* stream by tuple index (``at``,
        stream-global) or timestamp (``at_time``); an index/timestamp the
        stream never reaches means the event never fires."""
        self._check_open()
        for se in events:
            if not isinstance(se, ScopedEvent):
                raise TypeError(
                    f"advance takes ScopedEvent(stage, event) wrappers, "
                    f"got {type(se).__name__}")
            if se.stage not in self._pending:
                raise ValueError(f"no stage named {se.stage!r} in topology "
                                 f"{self.topology.name!r}")
            ev = se.event
            if getattr(ev, "at_time", None) is None and ev.at < 0:
                # at=-1 is the "address me via at_time()" placeholder; an
                # event still carrying it was built but never addressed
                raise ValueError(
                    f"event for stage {se.stage!r} has no address: give "
                    f"at= (tuple index) or wrap with at_time(event, t)")
            self._pending[se.stage].append(ev)

    def close(self) -> TopologyReport:
        """Flush open windows, release operator partial streams through
        their downstream subtrees, and report (same schema as ``run``)."""
        self._check_open()
        close_span = self.telemetry.tracer.span(
            "session.close", cat="session", topology=self.topology.name)
        state: Dict[str, Dict] = {}
        self._close_pump(state)
        reports = [self._edge_report(e) for e in self._edges]
        lats = np.concatenate(self._e2e) if self._e2e else np.empty(0)
        with self.telemetry.tracer.span("session.percentiles",
                                        cat="session", n=lats.shape[0]):
            avg, p50, p95, p99 = _percentiles(lats)
        self._report = TopologyReport(
            engine=self.engine.name, topology=self.topology.name,
            n_source_tuples=self._n_source, total_time=self._total_time,
            e2e_latency_avg=avg, e2e_latency_p50=p50, e2e_latency_p95=p95,
            e2e_latency_p99=p99, edges=reports, state=state,
            migration_bytes=sum(r.migration_bytes for r in reports),
            tuples_replayed=sum(r.tuples_replayed for r in reports),
            # closed-loop default: everything fed was offered; the open-loop
            # driver overwrites these with its admission accounting
            offered=self._n_source,
            shed=sum(r.shed for r in reports),
            queue_depth_peak=max((r.queue_depth_peak for r in reports),
                                 default=0),
            migration_stall=sum(r.migration_stall for r in reports),
            timeline=self.telemetry.timeline_dict(),
        )
        close_span.done()
        return self._report

    # -- shared internals ------------------------------------------------------
    def _close_state(self, st) -> None:
        """Stream end of an operator stage: flush its open windows and
        build its state report (``merge_partials`` included)."""
        tracer = self.telemetry.tracer
        with tracer.span("state.finalize", cat="state"):
            st.mgr.finalize()
        with tracer.span("state.report", cat="state"):
            st.srep = st.mgr.report(st.stage.name)

    def _check_open(self) -> None:
        if self._report is not None:
            raise RuntimeError("session is closed")

    def _check_batch(self, batch: RecordBatch) -> bool:
        """Validate a feed (type, emptiness, cross-feed time ordering) and
        advance the stream clock.  Returns False for an empty batch."""
        self._check_open()
        if not isinstance(batch, RecordBatch):
            raise TypeError(
                f"feed takes a RecordBatch, got {type(batch).__name__}")
        if len(batch) == 0:
            return False
        ts = batch.timestamps
        if float(ts[0]) < self._last_ts:
            raise ValueError(
                f"batches must be time-ordered: this feed starts at "
                f"t={float(ts[0]):g} but the stream is already at "
                f"t={self._last_ts:g}")
        self._last_ts = float(ts[-1])
        return True

    def _zero_report(self, edge: Edge, stage: Stage) -> EdgeReport:
        """The report row of an edge that never received a tuple."""
        return EdgeReport(
            edge=edge.name, src=edge.src, dst=edge.dst,
            scheme=edge.grouping.scheme, workers=stage.parallelism,
            n_tuples=0, execution_time=0.0, latency_avg=0.0,
            latency_p50=0.0, latency_p95=0.0, latency_p99=0.0,
            throughput=0.0, memory_overhead=0, memory_overhead_norm=0.0,
            imbalance=0.0)


def _due_events(pending: List, offset: int, times: np.ndarray):
    """Split a stage's pending events into the ones due within this feed's
    index window ``[offset, offset + len(times))`` — rewritten to feed-local
    indices — and the rest, which stay pending.  Time-addressed events
    resolve against this feed's input timestamps (first tuple at or after
    the timestamp); a timestamp that already slipped past (it fell between
    two feeds) fires at the feed's first tuple, and one past the fed stream
    stays pending (never firing if the stream ends first, mirroring an
    out-of-range index)."""
    n = int(times.shape[0])
    due, keep = [], []
    for e in pending:
        t = getattr(e, "at_time", None)
        if t is not None:
            if n == 0 or t > times[-1]:
                keep.append(e)
                continue
            at = offset + int(np.searchsorted(times, t, side="left"))
            e = dataclasses.replace(e, at=at, at_time=None)
        if e.at < offset + n:
            due.append(dataclasses.replace(e, at=max(e.at - offset, 0)))
        else:
            keep.append(e)
    return due, keep


# ---------------------------------------------------------------------------
# remap accounting (Fig. 17 "keys moved per membership event")
# ---------------------------------------------------------------------------


class RemapAccountant:
    """Event observer that probes a fixed key sample around each membership
    event and counts primary-route changes (works against any grouper via
    ``probe_route``; schemes with no key affinity report ``None``).

    ``offset`` rebases the recorded event position onto the stream-global
    index: sessions hand :func:`simulate_edge` feed-local events, so they
    set it to the feed's base index before each feed (0 for one-shot runs,
    keeping the reported rows identical to the pre-session engines).

    ``metrics``: an optional :class:`repro_torch.obs.MetricsRegistry`
    — the per-event rows stay the report source of truth, but the run
    totals (events seen, keys moved, keys sampled) are mirrored into
    ``remap.*`` counters so ``repro_torch.obs summarize`` sees them without
    re-walking every report."""

    def __init__(self, sample_keys: Sequence, metrics=None):
        self.sample = list(sample_keys)
        self.offset = 0
        self.per_event: List[Dict] = []
        self._before: Optional[List[Optional[int]]] = None
        self._c_events = (metrics.counter("remap.events")
                          if metrics is not None else None)
        self._c_moved = (metrics.counter("remap.keys_moved")
                         if metrics is not None else None)
        self._c_sampled = (metrics.counter("remap.keys_sampled")
                           if metrics is not None else None)

    def extend_sample(self, keys: Sequence, cap: int) -> None:
        """Grow the probe sample with unseen keys (up to ``cap``): sessions
        call this per feed while events are outstanding, so keys that first
        appear in later feeds — a post-flip hot head — are probed too."""
        have = set(self.sample)
        for k in keys:
            if len(self.sample) >= cap:
                break
            if k not in have:
                have.add(k)
                self.sample.append(k)

    def __call__(self, kind: str, grouper, event) -> None:
        if kind == "pre_membership":
            self._before = [grouper.probe_route(k) for k in self.sample]
        elif kind == "post_membership":
            after = [grouper.probe_route(k) for k in self.sample]
            row = {"at": int(event.at) + self.offset,
                   "sampled": len(self.sample)}
            if self.sample and after[0] is not None:
                moved = sum(1 for a, b in zip(self._before, after) if a != b)
                row["moved"] = moved
                row["frac"] = moved / len(self.sample)
            else:  # scheme with no key affinity (SG)
                row["moved"] = None
                row["frac"] = None
            self.per_event.append(row)
            self._before = None
            if self._c_events is not None:
                self._c_events.add(1)
                self._c_sampled.add(row["sampled"])
                if row["moved"] is not None:
                    self._c_moved.add(row["moved"])

    def frac_mean(self) -> Optional[float]:
        fracs = [e["frac"] for e in self.per_event if e["frac"] is not None]
        return float(np.mean(fracs)) if fracs else None


def _sample_keys(keys: np.ndarray, cap: int) -> List[int]:
    uniq = np.unique(np.asarray(keys))
    if uniq.shape[0] > cap:
        uniq = uniq[np.linspace(0, uniq.shape[0] - 1, cap).astype(np.int64)]
    return [int(k) for k in uniq]


def _percentiles(lats: np.ndarray):
    if lats.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    return (float(lats.mean()), float(np.percentile(lats, 50)),
            float(np.percentile(lats, 95)), float(np.percentile(lats, 99)))


def _imbalance(counts: np.ndarray) -> float:
    counts = counts.astype(np.float64)
    return float((counts.max() - counts.mean())
                 / max(counts.mean(), 1e-12)) if counts.size else 0.0


def _chain_observers(*observers):
    """Fan one event-observer callback out to several consumers (remap
    accountant + keyed-state manager)."""

    def call(kind, grouper, event):
        for o in observers:
            o(kind, grouper, event)

    return call


def _fish_epoch_observer(telemetry, grouper):
    """Per-epoch FISH telemetry for the host engines: hooked onto
    :attr:`EpochFrequencyTracker.epoch_observer`, fired at every
    TimeDecayingUpdate.  Emits the hot-set size, its churn vs the previous
    epoch, and per-worker imbalance — each stamped with the epoch index —
    plus a ``fish.epoch_decay`` trace instant.  (The fused engine emits the
    same series from the device-resident tracker after epoch-crossing
    segments.)"""
    tel = telemetry
    prev_hot: set = set()

    def on_epoch(tracker) -> None:
        epoch_idx = tracker.epochs_completed
        tel.ctx.epoch_idx = epoch_idx
        theta = tracker.params.theta(grouper.num_workers)
        hot = set(tracker.hot_keys(grouper.num_workers))
        churn = len(hot ^ prev_hot)
        tl = tel.timeline
        tl.point("fish.hot_set_size", len(hot), epoch_idx=epoch_idx)
        tl.point("fish.hot_set_churn", churn, epoch_idx=epoch_idx)
        counts = grouper.assigned_counts
        if counts.size and counts.sum() > 0:
            mean = counts.mean()
            tl.point("fish.worker_imbalance",
                     float(counts.max() / max(mean, 1e-12)),
                     epoch_idx=epoch_idx)
        tel.tracer.instant("fish.epoch_decay", cat="fish", epoch=epoch_idx,
                           hot_set=len(hot), theta=theta)
        prev_hot.clear()
        prev_hot.update(hot)

    return on_epoch


def _stage_manager(stage: Stage, device=None,
                   tracer=NULL_TRACER) -> Optional[KeyedStateManager]:
    return (KeyedStateManager(stage.operator, device=device, tracer=tracer)
            if stage.operator is not None else None)


def _state_extra(srep: Optional[StateReport]) -> Dict:
    """The EdgeReport state columns for an operator stage —
    shared by both engines so the schema cannot drift."""
    if srep is None:
        return {}
    from ..state.store import ENTRY_BYTES

    return dict(state_bytes=srep.state_bytes_peak,
                state_entries=srep.state_bytes_peak // ENTRY_BYTES,
                partial_entries=srep.partial_entries,
                migration_bytes=srep.migration_bytes,
                tuples_replayed=srep.tuples_replayed)


def _emit_partials(partials, finishes: np.ndarray, in_roots: np.ndarray,
                   fallback_time: float):
    """The stream a batch of flushed window partials emits downstream: one
    partial-aggregate tuple per state entry, keyed by the aggregation key
    and released when its worker flushed the window (the finish time of
    that worker's last tuple in the window; ``fallback_time`` covers
    entries whose anchor tuple never finished — the serving engine's
    dropped requests).  Partial tuples carry no payload column.  Sessions
    call this per feed with the windows that closed during it (incremental
    emission — satellite) and once more at close with the
    remainder."""
    if not partials:
        return (np.empty(0, dtype=np.int64), np.empty(0),
                np.empty(0, dtype=np.int64), None)
    # release time and root are constant within a partial, so the stable
    # element sort collapses to a stable sort of the partials themselves
    last = np.array([p.last_index for p in partials], dtype=np.int64)
    t_p = finishes[last]
    t_p = np.where(t_p >= 0.0, t_p, fallback_time)
    roots_p = in_roots[last]
    sizes = np.array([p.keys.shape[0] for p in partials], dtype=np.int64)
    order = np.argsort(t_p, kind="stable")
    ks = np.concatenate([partials[i].keys for i in order.tolist()])
    return (ks, np.repeat(t_p[order], sizes[order]),
            np.repeat(roots_p[order], sizes[order]), None)


# ---------------------------------------------------------------------------
# DSPE simulator engine
# ---------------------------------------------------------------------------


class SimulatorEngine:
    """Discrete-event DSPE engine over a topology (paper §6.1 at every hop).

    mode="batched" is the production path;
    mode="reference" is the per-tuple interpreter kept as the equivalence
    oracle — identical event/sampling discipline, so SG/FG/PKG topologies
    match it exactly and DC/WC/FISH stay within the DESIGN.md §6 bands.
    mode="fused" runs each grouped edge as a few device kernel
    launch per event-free segment — routing, closed-form FIFO, and keyed
    window state fused in :mod:`repro_torch.kernels.feed_fused` — with operator
    windows flushed downstream incrementally at each feed's end.
    """

    def __init__(self, mode: str = "batched", utilization: float = 0.9,
                 sample_every: int = 5_000, sample_noise: float = 0.02,
                 seed: int = 0, remap_sample: int = 512,
                 migration_cost_per_byte: float = 0.0,
                 migration_cost_per_replay: float = 0.0, device=None):
        if mode not in ("batched", "reference", "fused"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        # the fused runner's and the "device" state stores' torch device
        # (None = "cuda": raises without a card); the host engines without
        # device stores never touch it
        self.device = device
        self.utilization = utilization
        self.sample_every = sample_every
        self.sample_noise = sample_noise
        self.seed = seed
        self.remap_sample = remap_sample
        # tick-billed migration: seconds of destination-worker stall
        # per migrated state byte (policy "migrate") / per replayed tuple
        # (policy "rebuild").  0 keeps migration free — the unbilled
        # behaviour, and bit-identical reports
        self.migration_cost_per_byte = migration_cost_per_byte
        self.migration_cost_per_replay = migration_cost_per_replay
        self.name = f"dspe-{mode}"

    def open(self, topology: Topology, *,
             arrival_rate: Optional[float] = None,
             telemetry: Optional[object] = None) -> "SimulatorSession":
        """Open an incremental streaming session on this simulator.
        ``arrival_rate`` is the capacity-planning hint for stages without
        an explicit cost (``None``: inferred from the first feed);
        ``telemetry`` is an explicit :class:`repro_torch.obs.Telemetry` bundle
        (default: the process one — a no-op unless ``repro_torch.obs.enable()``
        was called)."""
        return _open_session(SimulatorSession, self, topology, telemetry,
                             arrival_rate=arrival_rate)

    def run(self, topology: Topology, source: Source,
            events: Sequence[ScopedEvent] = ()) -> TopologyReport:
        return _run_via_session(self, topology, source, events)


class _SimEdge:
    """One grouped edge's carried session state (DSPE simulator)."""

    __slots__ = ("stage", "grouper", "caps", "state", "acct", "mgr",
                 "lats", "n", "seed", "dt_hint", "finishes", "roots", "srep",
                 "emitted", "dispatches", "biller")

    def __init__(self, stage: Stage, grouper, caps: np.ndarray, seed: int,
                 dt_hint: Optional[float], mgr: Optional[KeyedStateManager],
                 biller: Optional[MigrationBiller] = None, metrics=None):
        self.stage = stage
        self.grouper = grouper
        self.caps = caps
        self.state = None            # core.stream.EdgeState after 1st feed
        self.seed = seed
        self.dt_hint = dt_hint
        self.acct = RemapAccountant([], metrics=metrics)
        self.mgr = mgr
        self.lats: List[np.ndarray] = []
        self.n = 0
        self.finishes: List[np.ndarray] = []  # operator stages only
        self.roots: List[np.ndarray] = []     # operator stages only
        self.srep: Optional[StateReport] = None
        self.emitted = 0             # window partials already sent downstream
        self.dispatches = 0          # fused-mode device launches
        self.biller = biller         # tick-billed migration


class SimulatorSession(_BaseSession):
    """Incremental record-batch execution on the DSPE simulator.

    Every feed pushes one :class:`RecordBatch` through the whole topology
    subtree reachable via transform stages; the closed-form FIFO in
    :func:`repro_torch.core.stream.simulate_edge` continues from the carried
    per-worker ``busy_until`` so queue backlog survives the feed boundary.
    Operator stages fold tuples into their keyed windows per feed and
    release the partial-aggregate stream through their downstream merge
    edges at :meth:`close` (when the final windows flush).

    Worker-capacity defaults for stages without an explicit ``cost`` /
    ``capacities`` are frozen at the edge's first feed (from the arrival
    rate observed there, or the ``arrival_rate`` hint for the source edge).
    """

    def __init__(self, engine: "SimulatorEngine", topology: Topology,
                 arrival_rate: Optional[float] = None, telemetry=None):
        super().__init__(engine, topology, telemetry=telemetry)
        self._rate = arrival_rate
        self._order = {e.name: i for i, e in enumerate(self._edges)}
        self._src_times: List[np.ndarray] = []

    # -- protocol --------------------------------------------------------------
    def feed(self, batch: RecordBatch) -> Optional[FeedReceipt]:
        """Ingest the next record batch and run it through the topology.
        Returns this feed's :class:`FeedReceipt` (source-edge latencies +
        engine backlog — the open-loop feedback channel)."""
        if not self._check_batch(batch):
            return None
        tel = self.telemetry
        self._feed_idx += 1
        tel.ctx.feed_idx = self._feed_idx
        self._c_feeds.add(1)
        n = len(batch)
        feed_span = tel.tracer.span("session.feed", cat="session", n=n,
                                    feed_idx=self._feed_idx)
        ts = batch.timestamps
        base = self._n_source
        roots = np.arange(base, base + n, dtype=np.int64)
        self._n_source += n
        self._src_times.append(ts)
        streams = {SOURCE: (batch.keys, ts, roots, batch.values)}
        self._pump(streams, lambda r: ts[r - base])
        receipt = self._feed_receipt(n, float(ts[-1]))
        tel.ctx.engine_clock = receipt.t_end
        tl = tel.timeline
        tl.point("session.backlog", receipt.backlog)
        tl.point("session.latency_p99", receipt.latency_p99)
        feed_span.done()
        return receipt

    def _feed_receipt(self, n: int, t_end: float) -> FeedReceipt:
        lats: List[np.ndarray] = []
        backlog = 0.0
        for e in self._edges:
            if e.src != SOURCE:
                continue
            st = self._st.get(e.name)
            if st is None or not st.lats:
                continue
            lats.append(st.lats[-1])
            if st.state is not None:
                backlog = max(backlog,
                              float(st.state.busy_until.max()) - t_end)
        arr = np.concatenate(lats) if lats else np.empty(0)
        avg, _, _, p99 = _percentiles(arr)
        return FeedReceipt(n=n, t_end=t_end, latency_avg=avg,
                           latency_p99=p99, backlog=max(backlog, 0.0),
                           latencies=arr)

    # -- internals -------------------------------------------------------------
    def _close_pump(self, state: Dict[str, Dict]) -> None:
        src_all = (np.concatenate(self._src_times) if self._src_times
                   else np.empty(0))
        self._pump({}, lambda r: src_all[r], state=state)

    def _pump(self, streams: Dict, src_arrival, state=None) -> None:
        """Push per-stage streams through the DAG in dataflow order.  With
        ``state`` set (close-time), operator stages finalize and release
        their remaining partials downstream."""
        for edge in self._edges:
            if edge.src in streams:
                emission = self._run_edge(edge, *streams[edge.src],
                                          src_arrival)
                if emission is not None:
                    streams[edge.dst] = emission
            if state is None:
                continue
            st = self._st.get(edge.name)
            if st is not None and st.mgr is not None:
                dev = (getattr(st.state, "device", None)
                       if st.state is not None else None)
                if dev is not None and hasattr(dev, "flush_pane"):
                    # fused mode: drain the device pane tables so the final
                    # (possibly partial) window reaches the manager before
                    # finalize() flushes it
                    dev.flush_pane(st.mgr)
                self._close_state(st)
                state[st.stage.name] = st.srep.summary()
                if st.stage.name not in self._sinks:
                    rest = st.mgr.partials[st.emitted:]
                    if rest or st.emitted == 0:
                        fin = (np.concatenate(st.finishes) if st.finishes
                               else np.empty(0))
                        roots = (np.concatenate(st.roots) if st.roots
                                 else np.empty(0, dtype=np.int64))
                        streams[st.stage.name] = _emit_partials(
                            rest, fin, roots,
                            float(fin.max()) if fin.size else 0.0)
                        st.emitted = len(st.mgr.partials)

    def _run_edge(self, edge: Edge, in_keys, in_times, in_roots, in_values,
                  src_arrival) -> Optional[tuple]:
        eng = self.engine
        st = self._st.get(edge.name)
        stage = self.topology.stage(edge.dst)
        m = int(in_keys.shape[0])
        if st is None:
            span = float(in_times[-1] - in_times[0]) if m > 1 else 0.0
            fallback = self._rate if self._rate else 10_000.0
            rate = (m - 1) / span if span > 0 else fallback
            idx = self._order[edge.name]
            # the grouper gets no oracle capacities: capacity-aware schemes
            # must *discover* the true P_w through the periodic (noisy)
            # sampling hook, exactly like the legacy single-hop engine
            mgr0 = _stage_manager(stage, eng.device,
                                  self.telemetry.tracer)
            biller = None
            if mgr0 is not None and (eng.migration_cost_per_byte
                                     or eng.migration_cost_per_replay):
                biller = MigrationBiller(mgr0.migration,
                                         eng.migration_cost_per_byte,
                                         eng.migration_cost_per_replay)
            st = self._st[edge.name] = _SimEdge(
                stage=stage,
                grouper=build_grouper(edge.grouping, stage.parallelism),
                caps=stage.worker_capacities(rate, eng.utilization),
                seed=eng.seed + 17 * idx,
                dt_hint=(1.0 / self._rate
                         if edge.src == SOURCE and self._rate else None),
                mgr=mgr0, biller=biller,
                metrics=self.telemetry.metrics)
            trk = getattr(st.grouper, "tracker", None)
            if self.telemetry.enabled and trk is not None:
                trk.epoch_observer = _fish_epoch_observer(
                    self.telemetry, st.grouper)
        due, keep = _due_events(self._pending[edge.dst], st.n, in_times)
        self._pending[edge.dst] = keep
        # probe sample only while membership events are outstanding —
        # _sample_keys is an O(m log m) unique over the edge stream; it
        # accumulates across feeds so late-arriving hot keys are probed too
        if due or keep:
            st.acct.extend_sample(_sample_keys(in_keys, eng.remap_sample),
                                  eng.remap_sample)
        st.acct.offset = st.n  # events below are feed-local; report global
        mgr = st.mgr
        fused = eng.mode == "fused"
        chain = [st.acct]
        if mgr is not None:
            chain.append(mgr.on_event)
            if st.biller is not None:
                # biller after the manager: the manager's post_membership
                # runs the migration protocol that leaves the per-target bill
                chain.append(st.biller.on_event)
        if due:  # telemetry last: it observes, never reshapes
            chain.append(self._session_observer())
        observer = chain[0] if len(chain) == 1 else _chain_observers(*chain)
        billed0 = st.biller.billed_total if st.biller is not None else 0.0
        res = simulate_edge(
            st.grouper, in_keys, times=in_times,
            arrival_rate=self._rate or 10_000.0, mode=eng.mode,
            capacities=st.caps if st.state is None else None,
            sample_every=eng.sample_every, sample_noise=eng.sample_noise,
            events=due, seed=st.seed,
            event_observer=observer,
            tuple_observer=(mgr.feed
                            if (mgr is not None and not fused) else None),
            state_sink=(mgr if (mgr is not None and fused) else None),
            values=in_values, state=st.state, dt=st.dt_hint,
            compute_metrics=False,  # aggregated once at close
            migration_biller=st.biller,
            telemetry=self.telemetry,
            device=eng.device,
        )
        st.state = res.state
        st.lats.append(res.latencies)
        st.n += m
        st.dispatches += res.dispatches
        if st.biller is not None:
            billed1 = st.biller.billed_total
            if billed1 != billed0:
                self.telemetry.timeline.point("migration.stall_total",
                                              billed1)
        if m:
            self._total_time = max(self._total_time,
                                   float(res.finishes.max()))
        if stage.name in self._sinks:
            self._e2e.append(res.finishes - src_arrival(in_roots))
        elif mgr is not None:
            # operator stages flush closed windows downstream at the end of
            # each feed (incremental emission); the remainder goes
            # out at close().  Finish times anchor the partial stream.
            st.finishes.append(res.finishes)
            st.roots.append(np.asarray(in_roots))
            fresh = mgr.drain_partials(st.emitted)
            if fresh:
                st.emitted += len(fresh)
                fin = np.concatenate(st.finishes)
                roots = np.concatenate(st.roots)
                return _emit_partials(fresh, fin, roots, float(fin.max()))
        else:  # intermediate stage: release transformed tuples
            return _emit(stage, in_keys, res.finishes, in_roots, in_values)
        return None

    def _edge_report(self, edge: Edge) -> EdgeReport:
        st = self._st.get(edge.name)
        stage = self.topology.stage(edge.dst)
        if st is None:  # the edge never received a tuple
            return self._zero_report(edge, stage)
        dev = getattr(st.state, "device", None)
        if dev is not None and hasattr(dev, "host_sync"):
            # fused mode keeps replica sets device-resident between feeds;
            # memory_overhead needs them on the host grouper
            dev.host_sync(st.grouper)
        lats = np.concatenate(st.lats) if st.lats else np.empty(0)
        with self.telemetry.tracer.span("session.edge_metrics",
                                        cat="session", edge=edge.name):
            metrics = edge_metrics(st.grouper, st.state.busy_until, lats,
                                   st.n)
        return EdgeReport(edge=edge.name, src=edge.src, dst=edge.dst,
                          scheme=edge.grouping.scheme,
                          workers=stage.parallelism, n_tuples=st.n,
                          remap_events=st.acct.per_event,
                          remap_frac_mean=st.acct.frac_mean(),
                          dispatches=st.dispatches,
                          migration_stall=(st.biller.billed_total
                                           if st.biller else 0.0),
                          **metrics.row(), **_state_extra(st.srep))


def _emit(stage: Stage, in_keys: np.ndarray, finishes: np.ndarray,
          in_roots: np.ndarray, in_values: Optional[np.ndarray] = None):
    """The stream a stage emits: transformed keys released at each tuple's
    finish time, sorted into arrival order (stable — ties keep emission
    order, mirroring a FIFO merge of the per-worker output streams).  A
    payload column rides along: each emitted tuple inherits its parent's
    value (a split sentence's words carry the sentence's payload)."""
    t = stage.transform
    if t is not None:
        out_keys = t(in_keys)
        out_times = np.repeat(finishes, t.fanout)
        out_roots = np.repeat(in_roots, t.fanout)
        out_values = (None if in_values is None
                      else np.repeat(in_values, t.fanout))
    else:
        out_keys, out_times, out_roots = in_keys, finishes, in_roots
        out_values = in_values
    order = np.argsort(out_times, kind="stable")
    return (out_keys[order], out_times[order], out_roots[order],
            None if out_values is None else out_values[order])


# ---------------------------------------------------------------------------
# serving engine adapter
# ---------------------------------------------------------------------------


class ServingTopologyEngine:
    """Run a topology on the continuous-batching serving engine.

    Each edge is a :class:`~repro_torch.serving.engine.ServingEngine` replica
    pool (slot-limited decode, inferred-backlog routing); each tuple is a
    1-token request whose session is the tuple key.  Membership events map
    to ``fail_replica``/``add_replica`` (new workers must extend the id
    range contiguously — replica ids are never reused); capacity events set
    replica speeds to ``1/seconds_per_tuple``.
    """

    name = "serving"

    def __init__(self, slots_per_replica: int = 4, max_requests: int = 256,
                 utilization: float = 0.8, max_ticks: int = 200_000,
                 remap_sample: int = 512, pacing: str = "drain",
                 ticks_per_second: float = 1.0,
                 max_queue_per_replica: Optional[int] = None,
                 migration_ticks_per_byte: float = 0.0,
                 migration_ticks_per_replay: float = 0.0):
        if pacing not in ("drain", "arrival"):
            raise ValueError(
                f"unknown pacing {pacing!r}; 'drain' (closed loop: each "
                f"feed runs until its requests finish) or 'arrival' (open "
                f"loop: each feed's requests are submitted at "
                f"their wall-clock arrival ticks and the engine only runs "
                f"up to the feed's last arrival; close() drains)")
        self.slots_per_replica = slots_per_replica
        self.max_requests = max_requests
        self.utilization = utilization
        self.max_ticks = max_ticks
        self.remap_sample = remap_sample
        # open-loop serving: arrival pacing maps source wall-clock
        # seconds onto the tick grid via ticks_per_second; a bounded ingress
        # queue sheds on overflow; migrated keyed state stalls the
        # destination replica for ticks ∝ bytes shipped / tuples replayed
        self.pacing = pacing
        self.ticks_per_second = ticks_per_second
        self.max_queue_per_replica = max_queue_per_replica
        self.migration_ticks_per_byte = migration_ticks_per_byte
        self.migration_ticks_per_replay = migration_ticks_per_replay

    def open(self, topology: Topology, *,
             arrival_rate: Optional[float] = None,
             telemetry: Optional[object] = None) -> "ServingSession":
        """Open an incremental streaming session on the serving engine
        (``arrival_rate`` is accepted for protocol symmetry; serving time
        is scheduler ticks, paced by the topology bottleneck)."""
        return _open_session(ServingSession, self, topology, telemetry)

    def run(self, topology: Topology, source: Source,
            events: Sequence[ScopedEvent] = ()) -> TopologyReport:
        return _run_via_session(self, topology, source, events)


class _ServingEdge:
    """One grouped edge's carried session state (serving engine)."""

    __slots__ = ("stage", "eng", "acct", "mgr", "reqs", "in_times", "n",
                 "tick", "roots", "srep", "emitted", "biller", "done_seen")

    def __init__(self, stage: Stage, eng,
                 mgr: Optional[KeyedStateManager],
                 biller: Optional[MigrationBiller] = None, metrics=None):
        self.stage = stage
        self.eng = eng
        self.acct = RemapAccountant([], metrics=metrics)
        self.mgr = mgr
        self.biller = biller  # tick-billed migration
        self.reqs: List = []
        self.in_times: List[np.ndarray] = []
        self.n = 0
        self.tick = 0
        self.roots: List[np.ndarray] = []  # operator stages only
        self.srep: Optional[StateReport] = None
        self.emitted = 0  # window partials already sent downstream
        self.done_seen = 0  # eng.done cursor (per-feed finish latencies)


class ServingSession(_BaseSession):
    """Incremental record-batch execution on the continuous-batching
    serving engine: each feed's tuples become 1-token requests submitted
    onto the carried per-edge replica pools, and the per-edge tick loops
    resume where the previous feed left them (each feed drains before the
    next — backlogged replicas carry their queues across the boundary).

    Serving time is scheduler ticks: a feed's records arrive on the
    stream-global tick grid regardless of their wall-clock timestamps.
    ``at_time`` events therefore resolve against the *source* wall-clock
    timestamps and scale onto each stage's input stream by the cumulative
    transform fanout.  Feeds larger than ``max_requests`` are subsampled
    (per feed — per-tick scheduling is Python-loop work).
    """

    def __init__(self, engine: "ServingTopologyEngine", topology: Topology,
                 telemetry=None):
        super().__init__(engine, topology, telemetry=telemetry)
        # bottleneck-feasible pacing: source tuples per tick such that every
        # stage sees at most `utilization` of its token capacity
        per_tick = engine.utilization * min(
            topology.stage(e.dst).parallelism / topology.fanout_to(e.dst)
            for e in topology.edges
        )
        self._dt = 1.0 / max(per_tick, 1e-9)
        # per-feed source-edge finish latencies (FeedReceipt channel)
        self._feed_lats: List[np.ndarray] = []

    # -- protocol --------------------------------------------------------------
    def feed(self, batch: RecordBatch) -> Optional[FeedReceipt]:
        """Ingest the next record batch (subsampled to ``max_requests``).
        With ``pacing="drain"`` (closed loop) records arrive on the
        bottleneck-paced tick grid and the feed runs until they finish;
        with ``pacing="arrival"`` (open loop) they arrive at
        their wall-clock timestamps × ``ticks_per_second`` and the engine
        only ticks up to the feed's last arrival — queues grow under
        overload and ``close()`` drains the backlog."""
        if not self._check_batch(batch):
            return None
        tel = self.telemetry
        self._feed_idx += 1
        tel.ctx.feed_idx = self._feed_idx
        self._c_feeds.add(1)
        feed_span = tel.tracer.span("session.feed", cat="session",
                                    n=len(batch), feed_idx=self._feed_idx)
        keys, ts, vals = batch.keys, batch.timestamps, batch.values
        if keys.shape[0] > self.engine.max_requests:
            pick = np.linspace(0, keys.shape[0] - 1,
                               self.engine.max_requests).astype(np.int64)
            keys, ts = keys[pick], ts[pick]
            vals = None if vals is None else vals[pick]
        n = int(keys.shape[0])
        base = self._n_source
        self._n_source += n
        self._resolve_at_time(ts, base)
        if self.engine.pacing == "arrival":
            src_ticks = np.asarray(ts, dtype=np.float64) \
                * self.engine.ticks_per_second
        else:
            src_ticks = np.arange(base, base + n, dtype=np.float64) \
                * self._dt
        streams = {SOURCE: (keys, src_ticks,
                            np.arange(base, base + n, dtype=np.int64),
                            vals)}
        done0, shed0 = self._done_shed()
        lat0 = len(self._feed_lats)
        self._pump(streams)
        done1, shed1 = self._done_shed()
        arr = (np.concatenate(self._feed_lats[lat0:])
               if len(self._feed_lats) > lat0 else np.empty(0))
        avg, _, _, p99 = _percentiles(arr)
        depth = in_flight = 0
        for st in self._st.values():
            depth += sum(len(q) for q in st.eng.queues)
            in_flight += sum(len(st.eng.slots[r].active)
                             for r in st.eng.alive)
        receipt = FeedReceipt(n=n, t_end=float(src_ticks[-1]),
                              latency_avg=avg, latency_p99=p99,
                              backlog=float(depth), latencies=arr,
                              queue_depth=depth, in_flight=in_flight,
                              done=done1 - done0, shed=shed1 - shed0)
        tel.ctx.engine_clock = receipt.t_end  # scheduler ticks
        tl = tel.timeline
        tl.point("session.queue_depth", depth)
        tl.point("session.in_flight", in_flight)
        tl.point("session.latency_p99", p99)
        tl.point("session.shed_total", shed1)
        feed_span.done()
        return receipt

    def _done_shed(self):
        done = sum(len(st.eng.done) for st in self._st.values())
        shed = sum(st.eng.shed for st in self._st.values())
        return done, shed

    # -- internals -------------------------------------------------------------
    def _close_pump(self, state: Dict[str, Dict]) -> None:
        if self.engine.pacing == "arrival":
            self._drain()
        self._pump({}, state=state)

    def _drain(self) -> None:
        """Open-loop close: tick every edge's engine until each submitted
        request is accounted for (finished or shed), then collect the
        deferred sink e2e latencies (measured from each request's arrival
        tick — for the single-edge open-loop topologies source arrival and
        edge arrival coincide)."""
        for edge in self._edges:
            st = self._st.get(edge.name)
            if st is None:
                continue
            eng = st.eng
            while (len(eng.done) + eng.shed < st.n
                   and st.tick < self.engine.max_ticks):
                eng.tick()
                st.tick += 1
            self._total_time = max(self._total_time, float(eng.now))
            if edge.dst in self._sinks:
                fins = np.array([r.finished for r in st.reqs])
                arrs = np.array([r.arrival for r in st.reqs])
                done = fins >= 0
                self._e2e.append((fins - arrs)[done])

    def _submit(self, st, req, in_keys, in_values, i) -> None:
        """Admit one request; keyed state is fed only for admitted requests
        (a shed request touches no operator state — honest accounting)."""
        replica = st.eng.submit(req)
        if replica < 0:  # shed by the bounded ingress queue
            return
        if st.mgr is not None:  # routed exactly once, at ingress
            st.mgr.feed(in_keys[i:i + 1], np.array([replica]),
                        None if in_values is None
                        else in_values[i:i + 1])

    def _resolve_at_time(self, ts: np.ndarray, base: int) -> None:
        """Lower time-addressed events onto stage-input tuple indices: the
        first (subsampled) source record at or after the timestamp, scaled
        by the stage's cumulative transform fanout."""
        for stage, pending in self._pending.items():
            if not any(getattr(e, "at_time", None) is not None
                       for e in pending):
                continue
            fan = self.topology.fanout_to(stage)
            out = []
            for e in pending:
                t = getattr(e, "at_time", None)
                if t is not None and ts.shape[0] and t <= float(ts[-1]):
                    src_idx = base + int(np.searchsorted(ts, t, side="left"))
                    e = dataclasses.replace(e, at=src_idx * fan,
                                            at_time=None)
                out.append(e)
            self._pending[stage] = out

    def _pump(self, streams: Dict, state=None) -> None:
        for edge in self._edges:
            if edge.src in streams:
                emission = self._run_edge(edge, *streams[edge.src])
                if emission is not None:
                    streams[edge.dst] = emission
            if state is None:
                continue
            st = self._st.get(edge.name)
            if st is not None and st.mgr is not None:
                self._close_state(st)
                state[st.stage.name] = st.srep.summary()
                if st.stage.name not in self._sinks:
                    rest = st.mgr.partials[st.emitted:]
                    if rest or st.emitted == 0:
                        fins = np.array([r.finished for r in st.reqs])
                        roots = (np.concatenate(st.roots) if st.roots
                                 else np.empty(0, dtype=np.int64))
                        streams[st.stage.name] = _emit_partials(
                            rest, fins, roots, float(st.eng.now))
                        st.emitted = len(st.mgr.partials)

    def _run_edge(self, edge: Edge, in_keys, in_times, in_roots,
                  in_values) -> Optional[tuple]:
        from ..serving.engine import Request, ServingEngine

        cfg = self.engine
        st = self._st.get(edge.name)
        stage = self.topology.stage(edge.dst)
        m = int(in_keys.shape[0])
        if st is None:
            caps = stage.worker_capacities(1.0)  # relative speeds only
            speeds = (1.0 / caps) / (1.0 / caps).mean()
            mgr0 = _stage_manager(stage, tracer=self.telemetry.tracer)
            biller = None
            if mgr0 is not None and (cfg.migration_ticks_per_byte
                                     or cfg.migration_ticks_per_replay):
                biller = MigrationBiller(mgr0.migration,
                                         cfg.migration_ticks_per_byte,
                                         cfg.migration_ticks_per_replay)
            st = self._st[edge.name] = _ServingEdge(
                stage=stage,
                eng=ServingEngine(
                    stage.parallelism,
                    slots_per_replica=cfg.slots_per_replica,
                    tokens_per_tick=speeds,
                    grouping=edge.grouping,
                    max_queue_per_replica=cfg.max_queue_per_replica,
                    metrics=self.telemetry.metrics),
                mgr=mgr0, biller=biller,
                metrics=self.telemetry.metrics)
            trk = getattr(st.eng.router, "tracker", None)
            if self.telemetry.enabled and trk is not None:
                trk.epoch_observer = _fish_epoch_observer(
                    self.telemetry, st.eng.router)
        pending = self._pending[edge.dst]
        hi = st.n + m
        due = sorted((e for e in pending
                      if e.at_time is None and e.at < hi),
                     key=lambda e: e.at)
        self._pending[edge.dst] = [e for e in pending
                                   if e.at_time is not None or e.at >= hi]
        if due or self._pending[edge.dst]:
            st.acct.extend_sample(_sample_keys(in_keys, cfg.remap_sample),
                                  cfg.remap_sample)
        mgr = st.mgr
        chain = [st.acct]
        if mgr is not None:
            chain.append(mgr.on_event)
            if st.biller is not None:
                # biller after the manager: the manager's post_membership
                # runs the migration protocol that leaves the per-target bill
                chain.append(st.biller.on_event)
        if due:  # telemetry last: it observes, never reshapes
            chain.append(self._session_observer())
        observer = chain[0] if len(chain) == 1 else _chain_observers(*chain)
        reqs_f = [Request(st.n + i, int(k), arrival=float(t),
                          target_tokens=1)
                  for i, (k, t) in enumerate(zip(in_keys.tolist(),
                                                 in_times.tolist()))]
        st.reqs.extend(reqs_f)
        st.in_times.append(np.asarray(in_times, dtype=np.float64))
        if mgr is not None:
            st.roots.append(np.asarray(in_roots))
        eng = st.eng
        tick = st.tick
        nxt = 0
        if cfg.pacing == "arrival":
            # open loop: submit at arrival ticks, run the engine
            # only up to this feed's last arrival — no waiting for
            # completions, so overload piles up in the ingress queues
            end_tick = int(np.ceil(float(in_times[-1])))
            while (nxt < m or tick < end_tick) and tick < cfg.max_ticks:
                while due and due[0].at <= st.n + nxt:
                    self._apply_event(st, due.pop(0), observer)
                while nxt < m and in_times[nxt] <= tick:
                    self._submit(st, reqs_f[nxt], in_keys, in_values, nxt)
                    nxt += 1
                eng.tick()
                tick += 1
            # arrivals sitting exactly on the final tick boundary
            while nxt < m:
                self._submit(st, reqs_f[nxt], in_keys, in_values, nxt)
                nxt += 1
        else:
            target = len(eng.done) + eng.shed + m
            while len(eng.done) + eng.shed < target \
                    and tick < cfg.max_ticks:
                while due and due[0].at <= st.n + nxt:
                    self._apply_event(st, due.pop(0), observer)
                while nxt < m and in_times[nxt] <= tick:
                    self._submit(st, reqs_f[nxt], in_keys, in_values, nxt)
                    nxt += 1
                eng.tick()
                tick += 1
        st.tick = tick
        st.n += m
        if edge.src == SOURCE:
            new_done = eng.done[st.done_seen:]
            st.done_seen = len(eng.done)
            self._feed_lats.append(np.array(
                [r.finished - r.arrival for r in new_done]))
        finishes = np.array([r.finished for r in reqs_f])
        done = finishes >= 0
        if done.any():
            self._total_time = max(self._total_time,
                                   float(finishes[done].max()))
        if stage.name in self._sinks:
            if cfg.pacing == "arrival":
                # open loop: most of this feed's requests are still queued;
                # e2e is collected once at close, after the drain
                pass
            else:
                self._e2e.append((finishes - in_roots * self._dt)[done])
        elif mgr is not None:
            # windows that closed during this feed go downstream now; the
            # remainder is released at close() (incremental emission)
            fresh = mgr.drain_partials(st.emitted)
            if fresh:
                st.emitted += len(fresh)
                all_fins = np.array([r.finished for r in st.reqs])
                roots = np.concatenate(st.roots)
                return _emit_partials(fresh, all_fins, roots,
                                      float(st.eng.now))
        else:  # intermediate stage: release transformed tuples
            return _emit(stage, in_keys[done], finishes[done],
                         in_roots[done],
                         None if in_values is None else in_values[done])
        return None

    def _edge_report(self, edge: Edge) -> EdgeReport:
        st = self._st.get(edge.name)
        stage = self.topology.stage(edge.dst)
        if st is None:  # the edge never received a tuple
            return self._zero_report(edge, stage)
        finishes = np.array([r.finished for r in st.reqs])
        in_times = np.concatenate(st.in_times)
        done = finishes >= 0
        lats = (finishes - in_times)[done]
        avg, p50, p95, p99 = _percentiles(lats)
        router = st.eng.router
        em = st.eng.metrics()
        return EdgeReport(
            edge=edge.name, src=edge.src, dst=edge.dst,
            scheme=edge.grouping.scheme, workers=stage.parallelism,
            n_tuples=st.n, execution_time=float(st.eng.now),
            latency_avg=avg, latency_p50=p50, latency_p95=p95,
            latency_p99=p99,
            throughput=st.eng.total_tokens / max(st.eng.now, 1.0),
            memory_overhead=router.memory_overhead(),
            memory_overhead_norm=router.memory_overhead_normalized(),
            imbalance=_imbalance(router.assigned_counts),
            remap_events=st.acct.per_event,
            remap_frac_mean=st.acct.frac_mean(),
            dropped=int(st.n - done.sum()),
            queue_depth_peak=em.queue_depth_peak,
            in_flight_peak=em.in_flight_peak,
            shed=em.shed,
            time_in_queue_avg=em.time_in_queue_avg,
            time_in_queue_p99=em.time_in_queue_p99,
            migration_stall=(st.biller.billed_total if st.biller else 0.0),
            **_state_extra(st.srep))

    def _apply_event(self, st, event, observer) -> None:
        eng = st.eng
        if isinstance(event, MembershipEvent):
            observer("pre_membership", eng.router, event)
            target = {int(w) for w in event.workers}
            for dead in [r for r in eng.alive if r not in target]:
                eng.fail_replica(dead)
            for new in sorted(target - set(eng.alive)):
                if new != eng.num_replicas:
                    raise ValueError(
                        f"serving engine cannot add replica {new}: replica "
                        f"ids are never reused and must extend the range "
                        f"contiguously (next id is {eng.num_replicas})")
                eng.add_replica(speed=1.0,
                                slots=self.engine.slots_per_replica)
            observer("post_membership", eng.router, event)
            if st.biller is not None:
                # tick-billed migration: the keyed state this
                # event shipped stalls its destination replicas — they
                # neither admit nor decode while ingesting it
                for wk, ticks in st.biller.pop_charges().items():
                    eng.stall_replica(wk, ticks)
        elif isinstance(event, CapacityEvent):
            for wk, cap in event.capacities.items():
                eng.set_replica_speed(int(wk), 1.0 / max(float(cap), 1e-9))
            observer("capacity", eng.router, event)
        else:  # pragma: no cover - ScopedEvent validates on construction
            raise TypeError(f"unknown event type {type(event).__name__}")
