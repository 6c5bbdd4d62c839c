"""Discrete-event DSPE simulator (paper §6.1 "Simulation Settings").

Models the paper's Fig. 1 DAG: sources emit a keyed tuple stream, a grouping
scheme assigns each tuple to a worker, each worker is a FIFO queue with a
processing capacity ``P_w`` (seconds per tuple — heterogeneous per paper
§4.2.3 / Fig. 7).  Reported metrics mirror the paper:

* ``execution_time``  — makespan = max_w(busy-until); the paper's simulated
  load-balance metric (Figs. 9/10: "execution time ... normalised to SG").
* ``latency_*``       — per-tuple queueing latency average / p50 / p95 / p99
  (Fig. 18's deployment metric).
* ``throughput``      — tuples / makespan (Fig. 19).
* ``memory_overhead`` — Σ_w distinct keys on w (Fig. 3/11/20), plus the
  FG-normalised form.
* ``imbalance``       — (max_w load − mean_w load) / mean_w load.

Three engines share the metric plumbing, unified behind
:func:`simulate_edge`: one grouped *edge* of a dataflow topology,
taking an optional explicit per-tuple arrival-time array (so successive
edges can feed the finish times of one stage into the FIFO queues of the
next) and returning per-tuple finish times alongside the metrics.

* ``mode="batched"`` — the stream is cut into event-free segments
  (membership/capacity events + capacity-sample points are the only cut
  sites), each segment is routed with one ``grouper.assign_batch`` call, and
  the per-worker FIFO recurrence ``f_j = max(f_{j-1}, t_j) + P_w`` is solved
  in closed form with ``np.maximum.accumulate`` — zero Python work per tuple.
* ``mode="reference"`` — the original per-tuple loop, kept as the oracle for
  the batched-vs-reference equivalence tests (exact for SG/FG/PKG, bounded
  drift for DC/WC/FISH — see DESIGN.md §6).
* ``mode="fused"`` — each event-free segment runs on the device as a few
  hand-written CUDA launches (routing + FIFO + keyed-state update, see
  :mod:`repro_torch.kernels.feed_fused`); ``device`` picks the card, and
  ``device="cpu"`` runs the kernels' plain PyTorch versions.

Multi-hop topologies go through :mod:`repro_torch.topology`.

Incremental (sessioned) execution — :func:`simulate_edge` accepts a
carried :class:`EdgeState` (per-worker ``busy_until``, mutated capacities,
active set, sampling rng, global tuple offset) so a topology session can cut
one logical stream into successive record-batch feeds without losing FIFO
backlog, capacity-sample pacing or straggler state between them.  Feeding
the whole stream as one call is bit-identical to the legacy one-shot path.
Events may be addressed by stream timestamp instead of tuple index via
:func:`at_time` (resolved to the first tuple whose arrival time is >= the
requested timestamp — the same segment cut the equivalent index event
produces).

Dynamic membership events (paper §5 / RQ4) are supported via
:class:`MembershipEvent`; mid-stream capacity changes (straggler onset /
recovery, heterogeneity shifts — Fig. 7) via :class:`CapacityEvent`.  Both
kinds are segment cut sites in the batched engine and may be mixed freely in
the ``events`` sequence.  Capacity sampling for FISH's estimator (Alg. 3) is
emulated with a periodic noisy sample of the true ``P_w`` — a straggler is
therefore *discovered* at the next sample point, not instantaneously.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from ..obs.trace import NULL_TRACER
from .baselines import Grouper

__all__ = [
    "CapacityEvent",
    "EdgeResult",
    "EdgeState",
    "MembershipEvent",
    "StreamMetrics",
    "at_time",
    "edge_metrics",
    "simulate_edge",
]


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """At tuple index ``at`` (or stream timestamp ``at_time``),
    switch the active worker set to ``workers``."""

    at: int = -1
    workers: Sequence[int] = ()
    at_time: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class CapacityEvent:
    """At tuple index ``at`` (or stream timestamp ``at_time``), set the
    *true* seconds-per-tuple of the listed workers (straggler onset when
    slower, recovery when restored)."""

    at: int = -1
    capacities: Mapping[int, float] = dataclasses.field(default_factory=dict)
    at_time: Optional[float] = None


def at_time(event, t: float):
    """Re-address a membership/capacity event by stream timestamp: the event
    fires at the first tuple whose arrival time is >= ``t`` — the same
    segment cut as the equivalent index-addressed event.  Timestamps that
    precede the (remaining) stream fire at its first tuple; timestamps past
    the end never fire (mirroring out-of-range indices)."""
    return dataclasses.replace(event, at_time=float(t))


def _resolve_at_time(events, times: Optional[np.ndarray],
                     arrival_rate: float):
    """Lower ``at_time`` addressing onto tuple indices for one stream chunk
    (``times=None`` means the uniform grid ``i / arrival_rate``)."""
    out = []
    for e in events:
        t = getattr(e, "at_time", None)
        if t is not None:
            if times is None:
                idx = int(np.ceil(t * arrival_rate))
            else:
                idx = int(np.searchsorted(times, t, side="left"))
            e = dataclasses.replace(e, at=idx, at_time=None)
        out.append(e)
    return out


@dataclasses.dataclass
class EdgeState:
    """Carried execution state of one grouped edge across successive feeds.  The grouper itself is stateful and carried by the
    caller; this holds everything :func:`simulate_edge` used to rebuild per
    call: per-worker FIFO backlog, the (event-mutated) true capacities, the
    live worker set, the capacity-sampling rng, and the global index of the
    next tuple (so ``sample_every`` pacing stays on the stream-global grid).
    """

    busy_until: np.ndarray
    capacities: np.ndarray
    active: set
    rng: np.random.Generator
    offset: int = 0
    #: fused-mode residency: a ``FusedEdgeRunner`` holding this edge's
    #: device-resident arrays across feeds, or the
    #: ``_FUSED_FALLBACK`` sentinel once the edge has dropped to batched
    device: object = None


@dataclasses.dataclass
class StreamMetrics:
    execution_time: float
    latency_avg: float
    latency_p50: float
    latency_p95: float
    latency_p99: float
    throughput: float
    memory_overhead: int
    memory_overhead_norm: float
    imbalance: float
    per_worker_busy: np.ndarray

    def row(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("per_worker_busy")
        return d


@dataclasses.dataclass
class EdgeResult:
    """One grouped edge's outcome: paper metrics + per-tuple finish times
    (the arrival times of the downstream stage's input stream).

    ``metrics`` is ``None`` when the call opted out via
    ``compute_metrics=False`` (sessions aggregate at close instead);
    ``latencies`` are the raw per-tuple queueing latencies of this call
    (``finishes - arrivals`` computed before the finish-time rounding, so
    sessions can aggregate cross-feed percentiles bit-identically);
    ``state`` is the carried :class:`EdgeState` — pass it back into the
    next :func:`simulate_edge` call to continue the same stream;
    ``dispatches`` counts host↔device launches this call made."""

    metrics: Optional[StreamMetrics]
    finishes: np.ndarray
    latencies: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0))
    state: Optional[EdgeState] = None
    dispatches: int = 0


# sentinel stored on EdgeState.device once a fused edge has fallen back to
# the batched engine — later feeds delegate silently (one warning per edge)
_FUSED_FALLBACK = object()


def _split_events(events, n: int):
    """Partition a mixed event sequence into (membership, capacity) lists
    sorted by tuple index.  Events outside [0, n) can never fire (there is
    no tuple at their index) and are dropped here — keeping them would
    stall the in-order event cursor and silently suppress later events."""
    for e in events:
        if not isinstance(e, (MembershipEvent, CapacityEvent)):
            raise TypeError(
                f"unknown event type {type(e).__name__!r}; expected "
                "MembershipEvent or CapacityEvent"
            )
    mem = sorted((e for e in events
                  if isinstance(e, MembershipEvent) and 0 <= e.at < n),
                 key=lambda e: e.at)
    cap = sorted((e for e in events
                  if isinstance(e, CapacityEvent) and 0 <= e.at < n),
                 key=lambda e: e.at)
    return mem, cap


def _apply_events(i, mem_ev, ev_idx, cap_ev, cap_idx, grouper, capacities,
                  active, event_observer):
    """Fire every event scheduled at tuple index ``i`` (shared by both
    engines).  Returns the advanced cursors and active set."""
    while ev_idx < len(mem_ev) and mem_ev[ev_idx].at == i:
        e = mem_ev[ev_idx]
        if event_observer is not None:
            event_observer("pre_membership", grouper, e)
        active = set(e.workers)
        grouper.on_membership_change(sorted(active))
        if event_observer is not None:
            event_observer("post_membership", grouper, e)
        ev_idx += 1
    while cap_idx < len(cap_ev) and cap_ev[cap_idx].at == i:
        e = cap_ev[cap_idx]
        for wk, cap in e.capacities.items():
            capacities[wk] = cap
        if event_observer is not None:
            event_observer("capacity", grouper, e)
        cap_idx += 1
    return ev_idx, cap_idx, active


def _event_hi_worker(mem_ev, cap_ev, hi_w: int) -> int:
    for e in mem_ev:
        if e.workers:
            hi_w = max(hi_w, max(e.workers))
    for e in cap_ev:
        if e.capacities:
            hi_w = max(hi_w, max(e.capacities))
    return hi_w


def _setup(grouper, capacities, arrival_rate, mem_ev, cap_ev, seed):
    """Fresh-edge preamble: capacities, initial samples, busy array sizing —
    bundled into the :class:`EdgeState` a session carries across feeds."""
    w = grouper.num_workers
    if capacities is None:
        # feasible utilisation ~0.9 across the initial worker set
        capacities = np.full(w, 0.9 * w / arrival_rate)
    capacities = np.asarray(capacities, dtype=np.float64).copy()

    # give capacity-aware groupers their initial (noisy) samples
    for wk in range(w):
        grouper.record_capacity_sample(wk, float(capacities[wk]))

    hi_w = _event_hi_worker(mem_ev, cap_ev, w - 1)
    busy_until = np.zeros(hi_w + 1, dtype=np.float64)
    if capacities.shape[0] < busy_until.shape[0]:
        pad = np.full(busy_until.shape[0] - capacities.shape[0],
                      capacities.mean())
        capacities = np.concatenate([capacities, pad])
    return EdgeState(busy_until=busy_until, capacities=capacities,
                     active=set(range(w)),
                     rng=np.random.default_rng(seed))


def _grow_state(state: EdgeState, mem_ev, cap_ev) -> None:
    """Extend a carried state's worker arrays when this feed's events name
    workers beyond the current range (scale-out in a later feed)."""
    hi_w = _event_hi_worker(mem_ev, cap_ev, state.busy_until.shape[0] - 1)
    need = hi_w + 1 - state.busy_until.shape[0]
    if need > 0:
        state.busy_until = np.concatenate(
            [state.busy_until, np.zeros(need, dtype=np.float64)])
        state.capacities = np.concatenate(
            [state.capacities, np.full(need, state.capacities.mean())])


def edge_metrics(grouper, busy_until, latencies, n) -> StreamMetrics:
    """The paper metrics for one grouped edge, computed from the grouper's
    cumulative counters, the final per-worker busy-until array and the
    per-tuple latencies (sessions call this at close over the concatenated
    feeds; one-shot calls get it per :func:`simulate_edge` call)."""
    makespan = float(busy_until.max()) if n else 0.0
    counts = grouper.assigned_counts[: len(busy_until)].astype(np.float64)
    imbalance = float((counts.max() - counts.mean()) / max(counts.mean(), 1e-12))
    return StreamMetrics(
        execution_time=makespan,
        latency_avg=float(latencies.mean()) if n else 0.0,
        latency_p50=float(np.percentile(latencies, 50)) if n else 0.0,
        latency_p95=float(np.percentile(latencies, 95)) if n else 0.0,
        latency_p99=float(np.percentile(latencies, 99)) if n else 0.0,
        throughput=n / makespan if makespan > 0 else 0.0,
        memory_overhead=grouper.memory_overhead(),
        memory_overhead_norm=grouper.memory_overhead_normalized(),
        imbalance=imbalance,
        per_worker_busy=busy_until.copy(),
    )


def _advance_fifo(busy_until: np.ndarray, workers: np.ndarray,
                  times: np.ndarray, capacities: np.ndarray,
                  latencies_out: np.ndarray) -> None:
    """Vectorised per-worker FIFO advance for one segment.

    For a worker with service time P and tuples at times t_0 <= t_1 <= ...,
    the FIFO recurrence ``f_j = max(f_{j-1}, t_j) + P`` (with ``f_{-1}`` the
    carried busy-until b0) unrolls to::

        f_j = (j + 1) P + max(b0, max_{k<=j}(t_k - k P))

    i.e. a single ``np.maximum.accumulate`` per worker.  Writes per-tuple
    latencies (finish - arrival) into ``latencies_out`` and updates
    ``busy_until`` in place.
    """
    order = np.argsort(workers, kind="stable")
    ws = workers[order]
    ts = times[order]
    finishes = np.empty_like(ts)
    seg_starts = np.concatenate(
        [[0], np.flatnonzero(ws[1:] != ws[:-1]) + 1]
    ) if ws.shape[0] else np.empty(0, dtype=np.int64)
    seg_ends = np.concatenate([seg_starts[1:], [ws.shape[0]]])
    for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
        wk = int(ws[s])
        cap = capacities[wk]
        tt = ts[s:e]
        j = np.arange(e - s, dtype=np.float64)
        m = np.maximum.accumulate(tt - j * cap)
        f = (j + 1.0) * cap + np.maximum(busy_until[wk], m)
        finishes[s:e] = f
        busy_until[wk] = f[-1]
    latencies_out[order] = finishes - ts


def simulate_edge(
    grouper: Grouper,
    keys: Sequence,
    *,
    times: Optional[np.ndarray] = None,
    mode: str = "batched",
    capacities: Optional[np.ndarray] = None,
    arrival_rate: float = 10_000.0,
    sample_every: int = 5_000,
    sample_noise: float = 0.02,
    events: Sequence[object] = (),
    seed: int = 0,
    event_observer: Optional[Callable[[str, Grouper, object], None]] = None,
    tuple_observer: Optional[Callable[..., None]] = None,
    state_sink: Optional[object] = None,
    values: Optional[np.ndarray] = None,
    state: Optional[EdgeState] = None,
    dt: Optional[float] = None,
    compute_metrics: bool = True,
    migration_biller: Optional[object] = None,
    telemetry: Optional[object] = None,
    device=None,
) -> EdgeResult:
    """Run one grouped edge: route ``keys`` through ``grouper`` and advance
    the destination stage's per-worker FIFO queues.

    times:        optional per-tuple arrival times (nondecreasing).  ``None``
                  means a uniform source at ``arrival_rate`` (tuple ``i``
                  arrives at ``i / arrival_rate``).  A topology engine passes
                  the *finish* times of the upstream stage here, which is how
                  a stream propagates through successive grouped edges.
    mode:         "batched" (segment-wise closed-form FIFO),
                  "reference" (the per-tuple oracle interpreter), or
                  "fused" (a few device launches per segment — routing +
                  FIFO + keyed-state update; device state carried on
                  ``EdgeState.device`` across feeds.  Falls back to batched
                  with a :class:`UserWarning` when the feed is outside the
                  fused envelope — see ``repro_torch.kernels.feed_fused.
                  fused_reject_reason``).
    capacities:   true seconds/tuple per worker (default: all 1/arrival_rate
                  scaled so ~W tuples are in flight — i.e. balanced feasible).
                  Ignored when ``state`` is carried (its capacities rule).
    sample_every: period (in tuples) of the Alg.-3 capacity sampling hook,
                  counted on the stream-global grid (``state.offset`` aware).
    events:       mixed :class:`MembershipEvent` / :class:`CapacityEvent`
                  sequence; ``at`` indexes this call's input chunk and is a
                  segment cut site in the batched mode.  Events addressed via
                  :func:`at_time` are resolved against ``times`` (or the
                  uniform grid) before splitting.
    event_observer: optional ``f(kind, grouper, event)`` callback fired with
                  kind "pre_membership"/"post_membership" around membership
                  changes and "capacity" after a capacity change — the
                  remap-accounting hook.
    tuple_observer: optional ``f(keys, workers, values)`` callback fed the
                  routed chunks of the stream in order (each tuple exactly
                  once, interleaved correctly with the event hooks) — the
                  keyed operator-state hook (:mod:`repro_torch.state`).  ``values``
                  is the matching payload slice, or ``None`` when the stream
                  carries no payload column.  In batched mode it fires once
                  per segment; in reference mode the per-tuple assignments
                  are buffered and flushed before each event and at stream
                  end.  Fused mode rejects it (keyed state flows through
                  ``state_sink`` there) and falls back to batched.
    state_sink:   fused-mode keyed-state consumer — a
                  :class:`repro_torch.state.window.KeyedStateManager` (or
                  anything with ``op``/``idx``/``feed_aggregated``).  The
                  fused engine aggregates (key, worker) pane contributions
                  on device and syncs them at pane boundaries and events
                  via ``feed_aggregated`` instead of streaming every
                  routed chunk through ``tuple_observer``.  Only valid
                  with ``mode="fused"``.
    values:       optional per-tuple float64 payload column — routed alongside the keys and handed to
                  the tuple observer; it does not affect routing or timing.
    state:        carried :class:`EdgeState` from this edge's previous feed
                  (sessions).  ``None`` starts a fresh edge; the (fresh or
                  carried) state is returned on :attr:`EdgeResult.state`.
                  Continuing a stream requires explicit ``times`` — with
                  ``times=None`` arrivals would restart at 0 against a
                  carried absolute-time backlog, so that is rejected.
    dt:           explicit estimator-tick pacing (seconds/tuple) handed to
                  the grouper.  Default: ``1/arrival_rate``, or the mean
                  spacing of ``times`` when given.  Sessions pin the source
                  edge to ``1/arrival_rate`` so cutting a uniform stream
                  into feeds keeps epoch pacing bit-identical.
    compute_metrics: set False to skip the per-call :class:`StreamMetrics`
                  (``EdgeResult.metrics`` is then ``None``) — sessions
                  aggregate latencies across feeds and compute metrics
                  once at close, so per-feed percentile passes are waste.
    migration_biller: optional :class:`repro_torch.state.migration.MigrationBiller`: after each membership event its pending
                  per-worker charges — engine-clock stall from migrated
                  keyed state — are popped and added to the destination
                  workers' busy time at the event's stream position, so
                  scale-out's state transfer competes with serving
                  bandwidth.  Chain its ``on_event`` after the keyed-state
                  manager's in ``event_observer`` so it sees each event's
                  migration bill.
    telemetry:    optional :class:`repro_torch.obs.Telemetry` bundle.
                  Only the fused engine consumes it here — the
                  :class:`~repro_torch.kernels.feed_fused.FusedEdgeRunner` mints
                  its dispatch/pane/sync counters from it and emits launch
                  spans + FISH epoch timeline points when enabled.  The
                  host engines are instrumented at the session layer
                  instead (per-feed spans around :func:`simulate_edge`).
    device:       the fused engine's torch device: ``None`` means ``"cuda"``
                  (raises without a card), ``"cpu"`` runs every kernel's
                  plain PyTorch version.  Ignored by the host engines.

    ``keys`` must be a 1-D integer array of interned key ids for the batched
    mode (``repro_torch.data.synthetic`` generators emit int32); anything else
    falls back to the reference interpreter with a :class:`UserWarning`
    (a 10-20x slowdown that should never be silent).
    """
    if mode not in ("batched", "reference", "fused"):
        raise ValueError(
            f"unknown mode {mode!r}; 'batched', 'reference' or 'fused'")
    if state_sink is not None and mode != "fused":
        raise ValueError(
            "state_sink is the fused engine's keyed-state channel; "
            "batched/reference modes stream state via tuple_observer")
    if state_sink is not None and tuple_observer is not None:
        raise ValueError("pass state_sink or tuple_observer, not both")
    if times is not None:
        times = np.asarray(times, dtype=np.float64)
        if times.shape[0] != len(keys):
            raise ValueError(
                f"times has {times.shape[0]} entries for {len(keys)} keys")
    if values is not None:
        values = np.asarray(values, dtype=np.float64)
        if values.shape[0] != len(keys):
            raise ValueError(
                f"values has {values.shape[0]} entries for {len(keys)} keys")
    if state is not None and state.offset > 0 and times is None:
        raise ValueError(
            "continuing a carried EdgeState requires explicit times: with "
            "times=None arrivals restart at 0 while busy_until carries the "
            "previous feeds' absolute finish times — pass the stream's "
            "real timestamps")
    events = _resolve_at_time(events, times, arrival_rate)
    if mode == "fused":
        keys_arr = np.asarray(keys)
        int_keys = keys_arr.ndim == 1 and keys_arr.dtype.kind in "iu"
        obs = state_sink.feed if state_sink is not None else tuple_observer
        dev = state.device if state is not None else None
        if dev is _FUSED_FALLBACK:  # this edge already dropped to batched
            if int_keys:
                return _edge_batched(
                    grouper, keys_arr, times, capacities, arrival_rate,
                    sample_every, sample_noise, events, seed,
                    event_observer, obs, values, state, dt, compute_metrics,
                    migration_biller)
            return _edge_reference(
                grouper, keys, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                obs, values, state, compute_metrics, migration_biller)
        from ..kernels.feed_fused import fused_reject_reason

        if not int_keys:
            reason = (f"keys dtype={keys_arr.dtype} shape={keys_arr.shape}"
                      " is not a 1-D integer array")
        else:
            reason = fused_reject_reason(grouper, keys_arr, values,
                                         state_sink, tuple_observer)
        if reason is None:
            return _edge_fused(
                grouper, keys_arr, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                state_sink, values, state, dt, compute_metrics,
                migration_biller, telemetry, device)
        warnings.warn(
            f"simulate_edge falling back to the batched engine: {reason}",
            UserWarning, stacklevel=2)
        if dev is not None:  # mid-session: sync device state out first
            if state_sink is not None:
                dev.flush_pane(state_sink)
            dev.host_sync(grouper)
        if state is not None:
            state.device = _FUSED_FALLBACK
        if int_keys:
            res = _edge_batched(
                grouper, keys_arr, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                obs, values, state, dt, compute_metrics, migration_biller)
        else:
            res = _edge_reference(
                grouper, keys, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                obs, values, state, compute_metrics, migration_biller)
        res.state.device = _FUSED_FALLBACK
        return res
    if mode == "batched":
        keys_arr = np.asarray(keys)
        if keys_arr.ndim == 1 and keys_arr.dtype.kind in "iu":
            return _edge_batched(
                grouper, keys_arr, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                tuple_observer, values, state, dt, compute_metrics,
                migration_biller)
        warnings.warn(
            f"simulate_edge falling back to the per-tuple reference "
            f"interpreter: keys dtype={keys_arr.dtype} shape="
            f"{keys_arr.shape} is not a 1-D integer array (a 10-20x "
            f"slowdown; intern keys via repro_torch.data.synthetic.intern_keys "
            f"to stay on the batched path)",
            UserWarning, stacklevel=2)
    return _edge_reference(
        grouper, keys, times, capacities, arrival_rate,
        sample_every, sample_noise, events, seed, event_observer,
        tuple_observer, values, state, compute_metrics, migration_biller)


def _apply_migration_stall(migration_biller, busy_until) -> None:
    """Add a membership event's pending migration charges to the destination
    workers' busy time (tick-billed migration)."""
    for wk, stall in migration_biller.pop_charges().items():
        busy_until[wk] += stall


def _edge_batched(grouper, keys_arr, times, capacities, arrival_rate,
                  sample_every, sample_noise, events, seed,
                  event_observer, tuple_observer=None, values=None,
                  state=None, dt=None, compute_metrics=True,
                  migration_biller=None) -> EdgeResult:
    n = keys_arr.shape[0]
    mem_ev, cap_ev = _split_events(events, n)
    if state is None:
        state = _setup(grouper, capacities, arrival_rate, mem_ev, cap_ev,
                       seed)
    else:
        _grow_state(state, mem_ev, cap_ev)
    busy_until = state.busy_until
    capacities = state.capacities
    rng = state.rng
    off = state.offset

    if dt is None:
        dt = 1.0 / arrival_rate
        if times is not None and n > 1:
            # mean spacing of this chunk — FISH's estimator-tick pacing
            dt = float((times[-1] - times[0]) / (n - 1)) or dt
    latencies = np.empty(n, dtype=np.float64)
    active = state.active

    # segment cut sites: membership/capacity events + capacity-sample points
    # (sample points sit on the stream-global grid: offset-aware)
    cuts = {0, n}
    cuts.update(e.at for e in mem_ev)
    cuts.update(e.at for e in cap_ev)
    if sample_every:
        first = (-off) % sample_every or sample_every
        cuts.update(range(first, n, sample_every))
    bounds = sorted(cuts)
    ev_idx = 0
    cap_idx = 0

    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ev_idx, cap_idx, active = _apply_events(
            lo, mem_ev, ev_idx, cap_ev, cap_idx, grouper, capacities,
            active, event_observer)
        if migration_biller is not None:
            _apply_migration_stall(migration_biller, busy_until)
        if times is None:
            seg_times = np.arange(lo, hi, dtype=np.float64) * dt
            now0 = lo * dt
        else:
            seg_times = times[lo:hi]
            now0 = float(seg_times[0])
        seg_workers = grouper.assign_batch(keys_arr[lo:hi], now0, dt)
        if tuple_observer is not None:
            tuple_observer(keys_arr[lo:hi], seg_workers,
                           None if values is None else values[lo:hi])
        _advance_fifo(busy_until, seg_workers, seg_times, capacities,
                      latencies[lo:hi])
        if sample_every and (off + hi) % sample_every == 0:
            for wk in sorted(active):
                noisy = capacities[wk] * (1.0 + rng.normal(0.0, sample_noise))
                grouper.record_capacity_sample(wk, float(max(noisy, 1e-12)))

    state.active = active
    state.offset = off + n
    all_times = (np.arange(n, dtype=np.float64) * dt if times is None
                 else times)
    metrics = (edge_metrics(grouper, busy_until, latencies, n)
               if compute_metrics else None)
    return EdgeResult(metrics, all_times + latencies, latencies, state)


def _edge_fused(grouper, keys_arr, times, capacities, arrival_rate,
                sample_every, sample_noise, events, seed, event_observer,
                state_sink=None, values=None, state=None, dt=None,
                compute_metrics=True, migration_biller=None,
                telemetry=None, device=None) -> EdgeResult:
    """Fused engine: one device segment (a few kernel launches) per
    event-free segment.  Cut sites are only events and operator pane boundaries —
    capacity-sample points are *not* cuts (the sample snapshots are taken
    from the host-authoritative capacities after the covering segment,
    preserving the batched engine's exact rng draw sequence), so a
    steady-state feed with aligned panes is a single dispatch.  The whole
    call is the span ``edge.fused``."""
    from ..kernels.feed_fused import FusedEdgeRunner

    n = keys_arr.shape[0]
    tracer = telemetry.tracer if telemetry is not None else NULL_TRACER
    edge_span = tracer.span("edge.fused", cat="edge", n=n)
    mem_ev, cap_ev = _split_events(events, n)
    if state is None:
        state = _setup(grouper, capacities, arrival_rate, mem_ev, cap_ev,
                       seed)
    else:
        _grow_state(state, mem_ev, cap_ev)
    capacities = state.capacities
    rng = state.rng
    off = state.offset

    runner = state.device
    if runner is None:
        runner = FusedEdgeRunner(grouper, state, state_sink,
                                 telemetry=telemetry, device=device)
        state.device = runner

    if dt is None:
        dt = 1.0 / arrival_rate
        if times is not None and n > 1:
            dt = float((times[-1] - times[0]) / (n - 1)) or dt
    if times is None:
        times = np.arange(n, dtype=np.float64) * dt
    latencies = np.empty(n, dtype=np.float64)
    finishes = np.empty(n, dtype=np.float64)
    active = state.active

    # segment cut sites: events + pane boundaries.  The pane grid is
    # global: tuples already synced to the sink plus the open device pane.
    cuts = {0, n}
    cuts.update(e.at for e in mem_ev)
    cuts.update(e.at for e in cap_ev)
    stride = 0
    gbase = 0
    if state_sink is not None:
        stride = state_sink.op.stride
        gbase = state_sink.idx + runner.pane_fed
        first = (-gbase) % stride or stride
        cuts.update(range(first, n, stride))
    bounds = sorted(cuts)
    ev_idx = 0
    cap_idx = 0

    runner.begin_feed(grouper, state, keys_arr, values, times, state_sink)

    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if stride and (gbase + lo) % stride == 0:
            runner.flush_pane(state_sink)
        due = ((ev_idx < len(mem_ev) and mem_ev[ev_idx].at == lo)
               or (cap_idx < len(cap_ev) and cap_ev[cap_idx].at == lo))
        if due:
            # the sink must see every pre-event tuple and the grouper its
            # replicas before the event handler reshapes the worker set
            runner.flush_pane(state_sink)
            runner.host_sync(grouper)
            mem0 = ev_idx
            ev_idx, cap_idx, active = _apply_events(
                lo, mem_ev, ev_idx, cap_ev, cap_idx, grouper, capacities,
                active, event_observer)
            if migration_biller is not None:
                # busy_until is host-authoritative here (host_sync above;
                # run_segment re-uploads it), so billing lands on device
                _apply_migration_stall(migration_biller, state.busy_until)
            state.active = active
            if ev_idx > mem0:
                runner.refresh_membership(grouper, state)
        fin = runner.run_segment(grouper, state, lo, hi)
        finishes[lo:hi] = fin
        latencies[lo:hi] = fin - times[lo:hi]
        if sample_every:
            # sample points crossed by this segment (global grid); the
            # capacities/active set are constant inside a segment, so the
            # snapshot equals the batched engine's — same rng sequence
            k0 = (off + lo) // sample_every + 1
            k1 = (off + hi) // sample_every
            for _k in range(k0, k1 + 1):
                for wk in sorted(active):
                    noisy = capacities[wk] * (
                        1.0 + rng.normal(0.0, sample_noise))
                    grouper.record_capacity_sample(
                        wk, float(max(noisy, 1e-12)))

    if stride and (gbase + n) % stride == 0:
        runner.flush_pane(state_sink)  # feed ends on a pane boundary
    state.active = active
    state.offset = off + n
    metrics = None
    if compute_metrics:
        runner.host_sync(grouper)
        metrics = edge_metrics(grouper, state.busy_until, latencies, n)
    edge_span.done()
    return EdgeResult(metrics, finishes, latencies, state,
                      dispatches=runner.dispatches)


def _edge_reference(grouper, keys, times, capacities, arrival_rate,
                    sample_every, sample_noise, events, seed,
                    event_observer, tuple_observer=None, values=None,
                    state=None, compute_metrics=True,
                    migration_biller=None) -> EdgeResult:
    n = len(keys)
    mem_ev, cap_ev = _split_events(events, n)
    if state is None:
        state = _setup(grouper, capacities, arrival_rate, mem_ev, cap_ev,
                       seed)
    else:
        _grow_state(state, mem_ev, cap_ev)
    busy_until = state.busy_until
    capacities = state.capacities
    rng = state.rng
    off = state.offset

    dt = 1.0 / arrival_rate
    latencies = np.empty(n, dtype=np.float64)
    finishes = np.empty(n, dtype=np.float64)
    ev_idx = 0
    cap_idx = 0
    active = state.active

    # per-tuple assignments are buffered and flushed to the tuple observer
    # before any event fires, preserving the batched mode's interleaving
    buf_k: list = []
    buf_w: list = []
    buf_v: list = []

    def _flush_tuples() -> None:
        if buf_k and tuple_observer is not None:
            tuple_observer(np.asarray(buf_k),
                           np.asarray(buf_w, dtype=np.int64),
                           np.asarray(buf_v, dtype=np.float64)
                           if values is not None else None)
            buf_k.clear()
            buf_w.clear()
            buf_v.clear()

    for i, key in enumerate(keys):
        if tuple_observer is not None and (
                (ev_idx < len(mem_ev) and mem_ev[ev_idx].at == i)
                or (cap_idx < len(cap_ev) and cap_ev[cap_idx].at == i)):
            _flush_tuples()
        ev_idx, cap_idx, active = _apply_events(
            i, mem_ev, ev_idx, cap_ev, cap_idx, grouper, capacities,
            active, event_observer)
        if migration_biller is not None:
            _apply_migration_stall(migration_biller, busy_until)
        now = i * dt if times is None else float(times[i])
        worker = grouper.assign(key, now)
        if tuple_observer is not None:
            buf_k.append(key)
            buf_w.append(worker)
            if values is not None:
                buf_v.append(float(values[i]))
        start = max(busy_until[worker], now)
        finish = start + capacities[worker]
        busy_until[worker] = finish
        latencies[i] = finish - now
        finishes[i] = finish
        if sample_every and (off + i + 1) % sample_every == 0:
            for wk in sorted(active):
                noisy = capacities[wk] * (1.0 + rng.normal(0.0, sample_noise))
                grouper.record_capacity_sample(wk, float(max(noisy, 1e-12)))

    _flush_tuples()
    state.active = active
    state.offset = off + n
    metrics = (edge_metrics(grouper, busy_until, latencies, n)
               if compute_metrics else None)
    return EdgeResult(metrics, finishes, latencies, state)
