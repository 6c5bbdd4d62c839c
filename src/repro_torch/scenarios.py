"""Declarative time-evolving scenario subsystem.

The paper's whole argument is behavior under *time-evolving* conditions
(§5, RQ4, Figs. 7/17): hot-key drift, heterogeneous/straggling workers, and
elastic membership.  A :class:`Scenario` composes those three orthogonal
axes declaratively:

* **workload** — the key distribution over time (:class:`WorkloadSpec`):
  the §6.1 ZF hot-key flip or piecewise-Zipf hot-set drift.
* **capacity** — static heterogeneity (Fig. 7 fast/slow worker mix) plus a
  straggler onset/recovery episode (:class:`CapacitySpec`).
* **churn** — membership ops over the stream (:class:`ChurnOp`):
  scale-out/in and failures.

A scenario compiles to a single-edge :class:`~repro_torch.topology.Topology`
plus :class:`~repro_torch.topology.ScopedEvent` records and runs through the
unified engine protocol: :func:`run_dspe_scenario` drives
:class:`~repro_torch.topology.SimulatorEngine` (batched or per-tuple reference
mode) and returns the flattened :class:`~repro_torch.topology.EdgeReport` row;
:func:`run_serving_scenario` drives the continuous-batching
:class:`~repro_torch.serving.engine.ServingEngine` with the full runtime control
plane in the loop: failures are *detected* by
:class:`~repro_torch.runtime.fault.HeartbeatMonitor`, adjudicated by
:class:`~repro_torch.runtime.fault.RestartPolicy` (elastic-continue vs restart),
remap cost is accounted by :class:`~repro_torch.runtime.elastic.ElasticPool`,
and stragglers are observed by
:class:`~repro_torch.runtime.stragglers.StragglerMitigator`.

``benchmarks/bench_scenarios.py`` runs every grouping scheme through the
default scenario suite and emits ``artifacts/BENCH_scenarios.json``
(RQ4/Fig. 17 analogues: latency, throughput, memory overhead, and tuples
remapped per membership event).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import CapacityEvent, MembershipEvent
from .data.synthetic import piecewise_zipf, zipf_time_evolving
from .load import (ArrivalProcess, ConstantRate, DiurnalRate, FlashCrowd,
                   FlipZipfKeys, IngressQueue, OpenLoopDriver, P99Autoscaler,
                   ZipfKeys)
from .runtime.elastic import ElasticPool
from .runtime.fault import HeartbeatMonitor, RestartPolicy
from .runtime.stragglers import StragglerMitigator
from .serving.engine import Request, ServingEngine
from .state import KeyedStateManager, WindowOp, direct_aggregate
from .topology import (Edge, EdgeReport, RemapAccountant, ScopedEvent,
                       ServingTopologyEngine, SimulatorEngine, Source, Stage,
                       Topology, config_for)
from .topology.engine import _imbalance, _percentiles

__all__ = [
    "WorkloadSpec",
    "StragglerSpec",
    "CapacitySpec",
    "ChurnOp",
    "Scenario",
    "OpenLoopScenario",
    "RemapAccountant",  # re-exported from repro_torch.topology.engine
    "build_keys",
    "compile_events",
    "base_capacities",
    "scenario_topology",
    "open_loop_topology",
    "run_dspe_scenario",
    "run_serving_scenario",
    "run_open_loop_scenario",
    "default_scenarios",
    "default_open_loop_scenarios",
]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Key distribution over time.  ``zf_flip`` is the paper's §6.1 ZF
    generator (hot head flips at 0.8·N); ``piecewise`` rotates the hot set
    every N/phases tuples (the MemeTracker/Amazon-Movie proxy)."""

    kind: str = "zf_flip"  # "zf_flip" | "piecewise"
    num_tuples: int = 24_000
    num_keys: int = 2_400
    z: float = 1.2
    phases: int = 6  # piecewise only
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """One worker slows down by ``slowdown``× at ``onset`` (stream fraction)
    and recovers at ``recovery``; ``recovery >= 1.0`` never recovers."""

    worker: int = 0
    onset: float = 0.3
    recovery: float = 0.7
    slowdown: float = 4.0


@dataclasses.dataclass(frozen=True)
class CapacitySpec:
    """``hetero`` lists relative worker speeds, cycled over the worker set
    (paper Fig. 7 fast/slow mix); empty means homogeneous."""

    hetero: Tuple[float, ...] = ()
    straggler: Optional[StragglerSpec] = None


@dataclasses.dataclass(frozen=True)
class ChurnOp:
    """Membership op at stream fraction ``at``: ``remove`` (failure /
    scale-in) or ``add`` (scale-out) of ``worker``."""

    at: float
    op: str  # "remove" | "add"
    worker: int


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    workers: int = 8
    arrival_rate: float = 20_000.0
    utilization: float = 0.9
    workload: WorkloadSpec = WorkloadSpec()
    capacity: CapacitySpec = CapacitySpec()
    churn: Tuple[ChurnOp, ...] = ()


# ---------------------------------------------------------------------------
# compilation: scenario -> (keys, events, capacities)
# ---------------------------------------------------------------------------


def build_keys(w: WorkloadSpec) -> np.ndarray:
    if w.kind == "zf_flip":
        return zipf_time_evolving(w.num_tuples, num_keys=w.num_keys, z=w.z,
                                  flip_head=max(w.num_keys // 3, 1),
                                  seed=w.seed)
    if w.kind == "piecewise":
        return piecewise_zipf(w.num_tuples, w.num_keys, z=w.z,
                              phases=w.phases, seed=w.seed)
    raise ValueError(f"unknown workload kind {w.kind!r}")


def relative_speeds(s: Scenario) -> np.ndarray:
    rel = np.ones(s.workers)
    if s.capacity.hetero:
        pat = np.asarray(s.capacity.hetero, dtype=np.float64)
        rel = pat[np.arange(s.workers) % pat.shape[0]]
    return rel


def base_capacities(s: Scenario) -> np.ndarray:
    """True seconds/tuple per worker such that aggregate utilisation is
    ``s.utilization`` at ``s.arrival_rate`` (matches the simulator's
    homogeneous convention ``0.9·W/λ`` when ``hetero`` is empty)."""
    rel = relative_speeds(s)
    return s.utilization * float(rel.sum()) / (s.arrival_rate * rel)


def compile_events(s: Scenario, n: int) -> List[object]:
    """Lower churn + straggler specs onto tuple-index event records."""
    caps0 = base_capacities(s)
    mean_cap = float(caps0.mean())
    events: List[object] = []
    live = set(range(s.workers))
    for op in sorted(s.churn, key=lambda o: o.at):
        at = int(op.at * n)
        if op.op == "remove":
            live.discard(op.worker)
        elif op.op == "add":
            live.add(op.worker)
            # newcomers get the mean base capacity unless a straggler spec
            # or later CapacityEvent says otherwise
            events.append(CapacityEvent(at=at,
                                        capacities={op.worker: mean_cap}))
        else:
            raise ValueError(f"unknown churn op {op.op!r}")
        events.append(MembershipEvent(at=at, workers=tuple(sorted(live))))
    st = s.capacity.straggler
    if st is not None:
        base = float(caps0[st.worker]) if st.worker < s.workers else mean_cap
        events.append(CapacityEvent(at=int(st.onset * n),
                                    capacities={st.worker: base * st.slowdown}))
        if st.recovery < 1.0:
            events.append(CapacityEvent(at=int(st.recovery * n),
                                        capacities={st.worker: base}))
    return events


# ---------------------------------------------------------------------------
# runners (through the unified topology engine protocol)
# ---------------------------------------------------------------------------

_STAGE = "worker"  # the single-hop scenario stage name


def scenario_topology(scenario: Scenario, scheme: str,
                      window: Optional[WindowOp] = None) -> Topology:
    """The scenario as a one-edge topology: source → grouped worker pool
    with the scenario's heterogeneous base capacities.  ``window`` attaches
    a keyed windowed aggregation to the worker stage: churn then
    exercises the state-migration protocol and the runner reports its cost
    and post-merge exactness."""
    return Topology(
        name=scenario.name,
        stages=(Stage(_STAGE, parallelism=scenario.workers,
                      capacities=tuple(base_capacities(scenario)),
                      operator=window),),
        edges=(Edge("source", _STAGE, config_for(scheme)),),
    )


def _state_row(summary: Dict, oracle: Dict) -> Dict:
    """Flatten a per-stage state summary + exactness vs the routing-free
    oracle into the scenario-report shape."""
    return {
        "migration_bytes": summary["migration_bytes"],
        "migration_events": summary["migration_events"],
        "tuples_replayed": summary["tuples_replayed"],
        "state_bytes_peak": summary["state_bytes_peak"],
        "partial_entries": summary["partial_entries"],
        "windows": summary["windows"],
        "exact": summary["merged"] == oracle,
    }


def run_dspe_scenario(
    scenario: Scenario,
    scheme: str,
    engine: str = "batched",
    sample_remap: int = 512,
    window: Optional[WindowOp] = None,
    feeds: int = 1,
    device=None,
) -> Dict:
    """Route the scenario's stream through ``scheme`` in the DSPE simulator
    and return the paper metrics plus per-event remap accounting.  With a
    ``window``, the worker stage runs the keyed aggregation and the report
    gains a ``state`` row: migration cost + post-merge exactness against
    the no-churn oracle (:func:`repro_torch.state.direct_aggregate`).

    ``feeds`` > 1 replays the scenario through the streaming session API:
    the stream is cut into that many record batches fed
    incrementally, with all churn/straggler events registered up front —
    the long-running-DSPE execution mode (``feeds=1`` is the one-shot
    ``run()``, bit-identical to feeding a single batch).

    ``device`` is the torch device of the fused runner and of a device
    store (``None``: ``cuda``); ``batched`` and ``reference`` with a host
    store never touch it."""
    keys = build_keys(scenario.workload)
    n = int(keys.shape[0])
    events = [ScopedEvent(_STAGE, e) for e in compile_events(scenario, n)]
    sim = SimulatorEngine(mode=engine, remap_sample=sample_remap,
                          device=device)
    topo = scenario_topology(scenario, scheme, window)
    source = Source(keys, arrival_rate=scenario.arrival_rate)
    if feeds <= 1:
        rep = sim.run(topo, source, events)
    else:
        session = sim.open(topo, arrival_rate=scenario.arrival_rate)
        session.advance(events)
        for batch in source.iter_batches(batch_size=-(-n // feeds)):
            session.feed(batch)
        rep = session.close()
    er = rep.edge(_STAGE)
    out = {"scheme": scheme, "engine": engine, "n_tuples": n,
           "feeds": feeds}
    out.update(er.row())
    out["remap_events"] = er.remap_events
    out["remap_frac_mean"] = er.remap_frac_mean
    if window is not None:
        out["state"] = _state_row(rep.state[_STAGE],
                                  direct_aggregate(keys, window))
    return out


def run_serving_scenario(
    scenario: Scenario,
    scheme: str,
    num_requests: int = 160,
    slots_per_replica: int = 4,
    heartbeat_timeout: float = 3.0,
    max_ticks: int = 50_000,
    seed: int = 0,
    window: Optional[WindowOp] = None,
) -> Dict:
    """Drive the ServingEngine through the scenario with the runtime control
    plane in the loop.

    Requests carry session keys drawn from the scenario workload (so session
    popularity is time-evolving).  Churn ``remove`` ops silence a replica's
    heartbeat: the HeartbeatMonitor declares it dead, the RestartPolicy
    chooses elastic-continue, and ``ServingEngine.fail_replica`` requeues the
    orphans; the ElasticPool accounts session remap cost.  ``add`` ops scale
    the engine out.  A straggler episode changes the replica's true speed
    mid-run; the StragglerMitigator must finger it from speed samples alone.

    With a ``window``, per-replica keyed session state is
    maintained alongside the engine: each request folds into its session's
    window entry on the replica it was routed to, replica failure/scale-out
    runs the state-migration protocol, and the report gains a ``state`` row
    (migration cost + post-merge exactness vs the routing-free oracle).
    """
    rng = np.random.default_rng(seed)
    keys = build_keys(scenario.workload)
    sessions = keys[np.linspace(0, keys.shape[0] - 1, num_requests)
                    .astype(np.int64)]
    rel = relative_speeds(scenario)

    # the scheme name (not config_for(scheme)) keeps the engine's serving
    # default of a 4-tick FISH estimator interval
    eng = ServingEngine(scenario.workers,
                        slots_per_replica=slots_per_replica,
                        tokens_per_tick=rel, grouping=scheme)
    pool = ElasticPool(range(scenario.workers))
    mon = HeartbeatMonitor(range(scenario.workers),
                           timeout=heartbeat_timeout)
    mit = StragglerMitigator(scenario.workers, interval=4.0)
    for r in range(scenario.workers):
        mit.record_step_time(r, 1.0 / rel[r])

    stats = {"rerouted": 0, "remap_fracs": [], "policy_outcomes": [],
             "straggler_detected": False}
    sample_sessions = [int(k) for k in np.unique(sessions)]
    mgr = KeyedStateManager(window) if window is not None else None
    fed_keys: List[int] = []  # oracle input: sessions actually submitted

    def on_rescale(alive: List[int]) -> None:
        for dead in [r for r in eng.alive if r not in alive]:
            if mgr is not None:
                mgr.on_event("pre_membership", eng.router, None)
            stats["rerouted"] += eng.fail_replica(dead)
            if mgr is not None:
                mgr.on_event("post_membership", eng.router, None)
            if dead in pool.ring:
                moved = pool.remove_host(dead, sample_sessions)
                stats["remap_fracs"].append(moved / max(len(sample_sessions), 1))

    policy = RestartPolicy(total_hosts=scenario.workers,
                           max_lost_frac=0.49, on_rescale=on_rescale)

    # request arrivals spread over ~60% of the nominal decode horizon
    tokens = rng.integers(4, 12, num_requests)
    horizon = max(int(1.7 * tokens.sum() / max(rel.sum(), 1e-9)), num_requests)
    arrive_at = np.linspace(0, int(0.6 * horizon), num_requests).astype(int)
    reqs = [Request(i, int(s), arrival=float(a), target_tokens=int(t))
            for i, (s, a, t) in enumerate(zip(sessions, arrive_at, tokens))]

    silenced: set = set()
    prev_routed = eng.router.assigned_counts.copy()
    pending_ops = sorted(
        [(int(op.at * 0.6 * horizon), op) for op in scenario.churn],
        key=lambda x: x[0])
    st = scenario.capacity.straggler
    straggle_at = int(st.onset * 0.6 * horizon) if st else None
    recover_at = (int(st.recovery * 0.6 * horizon)
                  if st and st.recovery < 1.0 else None)

    next_req = 0
    t = 0
    while len(eng.done) < num_requests and t < max_ticks:
        now = eng.now
        while next_req < num_requests and arrive_at[next_req] <= t:
            eng.submit(reqs[next_req])
            if mgr is not None:  # fold into keyed state exactly once
                mgr.feed(sessions[next_req:next_req + 1],
                         np.array([reqs[next_req].replica]))
                fed_keys.append(int(sessions[next_req]))
            next_req += 1
        while pending_ops and pending_ops[0][0] <= t:
            _, op = pending_ops.pop(0)
            if op.op == "remove":
                # crash: decodes nothing from now on and goes silent; the
                # router keeps black-holing requests at it until the
                # heartbeat monitor notices and fail_replica requeues them
                silenced.add(op.worker)
                eng.speeds[op.worker] = 0.0
            elif op.op == "add":
                if mgr is not None:
                    mgr.on_event("pre_membership", eng.router, None)
                r = eng.add_replica(speed=1.0, slots=slots_per_replica)
                if mgr is not None:
                    mgr.on_event("post_membership", eng.router, None)
                policy.total = eng.num_replicas
                mon.heartbeat(r, now)
                pool.add_host(r, sample_sessions)
                mit.ensure_hosts(eng.num_replicas)
                mit.record_step_time(r, 1.0)
        if straggle_at is not None and t == straggle_at:
            eng.set_replica_speed(st.worker, float(rel[st.worker]) / st.slowdown)
        if recover_at is not None and t == recover_at:
            eng.set_replica_speed(st.worker, float(rel[st.worker]))
        # Eq. 1 bookkeeping: work *sent* per replica since the last tick is
        # the router's assigned-count delta (arrays grow on scale-out)
        routed = eng.router.assigned_counts
        if routed.shape[0] > prev_routed.shape[0]:
            prev_routed = np.concatenate(
                [prev_routed,
                 np.zeros(routed.shape[0] - prev_routed.shape[0],
                          dtype=prev_routed.dtype)])
        delta = routed - prev_routed
        prev_routed = routed.copy()
        for r in eng.alive:
            if r not in silenced:  # a dead host emits no samples
                mon.heartbeat(r, now)
                mit.record_step_time(r, 1.0 / max(float(eng.speeds[r]), 1e-9))
                mit.record_assigned(r, int(delta[r]))
        mit.tick(now)
        if mon.check(now):
            stats["policy_outcomes"].append(policy.handle(mon, now))
        if st and t > (straggle_at or 0) and mit.slowest() == st.worker:
            stats["straggler_detected"] = True
        eng.tick()
        t += 1

    m = eng.metrics()
    lats = np.array([r.finished - r.arrival for r in eng.done
                     if r.finished >= 0])
    avg, p50, p95, p99 = _percentiles(lats)
    report = EdgeReport(  # the unified per-edge schema (TopologyReport rows)
        edge=f"source->{_STAGE}", src="source", dst=_STAGE, scheme=scheme,
        workers=eng.num_replicas, n_tuples=num_requests,
        execution_time=float(eng.now), latency_avg=avg, latency_p50=p50,
        latency_p95=p95, latency_p99=p99,
        throughput=m.throughput_tokens,
        memory_overhead=eng.router.memory_overhead(),
        memory_overhead_norm=m.session_replicas_norm,
        imbalance=_imbalance(eng.router.assigned_counts),
        remap_frac_mean=(float(np.mean(stats["remap_fracs"]))
                         if stats["remap_fracs"] else None),
        dropped=num_requests - len(eng.done),
    )
    state_row = None
    if mgr is not None:
        mgr.finalize()
        state_row = _state_row(
            mgr.report(_STAGE).summary(),
            direct_aggregate(np.asarray(fed_keys, dtype=np.int64), window))
    return {
        "scheme": scheme,
        "completed": len(eng.done),
        "submitted": num_requests,
        "state": state_row,
        "ticks": t,
        "latency_avg": m.latency_avg,
        "latency_p50": m.latency_p50,
        "latency_p99": m.latency_p99,
        "throughput_tokens": m.throughput_tokens,
        "session_replicas": m.session_replicas,
        "session_replicas_norm": m.session_replicas_norm,
        "rerouted": stats["rerouted"],
        "remap_fracs": stats["remap_fracs"],
        "policy_outcomes": stats["policy_outcomes"],
        "straggler_detected": stats["straggler_detected"],
        "report": report.to_dict(),
    }


# ---------------------------------------------------------------------------
# default suite (the bench + CI smoke surface)
# ---------------------------------------------------------------------------


def default_scenarios(num_tuples: int = 24_000, num_keys: int = 2_400,
                      workers: int = 8) -> List[Scenario]:
    """The RQ4 scenario suite: hot-key flip, straggler onset/recovery on a
    heterogeneous pool, scale-out, failure with elastic continue, and a
    composite churn storm."""
    return [
        Scenario(
            "hot_key_flip", workers=workers,
            workload=WorkloadSpec("zf_flip", num_tuples, num_keys, z=1.4),
        ),
        Scenario(
            "straggler_recovery", workers=workers,
            workload=WorkloadSpec("piecewise", num_tuples, num_keys,
                                  z=1.2, phases=6),
            capacity=CapacitySpec(
                hetero=(2.0, 1.0),  # Fig. 7 fast/slow mix
                straggler=StragglerSpec(worker=1, onset=0.25, recovery=0.65,
                                        slowdown=4.0),
            ),
        ),
        Scenario(
            "scale_out", workers=workers,
            workload=WorkloadSpec("piecewise", num_tuples, num_keys,
                                  z=1.2, phases=4),
            churn=(ChurnOp(0.5, "add", workers),),
        ),
        Scenario(
            "failure_elastic", workers=workers,
            workload=WorkloadSpec("zf_flip", num_tuples, num_keys, z=1.2),
            churn=(ChurnOp(0.4, "remove", workers - 1),),
        ),
        Scenario(
            "churn_storm", workers=workers,
            workload=WorkloadSpec("piecewise", num_tuples, num_keys,
                                  z=1.3, phases=8),
            capacity=CapacitySpec(
                straggler=StragglerSpec(worker=0, onset=0.5, recovery=0.8,
                                        slowdown=3.0),
            ),
            churn=(ChurnOp(0.3, "remove", workers - 1),
                   ChurnOp(0.6, "add", workers)),
        ),
    ]


# ---------------------------------------------------------------------------
# open-loop scenarios: arrival-schedule-driven runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpenLoopScenario:
    """A scenario driven by an *arrival process* instead of a pre-built
    stream: records arrive on a wall-clock tick grid whether or not the
    engine keeps up, pass through a bounded ingress queue under an
    admission ``policy``, and overload shows up as queueing delay / shed —
    not as a silently stretched input schedule.

    Worker capacity is **load-independent**: ``cost()`` is calibrated so
    the pool runs at ``utilization`` when offered exactly ``rate``; the
    diurnal/flash modulation then moves the *actual* utilisation around
    that operating point.  ``slo_p99`` (seconds, total latency) arms the
    :class:`~repro_torch.load.P99Autoscaler` between ``workers`` and
    ``max_workers``."""

    name: str
    workers: int = 4
    rate: float = 2_000.0        # mean offered tuples/s
    horizon: float = 4.0         # seconds of arrivals
    tick: float = 0.05           # arrival tick (s); one feed per tick
    num_keys: int = 512
    z: float = 1.2
    utilization: float = 0.8     # pool utilisation at the mean rate
    diurnal_amplitude: float = 0.0       # 0: constant base rate
    diurnal_period: Optional[float] = None  # default: one cycle per horizon
    flash: Optional[Tuple[float, float, float]] = None  # (at, dur, magnitude)
    flip_time: Optional[float] = None    # hot-key flip instant (FlipZipfKeys)
    queue_capacity: int = 4_096
    policy: str = "shed"
    backpressure: Optional[float] = 0.5  # engine-backlog threshold (s)
    slo_p99: Optional[float] = None      # arm the autoscaler when set
    max_workers: int = 16
    seed: int = 0

    def cost(self) -> float:
        """Seconds/tuple per worker: ``utilization · W / rate``, fixed
        regardless of the instantaneous offered load."""
        return self.utilization * self.workers / self.rate

    def rate_fn(self):
        fn = ConstantRate(self.rate)
        if self.diurnal_amplitude > 0.0:
            fn = fn * DiurnalRate(amplitude=self.diurnal_amplitude,
                                  period=self.diurnal_period or self.horizon)
        if self.flash is not None:
            at, duration, magnitude = self.flash
            fn = fn * FlashCrowd(at=at, duration=duration,
                                 magnitude=magnitude,
                                 ramp=min(duration / 4.0, 2 * self.tick))
        return fn

    def key_fn(self):
        if self.flip_time is not None:
            return FlipZipfKeys(self.num_keys, z=self.z,
                                flip_time=self.flip_time)
        return ZipfKeys(self.num_keys, z=self.z)

    def arrivals(self) -> ArrivalProcess:
        """A fresh (deterministically seeded) arrival process per call."""
        return ArrivalProcess(self.rate_fn(), self.key_fn(),
                              tick=self.tick, seed=self.seed)


def open_loop_topology(ol: OpenLoopScenario, scheme: str,
                       window: Optional[WindowOp] = None) -> Topology:
    """One-edge topology with *fixed* per-worker cost (unlike
    :func:`scenario_topology`, capacity must not depend on offered load —
    the load sweep is the whole point).  ``window`` attaches keyed state,
    so autoscaler membership events incur tick-billed state migration."""
    return Topology(
        name=ol.name,
        stages=(Stage(_STAGE, parallelism=ol.workers, cost=ol.cost(),
                      operator=window),),
        edges=(Edge("source", _STAGE, config_for(scheme)),),
    )


def run_open_loop_scenario(
    ol: OpenLoopScenario,
    scheme: str,
    engine: str = "batched",
    drain: bool = True,
    ticks_per_second: float = 1_000.0,
    slots_per_replica: int = 4,
    max_queue_per_replica: Optional[int] = 64,
    migration_cost_per_byte: float = 0.0,
    window: Optional[WindowOp] = None,
    device=None,
) -> Dict:
    """Drive the scenario open loop and return a flattened report row.

    ``engine`` is a simulator mode (``batched``/``reference``/``fused``)
    or ``"serving"`` (arrival-paced continuous batching; engine ticks are
    mapped to arrival seconds via ``ticks_per_second``, and the bounded
    replica queues add an engine-side shed level below the ingress
    queue's).  The returned row carries the two-level admission identity
    fields (``offered == fed + shed_ingress + residual``).  ``device`` goes
    to :class:`SimulatorEngine` (``None``: ``cuda`` for the fused engine or
    a device store); ``serving`` stays a host engine."""
    arrivals = ol.arrivals()
    topo = open_loop_topology(ol, scheme, window)
    if engine == "serving":
        eng = ServingTopologyEngine(
            slots_per_replica=slots_per_replica,
            pacing="arrival", ticks_per_second=ticks_per_second,
            max_queue_per_replica=max_queue_per_replica,
            migration_ticks_per_byte=migration_cost_per_byte)
        session = eng.open(topo, arrival_rate=ol.rate)
    else:
        sim = SimulatorEngine(mode=engine,
                              migration_cost_per_byte=migration_cost_per_byte,
                              device=device)
        session = sim.open(topo, arrival_rate=ol.rate)
    serving = engine == "serving"
    autoscaler = None
    if ol.slo_p99 is not None:
        # receipt latencies are engine-clock (simulator: seconds; serving:
        # ticks); window/cooldown compare driver seconds and need no scaling
        slo = ol.slo_p99 * (ticks_per_second if serving else 1.0)
        autoscaler = P99Autoscaler(
            _STAGE, slo_p99=slo, workers=range(ol.workers),
            max_workers=ol.max_workers,
            window=max(10 * ol.tick, 0.5),
            cooldown=max(10 * ol.tick, 0.5),
            sample_keys=range(ol.num_keys))
    # the serving receipt's backlog is queued *requests*; a threshold of
    # `backpressure` seconds of work corresponds to rate·backpressure of
    # them, and the pool drains them at about the provisioned rate
    driver = OpenLoopDriver(
        session, IngressQueue(ol.queue_capacity, policy=ol.policy,
                              seed=ol.seed),
        backpressure=(None if ol.backpressure is None else
                      ol.backpressure * (ol.rate if serving else 1.0)),
        backlog_decay=ol.rate if serving else 1.0,
        autoscaler=autoscaler)
    rep = driver.run(arrivals, 0.0, ol.horizon, drain=drain)
    er = rep.topology.edge(_STAGE)
    out = {"scenario": ol.name, "scheme": scheme, "engine": engine,
           "policy": ol.policy,
           "offered": rep.offered, "fed": rep.fed, "shed": rep.shed,
           "shed_ingress": rep.shed_ingress, "shed_engine": rep.shed_engine,
           "deferred": rep.deferred, "residual": rep.residual,
           "identity_ok": driver.queue.check_identity(),
           "queue_depth_peak": rep.queue_depth_peak,
           "queue_delay_avg": rep.queue_delay_avg,
           "queue_delay_p99": rep.queue_delay_p99,
           "total_latency_avg": rep.total_latency_avg,
           "total_latency_p99": rep.total_latency_p99,
           "autoscale_events": rep.autoscale_events,
           "workers_final": (autoscaler.workers if autoscaler is not None
                             else list(range(ol.workers))),
           "migration_stall": rep.topology.migration_stall}
    out.update(er.row())
    return out


def default_open_loop_scenarios(rate: float = 2_000.0, horizon: float = 4.0,
                                workers: int = 4,
                                num_keys: int = 512) -> List[OpenLoopScenario]:
    """The two open-loop scenarios: a flash crowd over a steady
    Zipf workload (overload → bounded queue + shed), and a diurnal rate
    with a mid-run hot-key flip (drift under time-varying load, deferred
    admission so nothing is lost)."""
    return [
        OpenLoopScenario(
            "flash_crowd", workers=workers, rate=rate, horizon=horizon,
            num_keys=num_keys, z=1.2,
            flash=(0.4 * horizon, 0.25 * horizon, 3.0),
            queue_capacity=max(int(0.05 * rate * horizon), 64),
            policy="shed", backpressure=0.25,
        ),
        OpenLoopScenario(
            "diurnal_hot_key_flip", workers=workers, rate=rate,
            horizon=horizon, num_keys=num_keys, z=1.4,
            diurnal_amplitude=0.5, flip_time=0.5 * horizon,
            queue_capacity=max(int(0.05 * rate * horizon), 64),
            policy="defer", backpressure=0.5,
        ),
    ]
