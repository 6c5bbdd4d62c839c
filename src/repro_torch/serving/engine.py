"""Continuous-batching serving engine with a FISH request router.

Requests carry *session keys* (user / conversation ids) whose popularity is
time-evolving — exactly the paper's workload.  The router is the paper's
full pipeline:

* hot sessions are spread across several replicas (CHK), cold sessions get
  2 candidates (PKG fallback) — bounding per-session state replication;
* the replica choice among candidates uses *inferred* backlog (Alg. 3 /
  Eq. 1-2), never a queue-depth RPC;
* replica failure / scale-out remaps sessions via consistent hashing (§5),
  so most sessions keep replica affinity (their KV/prefix state survives).

The engine can run pure-simulation (logical per-token service times) or
drive a real model's ``decode_step`` per tick through ``step_fn`` (see
:mod:`repro_torch.launch.serve`).  Host code only: the port's copy of the
JAX package's ``serving/engine.py``, over the port's router, registry and
slot manager.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional, Union

import numpy as np

from ..core.fish import FishParams
from ..obs.metrics import MetricsRegistry
from .kvcache import SlotManager

__all__ = ["Request", "ServingEngine", "EngineMetrics"]


@dataclasses.dataclass
class Request:
    request_id: int
    session: object
    arrival: float
    target_tokens: int
    finished: float = -1.0
    replica: int = -1
    #: tick at which the request won a decode slot (-1 while queued) —
    #: ``started - arrival`` is its time-in-queue
    started: float = -1.0


@dataclasses.dataclass
class EngineMetrics:
    latency_avg: float
    latency_p50: float
    latency_p99: float
    throughput_tokens: float
    session_replicas: int          # Σ replicas holding state per session
    session_replicas_norm: float   # normalised to 1 replica/session
    dropped: int
    # the autoscaler's input signals
    queue_depth_peak: int = 0      # max Σ_r queued requests seen at any tick
    in_flight_peak: int = 0        # max Σ_r active decode slots at any tick
    shed: int = 0                  # requests rejected by admission control
    time_in_queue_avg: float = 0.0
    time_in_queue_p99: float = 0.0


class ServingEngine:
    def __init__(
        self,
        num_replicas: int,
        slots_per_replica: int = 8,
        tokens_per_tick: Optional[np.ndarray] = None,  # replica speed (hetero)
        grouping: Union[str, "SchemeConfig"] = "fish",
        fish_params: Optional[FishParams] = None,
        step_fn: Optional[Callable[[int, List[dict]], None]] = None,
        max_queue_per_replica: Optional[int] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        from ..topology.configs import FishConfig, SchemeConfig, config_for

        self.num_replicas = num_replicas
        speeds = (np.ones(num_replicas) if tokens_per_tick is None
                  else np.asarray(tokens_per_tick, dtype=np.float64))
        self.speeds = speeds
        caps = 1.0 / np.maximum(speeds, 1e-9)  # seconds(ticks)/token = P_w
        # grouping: a typed SchemeConfig or a scheme name.  The
        # name "fish" defaults to a 4-tick estimator interval (the engine's
        # historical pacing); an explicit FishConfig keeps its own interval.
        if not isinstance(grouping, SchemeConfig):
            grouping = (FishConfig(interval=4.0) if grouping == "fish"
                        else config_for(grouping))
        if isinstance(grouping, FishConfig) and fish_params is not None:
            grouping = FishConfig.from_params(
                fish_params, interval=grouping.interval,
                virtual_nodes=grouping.virtual_nodes,
                use_consistent_hash=grouping.use_consistent_hash)
        self.router = grouping.build(num_replicas, capacities=caps)
        self.slots = [SlotManager(slots_per_replica) for _ in range(num_replicas)]
        self.queues: List[deque] = [deque() for _ in range(num_replicas)]
        self.step_fn = step_fn
        self.done: List[Request] = []
        self.now = 0.0
        self._alive = set(range(num_replicas))
        self._token_budget = np.zeros(num_replicas)
        self._next_slot = [0] * num_replicas  # round-robin decode cursor
        self.total_tokens = 0
        # bounded ingress queue + migration stall + observability:
        # shed / queue-depth / in-flight live in registry cells
        # (the session's registry when given, else a private one) and the
        # legacy ``shed``/``queue_depth_peak``/``in_flight_peak`` attributes
        # are properties over them — one source of truth for the report.
        self.max_queue_per_replica = max_queue_per_replica
        self._stall = np.zeros(num_replicas)  # remaining stall ticks
        reg = metrics if metrics is not None else MetricsRegistry()
        self._m_shed = reg.counter("serving.shed")
        self._m_queue_depth_peak = reg.gauge("serving.queue_depth_peak")
        self._m_in_flight_peak = reg.gauge("serving.in_flight_peak")
        self._m_queue_depth_peak._peak_mode = True
        self._m_in_flight_peak._peak_mode = True

    @property
    def shed(self) -> int:
        """Requests rejected by admission control (registry-backed)."""
        return self._m_shed.value

    @shed.setter
    def shed(self, v: int) -> None:
        self._m_shed.set(v)

    @property
    def queue_depth_peak(self) -> int:
        return self._m_queue_depth_peak.value

    @queue_depth_peak.setter
    def queue_depth_peak(self, v: int) -> None:
        self._m_queue_depth_peak.set(v)

    @property
    def in_flight_peak(self) -> int:
        return self._m_in_flight_peak.value

    @in_flight_peak.setter
    def in_flight_peak(self, v: int) -> None:
        self._m_in_flight_peak.set(v)

    @property
    def alive(self) -> List[int]:
        return sorted(self._alive)

    # -- ingress -------------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Route and enqueue one request.  With a bounded ingress queue
        (``max_queue_per_replica``) a request routed to a full replica queue
        is *shed* — counted in ``self.shed``, not enqueued — and -1 is
        returned (admission control)."""
        replica = self.router.assign(req.session, self.now)
        if (self.max_queue_per_replica is not None
                and len(self.queues[replica]) >= self.max_queue_per_replica):
            self._m_shed.add(1)
            return -1
        req.replica = replica
        self.queues[replica].append(req)
        self._m_queue_depth_peak.peak(sum(len(q) for q in self.queues))
        return replica

    # -- one scheduling tick ---------------------------------------------------
    def tick(self) -> None:
        self.now += 1.0
        for r in sorted(self._alive):
            if self._stall[r] > 0:
                # migration stall: the replica is ingesting migrated session
                # state this tick — no admission, no decode
                # (tick-billed migration)
                self._stall[r] -= 1.0
                continue
            sm = self.slots[r]
            q = self.queues[r]
            while q and sm.free:
                req = q.popleft()
                slot = sm.allocate(req.request_id, req.session, self.now)
                sm.active[slot]["req"] = req
                req.started = self.now
            # decode: each replica advances `speed` tokens per tick *total*,
            # spread round-robin over its active slots; a cursor carries the
            # rotation across passes and ticks so no slot is starved when
            # speed < active slots (only the fractional part of the budget
            # carries across ticks)
            self._token_budget[r] += self.speeds[r]
            budget = int(self._token_budget[r])
            self._token_budget[r] -= budget
            while budget > 0 and sm.active:
                if self.step_fn is not None:
                    self.step_fn(r, list(sm.active.values()))
                ptr = self._next_slot[r]
                order = sorted(sm.active)
                order = [s for s in order if s >= ptr] \
                    + [s for s in order if s < ptr]
                for slot in order:
                    if budget <= 0:
                        break
                    meta = sm.active[slot]
                    meta["tokens"] += 1
                    self.total_tokens += 1
                    budget -= 1
                    self._next_slot[r] = slot + 1
                    req = meta["req"]
                    if meta["tokens"] >= req.target_tokens:
                        req.finished = self.now
                        self.done.append(req)
                        sm.release(slot)
        self._m_in_flight_peak.peak(
            sum(len(self.slots[r].active) for r in self._alive))

    def run(self, until_done: int, max_ticks: int = 100_000) -> None:
        """Tick until ``until_done`` submitted requests are accounted for.
        Shed requests count toward completion: they can
        never reach ``done``, so excluding them would spin the loop to
        ``max_ticks`` whenever admission dropped anything, silently
        inflating reported ticks."""
        t = 0
        while len(self.done) + self.shed < until_done and t < max_ticks:
            self.tick()
            t += 1

    def stall_replica(self, r: int, ticks: float) -> None:
        """Bill migrated-state ingest to replica ``r``: it neither admits
        nor decodes for the next ``ticks`` scheduler ticks (scale
        out genuinely competes with serving bandwidth)."""
        self._stall[r] += float(ticks)

    # -- fault tolerance / elasticity -------------------------------------------
    def fail_replica(self, r: int) -> int:
        """Kill a replica: requeue its in-flight + queued requests via the
        router (consistent-hash remap).  Returns # requests rerouted."""
        self._alive.discard(r)
        moved = 0
        orphans = [m["req"] for m in self.slots[r].active.values()]
        orphans += list(self.queues[r])
        self.queues[r].clear()
        self.slots[r] = SlotManager(self.slots[r].num_slots)
        self._next_slot[r] = 0
        self.router.on_membership_change(sorted(self._alive))
        for req in orphans:
            self.submit(req)
            moved += 1
        return moved

    def add_replica(self, speed: float = 1.0, slots: int = 8) -> int:
        r = self.num_replicas
        self.num_replicas += 1
        self.speeds = np.concatenate([self.speeds, [speed]])
        self._token_budget = np.concatenate([self._token_budget, [0.0]])
        self._stall = np.concatenate([self._stall, [0.0]])
        self._next_slot.append(0)
        self.slots.append(SlotManager(slots))
        self.queues.append(deque())
        self._alive.add(r)
        self.router.on_membership_change(sorted(self._alive))
        # propagate the true capacity (P_w = 1/speed) so Alg. 3 routes to the
        # new replica proportionally to its speed instead of the 1.0 pad;
        # full-weight sample — there is no real prior to average against
        self.router.record_capacity_sample(
            r, 1.0 / max(speed, 1e-9), ema=1.0
        )
        return r

    def set_replica_speed(self, r: int, speed: float) -> None:
        """Mid-run speed change (straggler onset / recovery).  The router
        learns the new capacity through a sample, as it would from the
        periodic Alg. 3 sampling loop."""
        self.speeds[r] = speed
        self.router.record_capacity_sample(r, 1.0 / max(speed, 1e-9))

    # -- metrics ------------------------------------------------------------------
    def metrics(self) -> EngineMetrics:
        lats = np.array([r.finished - r.arrival for r in self.done
                         if r.finished >= 0])
        tiq = np.array([r.started - r.arrival for r in self.done
                        if r.finished >= 0 and r.started >= 0])
        sessions = self.router.replicas
        total_rep = sum(len(v) for v in sessions.values())
        return EngineMetrics(
            latency_avg=float(lats.mean()) if len(lats) else 0.0,
            latency_p50=float(np.percentile(lats, 50)) if len(lats) else 0.0,
            latency_p99=float(np.percentile(lats, 99)) if len(lats) else 0.0,
            throughput_tokens=self.total_tokens / max(self.now, 1.0),
            session_replicas=total_rep,
            session_replicas_norm=total_rep / max(len(sessions), 1),
            dropped=0,
            queue_depth_peak=self.queue_depth_peak,
            in_flight_peak=self.in_flight_peak,
            shed=self.shed,
            time_in_queue_avg=float(tiq.mean()) if len(tiq) else 0.0,
            time_in_queue_p99=(float(np.percentile(tiq, 99))
                               if len(tiq) else 0.0),
        )
