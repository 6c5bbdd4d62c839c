"""p99-driven autoscaling over the session event channel.

The control law is deliberately boring (it is the *harness*, not the
contribution): a sliding window of per-feed source-edge latencies, two
thresholds, a cooldown.

* **scale out** when the windowed p99 exceeds ``slo_p99`` — add exactly one
  worker, with the next never-used id (replica ids are never reused, and
  the serving engine requires new ids to extend the range contiguously);
* **scale in** when the windowed p99 sits below ``scale_in_frac · slo_p99``
  — retire the highest-id worker, never dropping below the initial pool;
* a ``cooldown`` (engine-clock seconds/ticks) between actions lets the
  previous action's effect reach the window before the next decision —
  without it the scaler oscillates on its own transient.

Membership changes are emitted as timestamp-addressed
:class:`~repro_torch.core.stream.MembershipEvent`s (``at_time``) scoped to the
watched stage, so they fire at the next fed tuple — exactly the semantics
a closed-loop replay of the same schedule reproduces.  The worker set is
mirrored into a :class:`~repro_torch.runtime.elastic.ElasticPool` (the runtime
control plane), whose consistent-hash ring quantifies how many keys each action
remaps; the keyed-state migration that remap implies is billed to the
destination workers' engine clock by the engines themselves
(``migration_cost_per_byte`` / ``migration_ticks_per_byte``).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.stream import MembershipEvent, at_time
from ..obs.telemetry import Telemetry
from ..runtime.elastic import ElasticPool
from ..topology.graph import ScopedEvent

__all__ = ["P99Autoscaler"]

_NULL_TELEMETRY = Telemetry(enabled=False)


class P99Autoscaler:
    """Watches :class:`~repro_torch.topology.engine.FeedReceipt`s and emits
    membership events for ``stage`` when the sliding-window p99 crosses the
    SLO.  ``observe`` returns the events to register via
    ``session.advance`` (empty list: no action)."""

    def __init__(self, stage: str, slo_p99: float, workers: Sequence[int],
                 max_workers: int, window: float = 5.0,
                 cooldown: float = 5.0, scale_in_frac: float = 0.3,
                 min_samples: int = 64,
                 pool: Optional[ElasticPool] = None,
                 sample_keys: Sequence = (),
                 telemetry: Optional[Telemetry] = None):
        if slo_p99 <= 0.0:
            raise ValueError(f"slo_p99 must be positive, got {slo_p99}")
        self.stage = stage
        self.slo_p99 = float(slo_p99)
        self.workers = sorted(int(w) for w in workers)
        self.min_workers = len(self.workers)
        self.max_workers = int(max_workers)
        self.window = float(window)
        self.cooldown = float(cooldown)
        self.scale_in_frac = float(scale_in_frac)
        self.min_samples = int(min_samples)
        self.pool = pool if pool is not None else ElasticPool(self.workers)
        self.sample_keys = list(sample_keys)
        self._next_id = max(self.workers) + 1
        self._hist: Deque[Tuple[float, np.ndarray]] = deque()
        self._last_action = -np.inf
        self.events: List[Dict] = []
        # each action lands as a trace instant + timeline points;
        # the driver passes its session's bundle (no-op when disabled)
        self.tel = telemetry if telemetry is not None else _NULL_TELEMETRY
        self._c_actions = self.tel.metrics.counter("autoscale.actions")

    # -- control loop ---------------------------------------------------------
    def observe(self, t: float, receipt) -> List[ScopedEvent]:
        """Fold one feed's latencies into the window; decide at ``t``."""
        lats = getattr(receipt, "latencies", None)
        if lats is not None and lats.size:
            self._hist.append((float(t), lats))
        while self._hist and self._hist[0][0] < t - self.window:
            self._hist.popleft()
        p99 = self.window_p99()
        if p99 is None or t - self._last_action < self.cooldown:
            return []
        if p99 > self.slo_p99 and len(self.workers) < self.max_workers:
            return [self._scale_out(t, p99)]
        if (p99 < self.scale_in_frac * self.slo_p99
                and len(self.workers) > self.min_workers):
            return [self._scale_in(t, p99)]
        return []

    def window_p99(self) -> Optional[float]:
        """p99 over the sliding window (``None`` until ``min_samples``
        latencies have been seen — don't scale on noise)."""
        if not self._hist:
            return None
        lats = np.concatenate([h[1] for h in self._hist])
        if lats.size < self.min_samples:
            return None
        return float(np.percentile(lats, 99))

    # -- actions --------------------------------------------------------------
    def _scale_out(self, t: float, p99: float) -> ScopedEvent:
        new = self._next_id
        self._next_id += 1
        self.workers = sorted(self.workers + [new])
        moved = self.pool.add_host(new, self.sample_keys)
        return self._emit(t, p99, "scale_out", new, moved)

    def _scale_in(self, t: float, p99: float) -> ScopedEvent:
        gone = self.workers[-1]  # retire the highest id
        self.workers = self.workers[:-1]
        moved = self.pool.remove_host(gone, self.sample_keys)
        return self._emit(t, p99, "scale_in", gone, moved)

    def _emit(self, t: float, p99: float, action: str, worker: int,
              moved: int) -> ScopedEvent:
        self._last_action = t
        self._hist.clear()  # stale latencies predate the new pool
        self.events.append({
            "t": float(t), "action": action, "worker": int(worker),
            "workers": list(self.workers), "p99": float(p99),
            "slo_p99": self.slo_p99,
            "ring_moved": int(moved), "ring_sampled": len(self.sample_keys),
        })
        self._c_actions.add(1)
        self.tel.tracer.instant(
            f"autoscale.{action}", cat="load", worker=int(worker),
            workers=len(self.workers), p99=float(p99), ring_moved=int(moved))
        tl = self.tel.timeline
        tl.point("autoscale.workers", len(self.workers), engine_clock=t)
        tl.point("autoscale.window_p99", p99, engine_clock=t)
        return ScopedEvent(self.stage, at_time(
            MembershipEvent(workers=tuple(self.workers)), t))
