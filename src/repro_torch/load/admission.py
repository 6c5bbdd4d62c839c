"""Admission control + backpressure for the open-loop driver.

The driver never feeds the engine directly: arrivals land in a **bounded
ingress queue** first, and the driver only drains it while the engine's
backlog is below the backpressure threshold.  When arrivals outrun
drainage the queue fills, and the admission policy decides what happens to
the overflow:

======== ==================================================================
policy   overflow behaviour
======== ==================================================================
shed     drop the newest arrivals (never admitted; counted in ``shed``)
defer    hold them source-side (unbounded spill; they enter the queue as
         capacity frees up — queueing delay grows instead of loss)
degrade  thin the *incoming* tick uniformly to the fraction that fits
         (degrade-to-sample: every admitted record is an unbiased sample
         of the offered stream; the thinned-out remainder counts as shed)
======== ==================================================================

Accounting is exact and closed: ``offered == fed + shed + residual`` at
every instant, where ``residual`` is whatever is still waiting (queue +
spill) — the invariant ``tests/test_load.py`` pins.  Time-in-queue is
billed per record as ``feed_time - arrival`` when the driver pops it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

__all__ = ["AdmissionStats", "IngressQueue", "POLICIES"]

POLICIES = ("shed", "defer", "degrade")


@dataclasses.dataclass
class AdmissionStats:
    """Cumulative admission accounting (``offered == fed + shed +
    residual`` always — residual is read off the live queue)."""

    offered: int = 0
    fed: int = 0
    shed: int = 0
    deferred: int = 0        # records that ever waited in the spill
    queue_depth_peak: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class IngressQueue:
    """Bounded FIFO of (key, arrival_ts, value) records with a pluggable
    overflow policy.  ``offer`` ingests one arrival tick; ``pop`` drains up
    to ``n`` records for feeding and returns their arrival timestamps so
    the caller can bill time-in-queue."""

    def __init__(self, capacity: int, policy: str = "shed", seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; one of {POLICIES}")
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.policy = policy
        self.stats = AdmissionStats()
        self._q: Deque[Tuple[int, float, Optional[float]]] = deque()
        self._spill: Deque[Tuple[int, float, Optional[float]]] = deque()
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._q) + len(self._spill)

    @property
    def residual(self) -> int:
        return len(self)

    def offer(self, keys: np.ndarray, ts: np.ndarray,
              values: Optional[np.ndarray] = None) -> None:
        """Ingest one arrival tick's records under the admission policy."""
        n = int(keys.shape[0])
        self.stats.offered += n
        if n == 0:
            self._note_depth()
            return
        room = self.capacity - len(self._q)
        if self.policy == "degrade" and n > room:
            # uniform thinning to what fits: admitted records are an
            # unbiased sample of the offered tick
            keep = np.zeros(n, dtype=bool)
            if room > 0:
                keep[self._rng.choice(n, size=room, replace=False)] = True
            self.stats.shed += int(n - keep.sum())
            keys, ts = keys[keep], ts[keep]
            values = None if values is None else values[keep]
            n = int(keys.shape[0])
            room = n
        admit = n if self.policy == "defer" else min(n, max(room, 0))
        for i in range(admit):
            rec = (int(keys[i]), float(ts[i]),
                   None if values is None else float(values[i]))
            if self.policy == "defer" and len(self._q) >= self.capacity:
                self._spill.append(rec)
                self.stats.deferred += 1
            else:
                self._q.append(rec)
        if self.policy == "shed":
            self.stats.shed += n - admit
        self._note_depth()

    def pop(self, n: int):
        """Drain up to ``n`` records (FIFO).  Returns ``(keys, arrivals,
        values)`` arrays — arrivals are the records' original offered
        timestamps, so ``feed_time - arrivals`` is their time in queue.
        Spilled (deferred) records refill the bounded queue as it drains."""
        take = min(n, len(self._q))
        out = [self._q.popleft() for _ in range(take)]
        while self._spill and len(self._q) < self.capacity:
            self._q.append(self._spill.popleft())
        self.stats.fed += take
        keys = np.array([r[0] for r in out], dtype=np.int32)
        arrivals = np.array([r[1] for r in out], dtype=np.float64)
        has_vals = any(r[2] is not None for r in out)
        values = (np.array([r[2] if r[2] is not None else 0.0 for r in out])
                  if has_vals else None)
        return keys, arrivals, values

    def _note_depth(self) -> None:
        depth = len(self)
        if depth > self.stats.queue_depth_peak:
            self.stats.queue_depth_peak = depth

    def check_identity(self) -> bool:
        """The admission identity: offered == fed + shed + residual."""
        s = self.stats
        return s.offered == s.fed + s.shed + self.residual
