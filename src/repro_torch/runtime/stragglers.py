"""Straggler mitigation via the paper's Alg. 3 state inference.

Instead of synchronising on the slowest host (or polling host queues), the
coordinator *infers* each host's backlog from what it already knows — how
much work it sent and the host's sampled speed (Eq. 1) — and rebalances the
next step's work shares toward the hosts with the least estimated waiting
time (Eq. 2).  ``shares()`` returns per-host work fractions the data
pipeline / batch assembler applies.
"""

from __future__ import annotations

import numpy as np

from ..core.assignment import WorkerStateEstimator

__all__ = ["StragglerMitigator"]


class StragglerMitigator:
    def __init__(self, num_hosts: int, interval: float = 10.0,
                 min_share: float = 0.25):
        self.est = WorkerStateEstimator(np.ones(num_hosts), interval=interval)
        self.min_share = min_share

    def ensure_hosts(self, num_hosts: int) -> None:
        """Grow the estimator arrays for scale-out (host ids never reused)."""
        self.est.ensure_size(num_hosts)

    def record_step_time(self, host: int, seconds_per_item: float) -> None:
        self.est.record_capacity_sample(host, seconds_per_item)

    def record_assigned(self, host: int, items: int) -> None:
        self.est.assigned[host] += items

    def tick(self, now: float) -> None:
        self.est.maybe_estimate(now)

    def waits(self) -> np.ndarray:
        """Estimated waiting time per host (Eq. 2)."""
        return (self.est.backlog + self.est.assigned) * self.est.capacities

    def shares(self) -> np.ndarray:
        """Work fractions inversely proportional to estimated wait+speed."""
        # effective service rate net of backlog
        rate = 1.0 / np.maximum(self.est.capacities, 1e-9)
        wait = self.waits()
        score = rate / (1.0 + wait)
        share = score / score.sum()
        floor = self.min_share / len(share)
        share = np.maximum(share, floor)
        return share / share.sum()

    def slowest(self) -> int:
        return int(np.argmax(self.waits()))
