"""Heuristic worker assignment (paper Alg. 3, Eq. 1 & Eq. 2).

The source never polls workers.  It keeps, per worker:

* ``P_w`` — processing capacity = seconds per tuple (periodically sampled),
* ``C_w`` — *inferred* number of unprocessed tuples,
* ``N_w`` — tuples assigned since the last estimation tick.

Every interval ``T`` (paper: 10 s; here a configurable logical interval) the
backlog is advanced with Eq. 1::

    C_w <- ((C_w + N_w) * P_w - T) / P_w        (clamped at 0)

and a tuple is routed to the candidate with the least estimated waiting time
(Eq. 2):  ``T_w = C_w * P_w``.

The torch variant (:func:`select_min_wait`) is used on device (MoE overflow
routing / straggler-aware replica choice); :class:`WorkerStateEstimator` is
the host-side runtime piece shared by the data pipeline, the serving router
and the stream simulator.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

__all__ = ["WorkerStateEstimator", "select_min_wait", "greedy_allocate"]


def greedy_allocate(waits: np.ndarray, caps: np.ndarray, count: int) -> np.ndarray:
    """Exact batched replay of the Alg. 3 Eq. 2 greedy.

    Applying :meth:`WorkerStateEstimator.select` ``count`` times is: pick the
    candidate with the least estimated wait, bump its wait by ``P_w``,
    repeat.  Replayed here over a (wait, index) heap — O(count log k) with
    ``count`` bounded by the engine's sub-chunk size, and bit-identical to
    the sequential trajectory (heap ties break on the smaller index, exactly
    like ``np.argmin``).  Returns integer allocations aligned with
    ``waits``/``caps``.
    """
    k = waits.shape[0]
    alloc = np.zeros(k, dtype=np.int64)
    if count <= 0:
        return alloc
    if k == 1:
        alloc[0] = count
        return alloc
    heap = [(w, i) for i, w in enumerate(waits.tolist())]
    heapq.heapify(heap)
    caps_l = caps.tolist()
    alloc_l = [0] * k
    for _ in range(count):
        w, i = heapq.heappop(heap)
        alloc_l[i] += 1
        heapq.heappush(heap, (w + caps_l[i], i))
    alloc[:] = alloc_l
    return alloc


@dataclasses.dataclass
class WorkerStateEstimator:
    """Host-side Alg. 3 state.  All times are logical seconds."""

    capacities: np.ndarray  # P_w, seconds/tuple, shape (W,)
    interval: float = 10.0  # T
    time_fn: Optional[callable] = None  # logical clock; required (no wall time)

    def __post_init__(self):
        self.capacities = np.asarray(self.capacities, dtype=np.float64)
        w = self.capacities.shape[0]
        self.backlog = np.zeros(w, dtype=np.float64)  # C_w
        self.assigned = np.zeros(w, dtype=np.float64)  # N_w
        self._t_prior = 0.0

    @property
    def num_workers(self) -> int:
        return self.capacities.shape[0]

    def ensure_size(self, num_workers: int) -> None:
        """Grow the per-worker arrays for scale-out (ids are never reused).
        New workers start at capacity 1.0 with empty backlog until a real
        sample arrives."""
        grow = num_workers - self.capacities.shape[0]
        if grow > 0:
            self.capacities = np.concatenate([self.capacities, np.ones(grow)])
            self.backlog = np.concatenate([self.backlog, np.zeros(grow)])
            self.assigned = np.concatenate([self.assigned, np.zeros(grow)])

    # -- Alg. 3 lines 3-10: periodic state estimation --------------------------
    def maybe_estimate(self, now: float) -> None:
        if now - self._t_prior > self.interval:
            work = (self.backlog + self.assigned) * self.capacities
            elapsed = now - self._t_prior
            self.backlog = np.where(
                work > elapsed, (work - elapsed) / self.capacities, 0.0
            )
            self.assigned[:] = 0.0
            self._t_prior = now

    # -- Alg. 3 lines 12-18: candidate selection -------------------------------
    def select(self, candidates: Sequence[int], now: Optional[float] = None) -> int:
        if now is not None:
            self.maybe_estimate(now)
        cand = np.asarray(list(candidates), dtype=np.int64)
        waits = (self.backlog[cand] + self.assigned[cand]) * self.capacities[cand]
        appro = int(cand[int(np.argmin(waits))])
        # line 18: C_appro <- C_appro + 1 (we track it in N_w until next tick)
        self.assigned[appro] += 1.0
        return appro

    # -- bookkeeping hooks ------------------------------------------------------
    def record_capacity_sample(self, worker: int, seconds_per_tuple: float,
                               ema: float = 0.5) -> None:
        """Periodic sampling of P_w (paper §4.2.1)."""
        self.capacities[worker] = (
            ema * seconds_per_tuple + (1.0 - ema) * self.capacities[worker]
        )

    def estimated_wait(self, worker: int) -> float:
        return float(
            (self.backlog[worker] + self.assigned[worker]) * self.capacities[worker]
        )


def select_min_wait(backlog: torch.Tensor, capacity: torch.Tensor,
                    candidate_mask: torch.Tensor) -> torch.Tensor:
    """Device-side Eq. 2 argmin over a candidate set.

    backlog:        (W,) inferred unprocessed work C_w
    capacity:       (W,) seconds/tuple P_w
    candidate_mask: (..., W) bool — True where the worker is a candidate
    returns:        (...,) int32 selected worker per row (ties to the
                    smallest worker id, as ``jnp.argmin``/``np.argmin``)
    """
    wait = backlog * capacity  # T_w, (W,)
    wait = torch.where(candidate_mask, wait, torch.full_like(wait, torch.inf))
    # torch.argmin's tie order is unspecified: take the first index that
    # attains the row minimum explicitly
    hit = wait == wait.amin(dim=-1, keepdim=True)
    idx = torch.arange(wait.shape[-1], device=wait.device)
    return torch.where(hit, idx, wait.shape[-1]).amin(dim=-1).to(torch.int32)
