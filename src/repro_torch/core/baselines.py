"""Stream grouping schemes (paper §2.2) + the FISH grouper itself.

All groupers share one interface used by the stream simulator
(:mod:`repro_torch.core.stream`), the data pipeline and the serving router::

    worker = grouper.assign(key, now)

and expose ``state_replicas()`` — the set of (key -> workers) mappings they
created, which is the paper's memory-overhead metric (Σ_w distinct keys held
on w, normalised to FG's 1 replica per key).

Membership is first class: every grouper tracks the live
worker set and honors it from both ``assign`` and ``assign_batch``.  SG
round-robins over the live list; the hash-based schemes (FG/PKG/DC/WC/FISH)
draw candidates from a shared consistent-hash ring over the live set (the
paper's §5 mechanism), so a membership change only remaps keys whose ring
arcs are affected.  Scale-out grows the per-worker arrays in place — worker
ids are never reused.  Per-scheme semantics are tabulated in DESIGN.md §5.

Baselines:
  * SG  — Shuffle Grouping: round-robin, ignores the key.
  * FG  — Field Grouping: single owner per key (nearest live worker
          clockwise on the ring).
  * PKG — Partial Key Grouping: power-of-two-choices between the first 2
          ring candidates, pick the one with the smaller local count.
  * DC  — D-Choices: SpaceSaving heavy hitters over the *entire lifetime* get
          d ring candidates; the rest use PKG.
  * WC  — W-Choices: like DC but heavy hitters may use all live workers.
  * FISH — epoch-decayed hot keys (Alg. 1) + CHK (Alg. 2) + heuristic worker
          assignment (Alg. 3) over consistent-hash candidates (§5).
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .assignment import WorkerStateEstimator, greedy_allocate
from .chash import ConsistentHashRing, hash32
from .fish import (EpochFrequencyTracker, FishParams, chk_num_workers,
                   chk_num_workers_batch)

__all__ = [
    "Grouper",
    "ShuffleGrouping",
    "FieldGrouping",
    "PartialKeyGrouping",
    "DChoices",
    "WChoices",
    "FishGrouper",
]


_RING_CACHE: Dict[tuple, ConsistentHashRing] = {}


def _initial_ring(num_workers: int, virtual_nodes: int) -> ConsistentHashRing:
    """Memoised pristine ring for the initial [0, W) worker set — each
    grouper gets a private clone, so membership mutations never leak."""
    key = (num_workers, virtual_nodes)
    ring = _RING_CACHE.get(key)
    if ring is None:
        ring = _RING_CACHE[key] = ConsistentHashRing(
            range(num_workers), virtual_nodes=virtual_nodes
        )
    return ring.clone()


class Grouper:
    """Base class: key->worker replicas, per-worker counts, live membership."""

    name = "base"
    _uses_ring = True  # SG routes without hashing and skips ring construction

    def __init__(self, num_workers: int, virtual_nodes: int = 64):
        self.num_workers = num_workers  # worker-id universe size (array length)
        self.replicas: Dict[object, Set[int]] = {}
        self.assigned_counts = np.zeros(num_workers, dtype=np.int64)
        self._active: List[int] = list(range(num_workers))
        self.ring: Optional[ConsistentHashRing] = (
            _initial_ring(num_workers, virtual_nodes) if self._uses_ring
            else None
        )
        # unique-key cache of the clockwise live-worker order, shared by every
        # ring-based scheme; invalidated on membership change
        self._ring_order: Dict[object, List[int]] = {}

    # -- interface ---------------------------------------------------------------
    def assign(self, key, now: float = 0.0) -> int:
        raise NotImplementedError

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        """Vectorised routing of a whole chunk.

        ``keys`` is a 1-D integer ndarray of interned key ids; tuple ``i``
        arrives at logical time ``now0 + i*dt``.  Subclasses override with
        NumPy implementations; this fallback replays :meth:`assign` per tuple
        and is the oracle the equivalence tests compare against.
        """
        keys = np.asarray(keys)
        out = np.empty(keys.shape[0], dtype=np.int64)
        for i in range(keys.shape[0]):
            out[i] = self.assign(keys[i], now0 + i * dt)
        return out

    def _record(self, key, worker: int) -> int:
        self.replicas.setdefault(key, set()).add(worker)
        self.assigned_counts[worker] += 1
        return worker

    def _record_batch(self, keys: np.ndarray, workers: np.ndarray) -> np.ndarray:
        """Bulk :meth:`_record`: replica sets via unique (key, worker) pairs,
        assigned counts via one bincount."""
        self.assigned_counts += np.bincount(
            workers, minlength=self.assigned_counts.shape[0]
        )
        if keys.dtype.kind in "iu":
            w_mod = self.assigned_counts.shape[0]
            pair = keys.astype(np.int64) * np.int64(w_mod) \
                + workers.astype(np.int64)
            for p in np.unique(pair).tolist():
                self.replicas.setdefault(p // w_mod, set()).add(int(p % w_mod))
        else:
            # object/string keys: the caches above are dtype-agnostic, only
            # the pair encoding needs integers — record per tuple instead
            for k, w in zip(keys.tolist(), workers.tolist()):
                self.replicas.setdefault(k, set()).add(int(w))
        return workers

    # -- live-set helpers ----------------------------------------------------------
    @property
    def active_workers(self) -> List[int]:
        return list(self._active)

    def _ring_prefix(self, key, d: int) -> List[int]:
        """First ``d`` distinct live workers clockwise from ``key``.

        The clockwise order is stable, so ``lookup_n(key, d)`` is a prefix of
        ``lookup_n(key, d')`` for d' > d: cache the longest walk so far and
        extend lazily (non-hot keys only ever walk 1-2 steps).
        """
        order = self._ring_order.get(key)
        if order is None or (len(order) < d and len(order) < len(self.ring)):
            order = self._ring_order[key] = self.ring.lookup_n(key, d)
        return order[:d]

    def probe_route(self, key) -> Optional[int]:
        """Primary route for ``key`` without recording anything — the remap
        accounting probe (Fig. 17 "keys moved per membership event").  None
        for schemes with no key affinity (SG)."""
        if self.ring is None:
            return None
        return self._ring_prefix(key, 1)[0]

    # -- metrics -----------------------------------------------------------------
    def memory_overhead(self) -> int:
        """Σ_w |distinct keys on worker w|  (paper's memory metric)."""
        return int(sum(len(ws) for ws in self.replicas.values()))

    def memory_overhead_normalized(self) -> float:
        """Normalised to FG (= 1 replica per distinct key)."""
        n_keys = max(len(self.replicas), 1)
        return self.memory_overhead() / float(n_keys)

    # hooks for heterogeneous-capacity runtimes; default no-op
    def record_capacity_sample(self, worker: int, seconds_per_tuple: float,
                               ema: float = 0.5) -> None:
        pass

    # -- elasticity (paper §5) -----------------------------------------------------
    def on_membership_change(self, workers: Sequence[int]) -> None:
        """Switch the live worker set.  Honored by every scheme: SG
        round-robins over the new list, ring-based schemes remap only the
        keys on affected arcs.  Worker ids beyond the current universe grow
        the per-worker arrays in place (ids are never reused)."""
        target = sorted(int(w) for w in workers)
        if not target:
            raise ValueError("membership change needs at least one live worker")
        if target[-1] >= self.num_workers:
            self._grow_arrays(target[-1] + 1)
            self.num_workers = target[-1] + 1
        if self.ring is not None:
            current = set(self.ring.workers)
            tset = set(target)
            # sorted: add/remove order decides linear-probe placement on
            # ring-point hash collisions, so set order must not leak in
            for w in sorted(current - tset):
                self.ring.remove_worker(w)
            for w in sorted(tset - current):
                self.ring.add_worker(w)
        self._active = target
        self._ring_order.clear()  # candidate caches are keyed on membership
        self._membership_caches_clear()

    def _grow_arrays(self, new_size: int) -> None:
        grow = new_size - self.assigned_counts.shape[0]
        if grow > 0:
            self.assigned_counts = np.concatenate(
                [self.assigned_counts, np.zeros(grow, dtype=np.int64)]
            )

    def _membership_caches_clear(self) -> None:
        pass


class ShuffleGrouping(Grouper):
    name = "sg"
    _uses_ring = False

    def __init__(self, num_workers: int):
        super().__init__(num_workers)
        self._rr = 0

    def assign(self, key, now: float = 0.0) -> int:
        act = self._active
        w = act[self._rr]
        self._rr = (self._rr + 1) % len(act)
        return self._record(key, w)

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        keys = np.asarray(keys)
        n = keys.shape[0]
        act = np.asarray(self._active, dtype=np.int64)
        workers = act[(self._rr + np.arange(n, dtype=np.int64)) % act.shape[0]]
        self._rr = int((self._rr + n) % act.shape[0])
        return self._record_batch(keys, workers)

    def _membership_caches_clear(self) -> None:
        self._rr %= len(self._active)


class FieldGrouping(Grouper):
    """One owner per key: the nearest live worker clockwise on the ring.

    With a static membership this is the paper's FG (a fixed hash of the
    key); under churn the consistent-hash property keeps every key whose
    owner survived on the same worker (tested in tests/test_membership.py).
    """

    name = "fg"

    def assign(self, key, now: float = 0.0) -> int:
        return self._record(key, self._ring_prefix(key, 1)[0])

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        keys = np.asarray(keys)
        uniq, inv = np.unique(keys, return_inverse=True)
        w_uniq = np.empty(uniq.shape[0], dtype=np.int64)
        for j, k in enumerate(uniq.tolist()):
            w_uniq[j] = self._ring_prefix(k, 1)[0]
        return self._record_batch(keys, w_uniq[inv])


class PartialKeyGrouping(Grouper):
    """Power of two choices between the first two ring candidates [14]."""

    name = "pkg"

    def _candidates(self, key) -> List[int]:
        cands = self._ring_prefix(key, 2)
        if len(cands) == 1:  # single live worker
            return [cands[0], cands[0]]
        return cands

    def _pick_least_loaded(self, cands: Sequence[int]) -> int:
        loads = self.assigned_counts[list(cands)]
        return int(cands[int(np.argmin(loads))])

    def assign(self, key, now: float = 0.0) -> int:
        return self._record(key, self._pick_least_loaded(self._candidates(key)))

    def _pairs_for(self, uniq: np.ndarray) -> np.ndarray:
        """(U, 2) candidate pairs; ring walks cached per unique key ever."""
        pairs = np.empty((uniq.shape[0], 2), dtype=np.int64)
        for j, k in enumerate(uniq.tolist()):
            pairs[j] = self._candidates(k)
        return pairs

    def _two_choice_loop(self, c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
        """Exact sequential two-choice selection with cumulative-count
        tie-breaking (ties go to the first candidate, as np.argmin does)."""
        counts = self.assigned_counts.tolist()
        ol = []
        append = ol.append
        for a, b in zip(c0.tolist(), c1.tolist()):
            w = a if counts[a] <= counts[b] else b
            counts[w] += 1
            append(w)
        return np.asarray(ol, dtype=np.int64)

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        keys = np.asarray(keys)
        uniq, inv = np.unique(keys, return_inverse=True)
        pairs = self._pairs_for(uniq)[inv]
        workers = self._two_choice_loop(pairs[:, 0], pairs[:, 1])
        return self._record_batch(keys, workers)


class DChoices(PartialKeyGrouping):
    """D-Choices [15]: lifetime SpaceSaving heavy hitters -> d candidates.

    ``d`` is chosen per [15] as the smallest d such that the head frequency can
    be spread below the imbalance bound; we use their practical rule
    d = ceil(f_k * W / theta-bound) capped at W, matching the reference
    implementation's behaviour for skewed streams.
    """

    name = "dc"

    # batched sub-chunk size: frequencies refresh at this granularity (the
    # epoch-batching discipline of FISH applied to the D-C/W-C trackers)
    _batch_cap = 2048

    # sentinel returned by _heavy_candidates meaning "every live worker": the
    # batched selection loop dispatches on it to the global-least-loaded
    # heap instead of scanning a W-element candidate list per tuple
    _FULL_SET: List[int] = []

    def __init__(self, num_workers: int, k_max: int = 1000, theta_frac: float = 0.25):
        super().__init__(num_workers)
        # entire-lifetime tracker == Alg. 1 with alpha=1 and one giant epoch
        self.tracker = EpochFrequencyTracker(
            FishParams(alpha=1.0, epoch=2**62, k_max=k_max)
        )
        self.theta_frac = theta_frac

    @property
    def theta(self) -> float:
        """Heavy-hitter threshold theta_frac/W — tracks the worker universe
        as it grows on scale-out (same rule FISH applies per call)."""
        return self.theta_frac / self.num_workers

    def _heavy_d(self, f_k: float) -> int:
        d = int(math.ceil(f_k * self.num_workers / max(self.theta, 1e-12) ** 0.5))
        return max(2, min(d, self.num_workers))

    def assign(self, key, now: float = 0.0) -> int:
        self.tracker.update(key)
        f_k = self.tracker.frequency(key)
        if f_k > self.theta:
            cands = self._ring_prefix(key, self._heavy_d(f_k))
        else:
            cands = self._candidates(key)
        return self._record(key, self._pick_least_loaded(cands))

    # -- batched path ------------------------------------------------------------
    def _heavy_candidates(self, key: int, f_k: float) -> List[int]:
        return self._ring_prefix(key, self._heavy_d(f_k))

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        """Sub-chunked D-C/W-C: one batched SpaceSaving update per sub-chunk,
        then cumulative-count least-loaded selection with per-unique-key
        candidate arrays (frequencies are read at sub-chunk granularity —
        the bounded divergence documented in DESIGN.md §6)."""
        keys = np.asarray(keys)
        n = keys.shape[0]
        out = np.empty(n, dtype=np.int64)
        counts = self.assigned_counts.tolist()
        for lo in range(0, n, self._batch_cap):
            chunk = keys[lo : lo + self._batch_cap]
            self.tracker.update_many(chunk)
            total = sum(self.tracker.counts.values())
            uniq, inv = np.unique(chunk, return_inverse=True)
            pairs = self._pairs_for(uniq)
            cand_lists: List[Optional[List[int]]] = []
            for j, k in enumerate(uniq.tolist()):
                f_k = self.tracker.counts.get(k, 0.0) / total if total > 0 else 0.0
                if f_k > self.theta:
                    cand_lists.append(self._heavy_candidates(k, f_k))
                else:
                    cand_lists.append(None)  # light: use the PKG pair
            c0, c1 = pairs[:, 0].tolist(), pairs[:, 1].tolist()
            full_set = self._FULL_SET
            heap = None  # lazy (count, worker) min-heap for full-set argmin
            for i, j in enumerate(inv.tolist()):
                cl = cand_lists[j]
                if cl is None:
                    a, b = c0[j], c1[j]
                    w = a if counts[a] <= counts[b] else b
                elif cl is full_set:
                    # global least-loaded over the live set (W-Choices heavy
                    # hitters): a lazy heap replaces the O(W) scan;
                    # (count, idx) ordering reproduces np.argmin's
                    # smallest-index tie-breaking
                    if heap is None:
                        heap = [(counts[wk], wk) for wk in self._active]
                        heapq.heapify(heap)
                    while True:
                        ch, w = heap[0]
                        if counts[w] == ch:
                            break
                        heapq.heappop(heap)  # stale entry
                else:
                    w = min(cl, key=counts.__getitem__)
                counts[w] += 1
                if heap is not None:
                    heapq.heappush(heap, (counts[w], w))
                out[lo + i] = w
        self._record_batch(keys, out)
        return out


class WChoices(DChoices):
    """W-Choices [15]: heavy hitters may use the entire live worker set."""

    name = "wc"

    def assign(self, key, now: float = 0.0) -> int:
        self.tracker.update(key)
        f_k = self.tracker.frequency(key)
        if f_k > self.theta:
            cands = self._active
        else:
            cands = self._candidates(key)
        return self._record(key, self._pick_least_loaded(cands))

    def _heavy_candidates(self, key: int, f_k: float) -> List[int]:
        return self._FULL_SET  # sentinel: least-loaded over the live set


class FishGrouper(Grouper):
    """The paper's grouper: Alg. 1 + Alg. 2 + Alg. 3 + consistent hashing."""

    name = "fish"

    def __init__(
        self,
        num_workers: int,
        params: Optional[FishParams] = None,
        capacities: Optional[np.ndarray] = None,
        interval: float = 10.0,
        virtual_nodes: int = 64,
        use_consistent_hash: bool = True,
    ):
        super().__init__(num_workers, virtual_nodes=virtual_nodes)
        self.params = params or FishParams()
        self.tracker = EpochFrequencyTracker(self.params)
        self.estimator = WorkerStateEstimator(
            capacities=(
                np.ones(num_workers) if capacities is None else np.asarray(capacities)
            ),
            interval=interval,
        )
        self.use_consistent_hash = use_consistent_hash
        self.m_k: Dict[object, int] = {}  # CHK monotone memory M
        # mod-hash candidate cache per (key, d) — the §5 strawman path only
        self._mod_cands: Dict[tuple, List[int]] = {}

    def _mod_candidates(self, key, d: int) -> List[int]:
        """Mod-hash candidates (the §5 strawman — remaps everything on
        membership change; used for the RQ4 w/o-CH comparison)."""
        ck = (key, d)
        cands = self._mod_cands.get(ck)
        if cands is None:
            n_active = len(self._active)
            cands = self._mod_cands[ck] = list(
                {self._active[hash32((key, s)) % n_active] for s in range(d)}
            )
        return cands

    def assign(self, key, now: float = 0.0) -> int:
        self.tracker.update(key)
        theta = self.params.theta(self.num_workers)
        f_k = self.tracker.frequency(key)
        f_top = self.tracker.top_frequency()
        d, m_new = chk_num_workers(
            f_k, f_top, theta, self.num_workers, self.params.d_min,
            self.m_k.get(key, 0),
        )
        if m_new:
            self.m_k[key] = m_new
        if self.use_consistent_hash:
            candidates = self._ring_prefix(key, d)
        else:
            candidates = self._mod_candidates(key, d)
        worker = self.estimator.select(candidates, now)
        return self._record(key, worker)

    # -- batched path --------------------------------------------------------------
    def _candidates_batch(self, key: int, d: int) -> List[int]:
        if self.use_consistent_hash:
            return self._ring_prefix(key, d)
        return self._mod_candidates(key, d)

    def assign_batch(self, keys, now0: float = 0.0, dt: float = 0.0) -> np.ndarray:
        """Epoch-batched FISH: per sub-chunk one bulk Alg. 1 update, one
        vectorised Alg. 2 (CHK) pass over the chunk's unique keys, and one
        one greedy Alg. 3 allocation per unique key (an exact heap replay
        of the per-tuple Eq. 2 argmin)."""
        keys = np.asarray(keys)
        n = keys.shape[0]
        out = np.empty(n, dtype=np.int64)
        p = self.params
        est = self.estimator
        i = 0
        while i < n:
            # sub-chunk: cut at tracker epoch boundaries and estimator ticks
            now_i = now0 + i * dt
            est.maybe_estimate(now_i)
            room = p.epoch - self.tracker._tuples_in_epoch
            hi = min(n, i + (room if room > 0 else p.epoch))
            if dt > 0.0:
                tick = int(
                    math.floor((est._t_prior + est.interval - now0) / dt)
                ) + 1
                if i < tick < hi:
                    hi = tick
            chunk = keys[i:hi]
            self.tracker.update_many(chunk)
            self._assign_chunk(chunk, out[i:hi])
            i = hi
        self._record_batch(keys, out)
        return out

    def _assign_chunk(self, chunk: np.ndarray, out: np.ndarray) -> None:
        uniq, first, inv, cnt = np.unique(
            chunk, return_index=True, return_inverse=True, return_counts=True
        )
        counts = self.tracker.counts
        total = sum(counts.values())
        uniq_l = uniq.tolist()
        if total <= 0.0:
            f_u = np.zeros(uniq.shape[0])
            f_top = 0.0
        else:
            f_u = np.fromiter(
                (counts.get(k, 0.0) for k in uniq_l), dtype=np.float64,
                count=len(uniq_l),
            ) / total
            f_top = max(counts.values()) / total

        # vectorised CHK (Alg. 2) with monotone memory M_k
        m_prev = np.fromiter(
            (self.m_k.get(k, 0) for k in uniq_l), dtype=np.int64,
            count=len(uniq_l),
        )
        d_eff, m_new = chk_num_workers_batch(
            f_u, f_top, self.params.theta(self.num_workers),
            self.num_workers, self.params.d_min, m_prev,
        )
        for j in np.flatnonzero(m_new > m_prev).tolist():
            self.m_k[uniq_l[j]] = int(m_new[j])

        # Alg. 3 allocation, unique keys in first-appearance order
        # (approximates the stream-order argmin interleaving).  The estimator
        # state is pulled into scalar lists for the chunk; each key's share
        # is the exact greedy Eq. 2 replay (scalar loop for tiny
        # allocations, heap for large ones).
        pos_order = np.argsort(inv, kind="stable")
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        est = self.estimator
        b_l = est.backlog.tolist()
        a_l = est.assigned.tolist()
        p_l = est.capacities.tolist()
        cnt_l = cnt.tolist()
        d_l = d_eff.tolist()
        for j in np.argsort(first, kind="stable").tolist():
            cands = self._candidates_batch(uniq_l[j], d_l[j])
            c = cnt_l[j]
            s = starts[j]
            if c == 1:
                best = cands[0]
                bw = (b_l[best] + a_l[best]) * p_l[best]
                for cd in cands[1:]:
                    wv = (b_l[cd] + a_l[cd]) * p_l[cd]
                    if wv < bw:
                        best, bw = cd, wv
                a_l[best] += 1.0
                out[pos_order[s]] = best
            elif c * len(cands) <= 256:
                # small allocation: replay the exact sequential greedy
                # (argmin per tuple) on scalar state — cheaper than NumPy
                # setup and preserves the sequential interleaving exactly
                waits = [(b_l[cd] + a_l[cd]) * p_l[cd] for cd in cands]
                seq = []
                for _ in range(c):
                    bi = 0
                    bw = waits[0]
                    for ii in range(1, len(waits)):
                        if waits[ii] < bw:
                            bw, bi = waits[ii], ii
                    cd = cands[bi]
                    waits[bi] += p_l[cd]
                    a_l[cd] += 1.0
                    seq.append(cd)
                out[pos_order[s : s + c]] = seq
            else:
                carr = np.asarray(cands, dtype=np.int64)
                caps = np.asarray([p_l[cd] for cd in cands])
                waits = np.asarray(
                    [(b_l[cd] + a_l[cd]) * p_l[cd] for cd in cands]
                )
                alloc = greedy_allocate(waits, caps, c)
                for cd, nc in zip(cands, alloc.tolist()):
                    a_l[cd] += float(nc)
                # interleave the key's tuples across its candidates (stride
                # proportional to each share) instead of contiguous blocks —
                # keeps per-worker arrivals smooth, matching the sequential
                # argmin's alternation and its latency profile
                wk_seq = np.repeat(carr, alloc)
                frac = np.concatenate(
                    [(np.arange(nc) + 0.5) / nc for nc in alloc.tolist() if nc]
                )
                out[pos_order[s : s + c]] = wk_seq[
                    np.argsort(frac, kind="stable")
                ]
        est.assigned[: len(a_l)] = a_l

    # -- heterogeneity + elasticity hooks -----------------------------------------
    def record_capacity_sample(self, worker: int, seconds_per_tuple: float,
                               ema: float = 0.5) -> None:
        self.estimator.record_capacity_sample(worker, seconds_per_tuple, ema)

    def probe_route(self, key) -> Optional[int]:
        if self.use_consistent_hash:
            return self._ring_prefix(key, 1)[0]
        return self._active[hash32((key, 0)) % len(self._active)]

    def _grow_arrays(self, new_size: int) -> None:
        super()._grow_arrays(new_size)
        self.estimator.ensure_size(new_size)

    def _membership_caches_clear(self) -> None:
        self._mod_cands.clear()
