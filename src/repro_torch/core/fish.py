"""FISH epoch-based recent hot-key identification (paper Alg. 1 + Alg. 2).

:class:`EpochFrequencyTracker` is the paper-faithful *sequential* host-side
implementation: per-tuple SpaceSaving with replace-min (count inherited from
the evicted minimum, Alg. 1 lines 19-22) and per-epoch time decay
(``TimeDecayingUpdate``, lines 23-26).  :func:`chk_num_workers` and
:func:`chk_num_workers_batch` are Alg. 2 (CHK), scalar and vectorised.

The device form: :class:`FishState` (the bounded counter table as torch
tensors), :func:`epoch_update` (one whole epoch through the table, its
match-count through the ``fish_count`` or ``fish_epoch_count`` kernel of
:mod:`repro_torch.kernels.ops`, or the whole epoch through
``fish_epoch_update``) and :func:`classify_hot_keys`
(CHK over the whole table).  The fused engine keeps its own dense device
tracker (:mod:`repro_torch.kernels.feed_fused`).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.fish_count import compose_epoch
from ..kernels.ops import fish_count

__all__ = [
    "FishParams",
    "EpochFrequencyTracker",
    "chk_num_workers",
    "chk_num_workers_batch",
    "FishState",
    "init_fish_state",
    "epoch_update",
    "classify_hot_keys",
]


# ---------------------------------------------------------------------------
# Parameters (defaults follow the paper's §6.3 recommendations)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FishParams:
    """Tunables of FISH (paper Table 1 + §6.3).

    alpha:   inter-epoch time decaying factor (paper default 0.2).
    epoch:   number of sequential tuples per epoch, ``N_epoch`` (default 1000).
    k_max:   capacity of the bounded counter set ``K`` (default 1000).
    theta_frac: hot-key threshold as a fraction of ``2/n``; the paper settles
        on θ = 1/(4n) for n workers, i.e. ``theta = theta_frac / num_workers``
        with ``theta_frac = 0.25``.
    d_min:   minimal number of workers for a hot key (Alg. 2).
    """

    alpha: float = 0.2
    epoch: int = 1000
    k_max: int = 1000
    theta_frac: float = 0.25
    d_min: int = 2

    def theta(self, num_workers: int) -> float:
        return self.theta_frac / float(num_workers)


# ---------------------------------------------------------------------------
# Host-side, paper-faithful sequential tracker (Alg. 1)
# ---------------------------------------------------------------------------


class EpochFrequencyTracker:
    """Sequential SpaceSaving-with-decay tracker — exact Alg. 1.

    ``update(key)`` processes one tuple; every ``epoch`` tuples all counters
    are multiplied by ``alpha`` *before* the tuple is counted (Alg. 1 lines
    4-7 run at the top of the loop body).

    ``epoch_observer``: an optional ``f(tracker)`` fired right
    after each TimeDecayingUpdate (``epochs_completed`` already advanced) —
    the telemetry hook for per-epoch hot-set/churn timelines.  Decay is a
    uniform scaling, so the relative frequencies the observer reads are
    those the epoch ended with.
    """

    def __init__(self, params: FishParams):
        self.params = params
        self.counts: Dict[object, float] = {}
        self._tuples_in_epoch = 0
        self.total_seen = 0
        self.epochs_completed = 0
        self.epoch_observer = None

    # -- Alg. 1 main loop body -------------------------------------------------
    def update(self, key) -> None:
        p = self.params
        if self._tuples_in_epoch == p.epoch:
            self._time_decaying_update()
            self._tuples_in_epoch = 0
            self.epochs_completed += 1
            if self.epoch_observer is not None:
                self.epoch_observer(self)
        counts = self.counts
        if key in counts:
            counts[key] += 1.0
        elif len(counts) < p.k_max:
            counts[key] = 1.0
        else:
            self._replace_min(key)
        self._tuples_in_epoch += 1
        self.total_seen += 1

    def update_many(self, keys: Sequence) -> None:
        """Bulk Alg. 1 over epoch-aligned chunks.

        Instead of one Python call per tuple, each epoch-sized chunk is one
        ``np.unique`` count plus a single batched ReplaceMin — the host mirror
        of :func:`epoch_update`.  Exact while the table is under capacity;
        at capacity it is the same epoch-batched approximation the device
        path uses (bounded divergence, see DESIGN.md §4/§6).
        """
        arr = np.asarray(keys)
        if arr.ndim != 1 or arr.dtype.kind not in "iu":
            for k in keys:  # non-integer keys: exact sequential path
                self.update(k)
            return
        p = self.params
        n = arr.shape[0]
        i = 0
        while i < n:
            if self._tuples_in_epoch == p.epoch:
                self._time_decaying_update()
                self._tuples_in_epoch = 0
                self.epochs_completed += 1
                if self.epoch_observer is not None:
                    self.epoch_observer(self)
            take = min(n - i, p.epoch - self._tuples_in_epoch)
            self._update_chunk(arr[i : i + take])
            self._tuples_in_epoch += take
            self.total_seen += take
            i += take

    def _update_chunk(self, chunk: np.ndarray) -> None:
        """One intra-epoch bulk count + batched ReplaceMin."""
        uniq, cnt = np.unique(chunk, return_counts=True)
        counts = self.counts
        new_keys: List[int] = []
        new_cnts: List[int] = []
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            if k in counts:
                counts[k] += float(c)
            else:
                new_keys.append(k)
                new_cnts.append(c)
        if not new_keys:
            return
        order = np.argsort(-np.asarray(new_cnts), kind="stable")
        free = self.params.k_max - len(counts)
        for j in order[:free].tolist():  # fill empty slots, hottest first
            counts[new_keys[j]] = float(new_cnts[j])
        rest = order[free:]
        if rest.size == 0:
            return
        # batched ReplaceMin: the m hottest remaining candidates evict the m
        # smallest counters, each inheriting c_min + its epoch frequency
        # (Alg. 1 line 22 generalised to a batch).
        m = min(rest.size, self.params.k_max)
        victims = heapq.nsmallest(m, counts.items(), key=lambda kv: kv[1])
        for (k_old, c_old), j in zip(victims, rest[:m].tolist()):
            del counts[k_old]
            counts[new_keys[j]] = c_old + float(new_cnts[j])

    # -- Alg. 1 ReplaceMin -----------------------------------------------------
    def _replace_min(self, key) -> None:
        k_min = min(self.counts, key=self.counts.get)
        c_min = self.counts.pop(k_min)
        # "its occurrence number is set to that of replaced ones plus 1"
        self.counts[key] = c_min + 1.0

    # -- Alg. 1 TimeDecayingUpdate ----------------------------------------------
    def _time_decaying_update(self) -> None:
        a = self.params.alpha
        if a == 0.0:
            self.counts.clear()
            return
        for k in self.counts:
            self.counts[k] *= a

    # -- queries ----------------------------------------------------------------
    def frequency(self, key) -> float:
        """Relative frequency estimate f_k (counter / Σ counters)."""
        total = sum(self.counts.values())
        if total <= 0.0:
            return 0.0
        return self.counts.get(key, 0.0) / total

    def frequencies(self) -> Dict[object, float]:
        total = sum(self.counts.values())
        if total <= 0.0:
            return {k: 0.0 for k in self.counts}
        return {k: c / total for k, c in self.counts.items()}

    def top_frequency(self) -> float:
        total = sum(self.counts.values())
        if total <= 0.0:
            return 0.0
        return max(self.counts.values()) / total

    def hot_keys(self, num_workers: int) -> Dict[object, float]:
        theta = self.params.theta(num_workers)
        return {k: f for k, f in self.frequencies().items() if f > theta}


# ---------------------------------------------------------------------------
# CHK — Classification of Hot Key (Alg. 2), scalar host form
# ---------------------------------------------------------------------------


def chk_num_workers(
    f_k: float,
    f_top: float,
    theta: float,
    num_workers: int,
    d_min: int = 2,
    m_k: int = 0,
) -> Tuple[int, int]:
    """Alg. 2: number of candidate workers ``d`` for a key with frequency f_k.

    Returns ``(d, new_m_k)``; ``m_k`` is the per-key monotone memory ``M_k``.
    Non-hot keys (f_k <= theta) get d = 2 (PKG fallback) and M_k unchanged.
    """
    if f_k <= theta or f_k <= 0.0 or f_top <= 0.0:
        return 2, m_k
    # index = floor(log2(f_top / f_k)); d = W / 2^index
    index = int(math.floor(math.log2(max(f_top / f_k, 1.0))))
    d = num_workers // (2**index) if index < 63 else 0
    d = max(d, d_min)
    d = min(d, num_workers)
    if m_k < d:
        m_k = d
    else:
        d = m_k
    return d, m_k


def chk_num_workers_batch(
    f_k: np.ndarray,
    f_top: float,
    theta: float,
    num_workers: int,
    d_min: int = 2,
    m_k: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised :func:`chk_num_workers` over an array of frequencies.

    Element-for-element identical to the scalar form (property-tested);
    the batched grouping engine runs it once per sub-chunk over the chunk's
    unique keys.  Returns ``(d, new_m_k)`` as int64 arrays.
    """
    f_k = np.asarray(f_k, dtype=np.float64)
    if m_k is None:
        m_k = np.zeros(f_k.shape[0], dtype=np.int64)
    hot = (f_k > theta) & (f_k > 0.0) & (f_top > 0.0)
    ratio = np.maximum(f_top / np.maximum(f_k, 1e-300), 1.0)
    index = np.floor(np.log2(ratio))
    # W // 2**index via exact power-of-two float division; index >= 63 -> 0
    d = np.where(index < 63,
                 np.floor(num_workers / np.exp2(np.minimum(index, 63))), 0.0)
    d = np.clip(d, d_min, num_workers).astype(np.int64)
    new_m_k = np.where(hot, np.maximum(m_k, d), m_k)
    d = np.where(hot, np.maximum(d, m_k), 2)
    return d, new_m_k


# ---------------------------------------------------------------------------
# Device-side state + epoch-batched update (torch)
# ---------------------------------------------------------------------------


class FishState(dict):
    """The bounded counter table on the device.

    keys:   (k_max,) int32   — key ids, -1 for empty slots
    counts: (k_max,) float32 — decayed occurrence counters
    """

    def __init__(self, keys, counts):
        super().__init__(keys=keys, counts=counts)


def init_fish_state(k_max: int, device=None) -> FishState:
    """An empty table on ``device`` (``None`` = ``cuda``)."""
    from .._device import resolve_device

    dev = resolve_device(device)
    return FishState(
        keys=torch.full((k_max,), -1, dtype=torch.int32, device=dev),
        counts=torch.zeros((k_max,), dtype=torch.float32, device=dev))


def epoch_update(
    state: FishState,
    batch_keys: torch.Tensor,
    *,
    alpha: float,
    max_new: int = 64,
    match_fn=None,
    fused_fn=None,
    epoch_fn=None,
) -> FishState:
    """Process one epoch of keys through the bounded counter table.

    Device-side analog of Alg. 1 with epoch-batched ReplaceMin:

    1. inter-epoch decay:   counts *= alpha
    2. intra-epoch counting: counts[k] += #occurrences for keys already in K
       (the O(N·K_max) hotspot — ``match_fn`` defaults to
       ``repro_torch.kernels.ops.fish_count``: the kernel on the card, its
       plain version on the CPU)
    3. batched ReplaceMin: the ``max_new`` most frequent *unmatched* keys of
       this epoch replace the ``max_new`` smallest counters (empty slots
       count 0); each inserted key inherits ``c_min + its epoch frequency``
       (Alg. 1 line 22 generalised to a batch).

    ``fused_fn`` (``repro_torch.kernels.ops.fish_epoch_count``) does steps
    1-2 *and* the candidate histogram in one launch.  The two paths break
    ties among equally frequent candidates as the reference's do: the fused
    one by the token position of a key's first occurrence, the unfused one
    by ascending key (:func:`repro_torch.kernels.fish_count.compose_epoch`).

    ``epoch_fn`` (``repro_torch.kernels.ops.fish_epoch_update``, which
    breaks ties as the fused path; bind ``ties="key"`` with
    ``functools.partial`` for the unfused path's rule) is the whole epoch:
    ``epoch_fn(keys, counts, batch_keys, alpha=, max_new=)`` returns the
    new table.  It excludes ``match_fn`` and ``fused_fn``.

    ``batch_keys``: (n,) int32 key ids (>= 0).  Returns a new state.
    """
    if epoch_fn is not None:
        if match_fn is not None or fused_fn is not None:
            raise TypeError("epoch_update: epoch_fn is the whole epoch; it "
                            "takes no match_fn or fused_fn")
        keys, counts = epoch_fn(state["keys"], state["counts"], batch_keys,
                                alpha=alpha, max_new=max_new)
    else:
        keys, counts = compose_epoch(state["keys"], state["counts"],
                                     batch_keys, alpha=alpha,
                                     max_new=max_new, fused_fn=fused_fn,
                                     match_fn=match_fn or fish_count)
    return FishState(keys=keys, counts=counts)


def classify_hot_keys(
    state: FishState,
    *,
    num_workers: int,
    theta: float,
    d_min: int = 2,
    m_k: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised CHK (Alg. 2) over the whole table.

    Returns ``(d, is_hot, new_m_k)`` — per-slot candidate-worker counts
    (non-hot slots get 2), hotness mask, and the updated monotone memory.
    """
    counts = state["counts"]
    total = torch.clamp(counts.sum(), min=1e-30)
    f = counts / total
    f_top = f.max()
    is_hot = f > theta
    ratio = torch.clamp(f_top / torch.clamp(f, min=1e-30), min=1.0)
    # log2 as the reference computes it: log(x) / log(2) in float32
    log2 = torch.log(ratio) / torch.log(torch.tensor(
        2.0, dtype=torch.float32, device=counts.device))
    index = torch.clamp(torch.floor(log2).to(torch.int32), 0, 30)
    d = (num_workers // torch.pow(2, index)).to(torch.int32)
    d = torch.clamp(d, min=d_min, max=num_workers)
    if m_k is None:
        m_k = torch.zeros_like(d)
    new_m_k = torch.where(is_hot, torch.maximum(m_k, d), m_k)
    d = torch.where(is_hot, torch.maximum(d, m_k), 2)
    return d, is_hot, new_m_k
