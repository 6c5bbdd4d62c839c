"""Windowed keyed operators over per-worker state stores.

:class:`WindowOp` declares a stateful operator on a topology stage:
tumbling or sliding count-based windows (window boundaries indexed by the
stage's *input tuple index*, so results are identical across engines and
routing schemes), one of three aggregations (``count`` / ``sum`` /
``topk``), a store backend, and a migration policy for churn.

:class:`KeyedStateManager` is the runtime: engines feed it the routed
``(keys, workers[, values])`` chunks of one grouped edge (in stream order)
and fire its membership hooks around churn events.  State is held
*pane-based*: each tuple folds into exactly one state store per
worker — the store of its slide-aligned pane — and windows are composed
from ``size/slide`` consecutive panes when they close (for tumbling
windows a pane *is* the window, so this is the identical layout).  Sliding
windows therefore cost one store update per tuple instead of
``size/slide``, and live state bytes count each pane once instead of once
per overlapping window.  Closed windows flush into :class:`WindowPartial`
records (the partial aggregates a downstream merge stage combines), and
the state-migration protocol (:mod:`repro_torch.state.migration`) runs over the
live panes on every membership change.

Because every tuple folds into exactly one worker's store with an
order-independent int64 aggregate, the *merged* per-key results are a pure
function of the input stream — independent of scheme, engine, churn and
migration policy.  That is the exactness contract ``tests/test_state.py``
enforces against the :func:`repro_torch.state.merge.direct_aggregate` oracle.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Dict, List, Optional, Tuple

import numpy as np

from .._device import resolve_device
from ..obs.trace import NULL_TRACER
from .migration import MigrationStats, apply_membership_change
from .store import (READBACKS, STORE_BACKENDS, ChunkColumns,
                    DeviceStateStore, make_store, read_stores)

__all__ = [
    "WindowOp",
    "WindowPartial",
    "PaneEntries",
    "StateReport",
    "KeyedStateManager",
    "tuple_values",
]

_MIX = np.int64(2654435761)  # Knuth multiplicative-hash constant


@dataclasses.dataclass(frozen=True)
class WindowOp:
    """A windowed keyed aggregation on a stage (count-based windows).

    agg:       "count" (tuples per key), "sum" (per-tuple payload summed
               per key) or "topk" (k heaviest keys per window by tuple
               count).
    size:      window length in tuples of the stage's input stream.
    slide:     sliding step; ``None`` means tumbling (slide == size).
               ``size`` must be a multiple of ``slide`` so window
               boundaries align with the slide grid.
    k:         top-k cut (``topk`` only).
    backend:   state-store backend ("array" | "dict").
    migration: churn policy — "migrate" ships state entries to the key's
               new owner (bytes-moved accounted); "rebuild" discards and
               replays the entry's tuples at the new owner
               (tuples-replayed accounted).  Results are exact either way.
    value:     payload for "sum" — "hashed" (deterministic pseudo-payload
               per key), "key" (the key id itself), or "payload" (the
               stream's real ``values`` column — record batches;
               folded as int64, so fractional payloads truncate).
    """

    agg: str = "count"
    size: int = 1_000
    slide: Optional[int] = None
    k: int = 8
    backend: str = "array"
    migration: str = "migrate"
    value: str = "hashed"

    def __post_init__(self) -> None:
        if self.agg not in ("count", "sum", "topk"):
            raise ValueError(f"unknown agg {self.agg!r}; "
                             f"one of ('count', 'sum', 'topk')")
        if self.size < 1:
            raise ValueError(f"window size must be >= 1, got {self.size}")
        if self.slide is not None:
            if not 1 <= self.slide <= self.size:
                raise ValueError(f"slide must be in [1, size], got "
                                 f"{self.slide}")
            if self.size % self.slide != 0:
                raise ValueError(f"size ({self.size}) must be a multiple of "
                                 f"slide ({self.slide})")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.backend not in STORE_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of "
                             f"{sorted(STORE_BACKENDS)}")
        if self.migration not in ("migrate", "rebuild"):
            raise ValueError(f"unknown migration policy {self.migration!r}; "
                             f"'migrate' or 'rebuild'")
        if self.value not in ("hashed", "key", "payload"):
            raise ValueError(f"unknown value kind {self.value!r}; "
                             f"'hashed', 'key' or 'payload'")

    @property
    def stride(self) -> int:
        return self.slide if self.slide is not None else self.size


def tuple_values(op: WindowOp, keys: np.ndarray,
                 payload: Optional[np.ndarray] = None) -> np.ndarray:
    """The per-tuple int64 contribution folded into the key's state entry.
    For ``value="hashed"``/``"key"`` a pure function of the key (so
    aggregates are independent of routing/engine/churn); for
    ``value="payload"`` the stream's real values column."""
    keys = np.asarray(keys).astype(np.int64)
    if op.agg in ("count", "topk"):
        return np.ones(keys.shape[0], dtype=np.int64)
    if op.value == "payload":
        if payload is None:
            raise ValueError(
                "WindowOp(value='payload') needs the stream's values "
                "column — feed RecordBatches with values=, or use "
                "value='hashed'/'key' for payload-free streams")
        return np.asarray(payload).astype(np.int64)
    if op.value == "key":
        return keys
    return ((keys * _MIX) & np.int64(0x7FFFFFFF)) % 97 + 1


@dataclasses.dataclass
class WindowPartial:
    """One worker's partial aggregate for one closed window: the unit the
    downstream merge stage consumes (one merge tuple per entry)."""

    window: int          # window start (input tuple index)
    worker: int
    keys: np.ndarray     # int64, sorted
    values: np.ndarray   # int64 aggregates
    counts: np.ndarray   # tuples folded per entry (replay cost)
    last_index: int      # input index of the worker's last tuple in window


class PaneEntries(Sequence):
    """One pane's entries as columns — what :meth:`KeyedStateManager.
    feed_aggregated` takes, and what :meth:`KeyedStateManager.feed` reduces
    a routed chunk to: worker ``workers[g]``'s entries are rows
    ``[starts[g], starts[g+1])`` (never empty) of ``keys`` (ascending),
    ``values`` and ``counts`` (int64), its last stream index ``last[g]``.
    It reads as the sequence of ``(worker, keys, values, counts,
    last_index)``."""

    __slots__ = ("workers", "starts", "keys", "values", "counts", "last")

    def __init__(self, workers, starts, keys, values, counts, last):
        self.workers, self.starts, self.last = workers, starts, last
        self.keys, self.values, self.counts = keys, values, counts

    @classmethod
    def routed(cls, keys: np.ndarray, workers: np.ndarray,
               values: np.ndarray, first: int) -> "PaneEntries":
        """A routed chunk reduced per (worker, key) in one pass: sorted by
        worker, then key, each run summed; tuple ``i`` has stream index
        ``first + i``."""
        order = np.lexsort((keys, workers))
        ws, ks = workers[order], keys[order]
        run = np.flatnonzero((ws[1:] != ws[:-1]) | (ks[1:] != ks[:-1])) + 1
        run = np.concatenate(([0], run))
        counts = np.diff(np.append(run, order.shape[0]))
        cut = np.flatnonzero(ws[run[1:]] != ws[run[:-1]]) + 1
        starts = np.concatenate(([0], cut, [run.shape[0]]))
        wcut = np.concatenate(([0], np.flatnonzero(ws[1:] != ws[:-1]) + 1))
        return cls(ws[wcut], starts, ks[run],
                   np.add.reduceat(values[order], run), counts,
                   first + np.maximum.reduceat(order, wcut))

    def chunks(self) -> ChunkColumns:
        return ChunkColumns(self.keys, self.values, self.counts, self.starts)

    def __len__(self) -> int:
        return self.workers.shape[0]

    def __getitem__(self, g: int):
        if not 0 <= g < len(self):
            raise IndexError(g)
        lo, hi = int(self.starts[g]), int(self.starts[g + 1])
        return (int(self.workers[g]), self.keys[lo:hi], self.values[lo:hi],
                self.counts[lo:hi], int(self.last[g]))


@dataclasses.dataclass
class StateReport:
    """Per-operator-stage state outcome (JSON-able via :meth:`summary`)."""

    stage: str
    agg: str
    backend: str
    migration_policy: str
    windows: int
    partials: int            # flushed (window, worker) partials
    partial_entries: int     # merge-stage input tuples (Σ entries)
    state_keys: int          # distinct keys aggregated over the stream
    state_bytes_peak: int    # max Σ_w store bytes over time
    state_bytes_final: int   # Σ_w store bytes at stream end (pre-flush)
    per_worker_bytes: List[int]  # per-worker peak store bytes
    migration_bytes: int
    migration_events: int
    tuples_replayed: int
    merged: Dict             # window -> {key: value} | topk [[key, count]..]

    def summary(self, include_merged: bool = True) -> Dict:
        d = dataclasses.asdict(self)
        if not include_merged:
            d.pop("merged")
        return d


class _Pane:
    """One slide-aligned block of per-worker stores: the unit every tuple
    folds into exactly once, and the unit migration moves.  (For tumbling
    windows a pane covers the whole window.)  Attribute layout matches what
    :func:`repro_torch.state.migration.apply_membership_change` walks."""

    __slots__ = ("start", "end", "stores", "last_idx")

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end
        self.stores: Dict[int, object] = {}
        self.last_idx: Dict[int, int] = {}


class KeyedStateManager:
    """Keyed operator state for one grouped edge.

    Engines drive four entry points, all in stream order:

    * :meth:`feed` — the routed (keys, workers[, values]) of the next chunk
      (the host engines);
    * :meth:`feed_aggregated` — one pane sync's :class:`PaneEntries` (the
      fused engine);
    * :meth:`on_event` — the membership observer hook (same signature as
      the engines' ``event_observer``), which runs the migration protocol;
    * :meth:`finalize` — stream end: close the remaining open windows.

    Both inputs reach the stores through one fold (:meth:`_fold`) over a
    pane's per-worker columns: one :meth:`DeviceStateStore.merge_many` for
    the device backend, a ``merge_entries`` a worker for a host backend.
    Internally state lives in panes (one per slide block); a window's
    per-worker partial is composed from its ``size/slide`` panes when the
    window closes.  Windows close in start order; once the window starting
    at pane ``p`` has flushed, no later window needs ``p`` and the pane is
    dropped — so a pane is retained for exactly ``size`` tuples, the same
    horizon the per-window layout had.

    ``tracer`` (the session's, else the null tracer) times the fused
    engine's entry: spans ``state.feed_aggregated``,
    ``state.flush_windows`` and ``state.merge_many``.
    """

    def __init__(self, op: WindowOp, device=None, tracer=NULL_TRACER):
        self.op = op
        # where "device"-backend stores live, resolved once for them all
        self.device = (resolve_device(device) if op.backend == "device"
                       else device)
        self.tracer = tracer
        self.idx = 0  # next input tuple index
        self.partials: List[WindowPartial] = []
        self.migration = MigrationStats()
        self.state_bytes_peak = 0
        self.state_bytes_final = 0
        self._per_worker_peak: Dict[int, int] = {}
        self._panes: Dict[int, _Pane] = {}
        self._next_window = 0  # start index of the next window to flush
        self._pre_routes: Optional[Dict[int, Optional[int]]] = None
        self._finalized = False
        self._seen_keys: set = set()
        self._seen_pending: List[np.ndarray] = []

    # -- bookkeeping --------------------------------------------------------------
    def _note_bytes(self) -> int:
        total = 0
        per_worker: Dict[int, int] = {}
        for pane in self._panes.values():
            for w, st in pane.stores.items():
                b = st.size_bytes()
                total += b
                per_worker[w] = per_worker.get(w, 0) + b
        for w, b in per_worker.items():
            if b > self._per_worker_peak.get(w, 0):
                self._per_worker_peak[w] = b
        if total > self.state_bytes_peak:
            self.state_bytes_peak = total
        return total

    def _flush_window(self, start: int) -> int:
        """Compose the window starting at ``start`` from its panes (one
        per-worker partial, keys sorted) and drop the panes no later
        window needs.  The stores are read through :func:`read_stores`
        (one copy a slab); returns how many."""
        size, stride = self.op.size, self.op.stride
        panes = [self._panes[p] for p in range(start, start + size, stride)
                 if p in self._panes]
        held = [(w, pane.last_idx.get(w, start), st) for pane in panes
                for w, st in pane.stores.items() if st.num_entries]
        by_worker: Dict[int, list] = {}
        for (w, last, _), cols in zip(held,
                                      read_stores([h[2] for h in held])):
            by_worker.setdefault(w, []).append((cols, last))
        for w in sorted(by_worker):
            parts = by_worker[w]
            if len(parts) == 1:
                (ks, vs, cs), last = parts[0]
            else:
                ks = np.concatenate([p[0][0] for p in parts])
                uniq, inv = np.unique(ks, return_inverse=True)
                vs = np.zeros(uniq.shape[0], dtype=np.int64)
                cs = np.zeros(uniq.shape[0], dtype=np.int64)
                np.add.at(vs, inv, np.concatenate([p[0][1] for p in parts]))
                np.add.at(cs, inv, np.concatenate([p[0][2] for p in parts]))
                ks = uniq
                last = max(p[1] for p in parts)
            self.partials.append(WindowPartial(
                window=start, worker=w, keys=ks, values=vs, counts=cs,
                last_index=last))
        self._next_window = start + stride
        for p in [p for p in self._panes if p < self._next_window]:
            del self._panes[p]
        return len(held)

    def _flush_ready(self) -> None:
        """Flush every window whose end has passed (in start order).  Span
        ``state.flush_windows``, args ``stores`` (read) and ``readbacks``
        (the device copies that made)."""
        if self._next_window + self.op.size <= self.idx:
            with self.tracer.span("state.flush_windows", cat="state") as sp:
                self._note_bytes()
                copies, stores = READBACKS["store"], 0
                while self._next_window + self.op.size <= self.idx:
                    stores += self._flush_window(self._next_window)
                sp.set(stores=stores, readbacks=READBACKS["store"] - copies)

    # -- stream input -------------------------------------------------------------
    def feed(self, keys, workers, values=None) -> None:
        """Fold the next routed chunk into the live panes' stores.
        ``keys[i]`` was routed to ``workers[i]`` (carrying payload
        ``values[i]`` when the stream has a values column); tuple ``i``
        has global input index ``self.idx + i``.  Each pane's share is
        reduced to :class:`PaneEntries` (:meth:`PaneEntries.routed`) and
        folded as a pane sync is."""
        if self._finalized:
            raise RuntimeError("KeyedStateManager already finalized")
        keys = np.asarray(keys).astype(np.int64, copy=False)
        workers = np.asarray(workers).astype(np.int64, copy=False)
        n = keys.shape[0]
        if n == 0:
            return
        self._seen_keys.update(np.unique(keys).tolist())
        values = tuple_values(self.op, keys, payload=values)
        stride = self.op.stride
        pos = 0
        while pos < n:
            self._flush_ready()
            take = min(n - pos, stride - self.idx % stride)
            self._fold(take, PaneEntries.routed(
                keys[pos:pos + take], workers[pos:pos + take],
                values[pos:pos + take], self.idx))
            pos += take

    def feed_aggregated(self, n_tuples: int, entries: PaneEntries) -> None:
        """Fused-engine input: the device engine aggregates one
        pane's (key, worker) contributions on device and syncs them here
        in bulk instead of streaming every routed chunk through
        :meth:`feed`.

        ``n_tuples`` is how many input tuples the sync covers (advances
        ``self.idx``); ``entries`` holds the sync's values already folded
        through :func:`tuple_values`.  The covered span must lie within a
        single pane (the fused engine cuts segments at pane boundaries);
        store merging accumulates, so one pane may be synced in several
        calls (e.g. around membership events)."""
        if self._finalized:
            raise RuntimeError("KeyedStateManager already finalized")
        if n_tuples == 0:
            return
        span = self.tracer.span("state.feed_aggregated", cat="state",
                                n=n_tuples, entries=len(entries))
        self._flush_ready()
        stride = self.op.stride
        if self.idx % stride + n_tuples > stride:
            end = self.idx - self.idx % stride + stride
            raise ValueError(
                f"feed_aggregated span [{self.idx}, {self.idx + n_tuples})"
                f" crosses the pane boundary at {end}; the "
                "fused engine must flush at pane boundaries")
        if len(entries):
            self._seen_pending.append(entries.keys)
        self._fold(n_tuples, entries)
        span.done()

    def _fold(self, n_tuples: int, cols: PaneEntries) -> None:
        """Fold one pane's per-worker columns into the pane's stores and
        advance ``idx`` by the ``n_tuples`` they cover: the one path into
        the stores.  The device backend folds them in one
        :meth:`DeviceStateStore.merge_many`, a host backend a
        ``merge_entries`` a worker."""
        stride = self.op.stride
        block = self.idx - self.idx % stride
        pane = self._panes.get(block)
        if pane is None:
            pane = self._panes[block] = _Pane(block, block + stride)
        if len(cols):
            stores = self._pane_stores(pane, cols)
            if self.op.backend == "device":
                DeviceStateStore.merge_many(stores, cols.chunks(),
                                            tracer=self.tracer)
            else:
                # the columns are built fresh for this fold — the store
                # may keep them without a defensive copy
                for st, (_, ks, vs, cs, _) in zip(stores, cols):
                    st.merge_entries(ks, vs, cs, own=True)
        self.idx += n_tuples

    def _pane_stores(self, pane: _Pane, cols: PaneEntries) -> list:
        """The pane's store of each worker of ``cols`` (made where it has
        none), with ``last_idx`` brought up."""
        stores, last_idx = [], pane.last_idx
        for w, last in zip(cols.workers.tolist(), cols.last.tolist()):
            st = pane.stores.get(w)
            if st is None:
                st = pane.stores[w] = make_store(self.op.backend, self.device)
            stores.append(st)
            if last > last_idx.get(w, -1):
                last_idx[w] = last
        return stores

    def _seen_count(self) -> int:
        """Distinct state keys seen.  Bulk (fused) inputs defer the set
        union — one ``np.unique`` over the accumulated arrays at metric
        time instead of per-worker set updates on the feed hot path."""
        if self._seen_pending:
            self._seen_keys.update(
                np.unique(np.concatenate(self._seen_pending)).tolist())
            self._seen_pending.clear()
        return len(self._seen_keys)

    def drain_partials(self, start: int) -> List[WindowPartial]:
        """Flush every window that has closed and return the partials
        appended since ``start`` — the incremental-emission hook: engines call this after each feed to push completed
        windows downstream instead of holding them until close."""
        self._flush_ready()
        return self.partials[start:]

    # -- membership hook (engines' event_observer signature) -----------------------
    def on_event(self, kind: str, grouper, event=None) -> None:
        if kind == "pre_membership":
            # engines fire events before feeding the post-event chunk, so a
            # window that completed exactly at the event index may still be
            # lazily unflushed — flush it first, so its partials reflect
            # pre-event ownership; panes still serving open windows are
            # live state and migrate with their keys' new owners
            self._flush_ready()
            self._pre_routes = self._snapshot_routes(grouper)
        elif kind == "post_membership":
            apply_membership_change(
                list(self._panes.values()), self._pre_routes or {}, grouper,
                self.op, self.migration, device=self.device)
            self._pre_routes = None
            self._note_bytes()
        # "capacity" events don't touch keyed state

    def _snapshot_routes(self, grouper) -> Dict[int, Optional[int]]:
        routes: Dict[int, Optional[int]] = {}
        for pane in self._panes.values():
            for st in pane.stores.values():
                ks, _, _ = st.items()
                for k in ks.tolist():
                    if k not in routes:
                        routes[k] = grouper.probe_route(k)
        return routes

    # -- stream end -----------------------------------------------------------------
    def finalize(self) -> None:
        if self._finalized:
            return
        self.state_bytes_final = self._note_bytes()
        while self._next_window < self.idx:
            self._flush_window(self._next_window)
        self._finalized = True

    # -- outputs ---------------------------------------------------------------------
    def partial_entries(self) -> Tuple[np.ndarray, np.ndarray]:
        """The merge-stage input stream: (entry keys, entry last-index) —
        one tuple per state entry, released when its worker flushed."""
        if not self.partials:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        ks = np.concatenate([p.keys for p in self.partials])
        last = np.concatenate([
            np.full(p.keys.shape[0], p.last_index, dtype=np.int64)
            for p in self.partials])
        return ks, last

    def report(self, stage: str) -> StateReport:
        from .merge import merge_partials

        if not self._finalized:
            self.finalize()
        n_workers = max(self._per_worker_peak, default=-1) + 1
        per_worker = [self._per_worker_peak.get(w, 0)
                      for w in range(n_workers)]
        return StateReport(
            stage=stage, agg=self.op.agg, backend=self.op.backend,
            migration_policy=self.op.migration,
            windows=len({p.window for p in self.partials}),
            partials=len(self.partials),
            partial_entries=int(sum(p.keys.shape[0] for p in self.partials)),
            state_keys=self._seen_count(),
            state_bytes_peak=int(self.state_bytes_peak),
            state_bytes_final=int(self.state_bytes_final),
            per_worker_bytes=per_worker,
            migration_bytes=int(self.migration.bytes_moved),
            migration_events=int(self.migration.events),
            tuples_replayed=int(self.migration.tuples_replayed),
            merged=merge_partials(self.partials, self.op),
        )
