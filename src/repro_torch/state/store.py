"""Per-worker keyed state stores.

A state store is the downstream operator's per-worker key→aggregate table —
the thing the paper's memory metric (Fig. 3/11/20) is actually *about*: SG
replicates every key's aggregation state on every worker, key grouping keeps
one copy, PKG/DC/WC/FISH split only hot keys at the cost of a downstream
merge.  ``Grouper.replicas`` only counts distinct keys per worker; these
stores hold real windowed aggregation state so state bytes, merge cost and
migration cost are *measured*, not proxied.

Three interchangeable backends behind one interface:

* :class:`DictStateStore` — plain dict, the readable reference.
* :class:`ArrayStateStore` — vectorised open-addressing table (int key ids,
  Fibonacci hashing, linear probing, tombstone deletion) whose batch update
  is one ``np.unique`` + segment-reduce (``np.add.at``) per chunk, so the
  hot path stays batched like the grouping engine.
* :class:`DeviceStateStore` — the sorted slot table and int32 accumulators
  on the torch device, folded by the ``store_probe`` kernel.

All accumulate an int64 ``value`` and an int64 ``count`` (tuples folded
into the entry — the replay cost of rebuilding it) per key, which makes
every aggregate order-independent: merged results are bit-identical no
matter how routing, churn or migration shuffled the partials.

Entry size accounting uses the logical wire size :data:`ENTRY_BYTES`
(int32 key + int64 value) for every backend so memory and migration bytes
are backend-independent and comparable across schemes.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs.trace import NULL_TRACER

__all__ = [
    "ENTRY_BYTES",
    "DictStateStore",
    "ArrayStateStore",
    "DeviceStateStore",
    "ChunkColumns",
    "READBACKS",
    "read_stores",
    "STORE_BACKENDS",
    "make_store",
]

ENTRY_BYTES = 12  # logical bytes per entry: int32 key + int64 aggregate

_EMPTY = np.int64(-1)       # slot never used
_TOMB = np.int64(-2)        # slot deleted (probe chains continue through it)
_FIB = np.uint64(0x9E3779B97F4A7C15)  # Fibonacci-hash multiplier


class DictStateStore:
    """Reference backend: ``key -> [value, count]`` in a plain dict."""

    backend = "dict"

    def __init__(self) -> None:
        self._d: Dict[int, List[int]] = {}

    # -- interface ------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        return len(self._d)

    def size_bytes(self) -> int:
        return len(self._d) * ENTRY_BYTES

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        d = self._d
        for k, v in zip(np.asarray(keys).tolist(),
                        np.asarray(values).tolist()):
            e = d.get(k)
            if e is None:
                d[k] = [int(v), 1]
            else:
                e[0] += int(v)
                e[1] += 1

    def merge_entries(self, keys: np.ndarray, values: np.ndarray,
                      counts: np.ndarray, own: bool = False) -> None:
        d = self._d
        for k, v, c in zip(keys.tolist(), values.tolist(), counts.tolist()):
            e = d.get(k)
            if e is None:
                d[k] = [int(v), int(c)]
            else:
                e[0] += int(v)
                e[1] += int(c)

    def take(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Remove ``keys`` (which must all be present) and return their
        (values, counts) — the migration extraction primitive."""
        vals = np.empty(keys.shape[0], dtype=np.int64)
        cnts = np.empty(keys.shape[0], dtype=np.int64)
        for i, k in enumerate(keys.tolist()):
            vals[i], cnts[i] = self._d.pop(k)
        return vals, cnts

    def items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, values, counts), sorted by key — the deterministic flush
        order shared by both backends."""
        ks = np.fromiter(self._d.keys(), dtype=np.int64, count=len(self._d))
        order = np.argsort(ks, kind="stable")
        ks = ks[order]
        vals = np.empty(ks.shape[0], dtype=np.int64)
        cnts = np.empty(ks.shape[0], dtype=np.int64)
        for i, k in enumerate(ks.tolist()):
            vals[i], cnts[i] = self._d[k]
        return ks, vals, cnts


class ArrayStateStore:
    """Vectorised open-addressing backend.

    Power-of-two capacity, Fibonacci hashing, linear probing.  Batch update
    is fully vectorised: one ``np.unique`` over the chunk, one segment
    reduce per column, one bulk probe.  Deletion (migration ``take``)
    leaves tombstones that probe chains walk through; a rehash clears them.
    """

    backend = "array"

    def __init__(self, capacity: int = 64) -> None:
        cap = 1 << max(int(capacity) - 1, 1).bit_length()
        self._k = np.full(cap, _EMPTY, dtype=np.int64)
        self._v = np.zeros(cap, dtype=np.int64)
        self._c = np.zeros(cap, dtype=np.int64)
        self._n = 0      # live entries
        self._used = 0   # live entries + tombstones
        # sorted-unique single-merge fast path (fused pane flush): the
        # first merge into an empty table parks here and only builds the
        # hash table if the store is ever touched again
        self._lazy = None

    # -- hashing / probing ---------------------------------------------------------
    def _home(self, keys: np.ndarray) -> np.ndarray:
        cap = self._k.shape[0]
        shift = np.uint64(64 - int(cap).bit_length() + 1)
        h = (keys.astype(np.uint64) * _FIB) >> shift
        return h.astype(np.int64) & (cap - 1)

    def _probe(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Bulk lookup of unique ``keys``.  Returns (slot, first_free):
        ``slot[i]`` is the key's slot or -1 if absent; ``first_free[i]`` is
        the first tombstone/empty slot on its probe chain (the insertion
        point)."""
        cap = self._k.shape[0]
        mask = cap - 1
        idx = self._home(keys)
        slot = np.full(keys.shape[0], -1, dtype=np.int64)
        free = np.full(keys.shape[0], -1, dtype=np.int64)
        alive = np.arange(keys.shape[0], dtype=np.int64)
        for _ in range(cap):
            cur = idx[alive]
            slotk = self._k[cur]
            found = slotk == keys[alive]
            empty = slotk == _EMPTY
            is_free = empty | (slotk == _TOMB)
            record = is_free & (free[alive] == -1)
            free[alive[record]] = cur[record]
            slot[alive[found]] = cur[found]
            done = found | empty  # empty slot terminates the chain
            alive = alive[~done]
            if alive.shape[0] == 0:
                break
            idx[alive] = (idx[alive] + 1) & mask
        return slot, free

    def _insert_new(self, keys: np.ndarray) -> np.ndarray:
        """Insert unique, known-absent ``keys``; returns their slots.
        Distinct probe chains may race for the same free slot, so losers of
        each round re-probe — every round inserts at least one key."""
        out = np.full(keys.shape[0], -1, dtype=np.int64)
        pending = np.arange(keys.shape[0], dtype=np.int64)
        while pending.shape[0]:
            _, free = self._probe(keys[pending])
            _, first = np.unique(free, return_index=True)
            winners = np.zeros(free.shape[0], dtype=bool)
            winners[first] = True
            w = pending[winners]
            ws = free[winners]
            reused_tomb = self._k[ws] == _TOMB
            self._k[ws] = keys[w]
            self._v[ws] = 0
            self._c[ws] = 0
            out[w] = ws
            self._n += int(w.shape[0])
            self._used += int(w.shape[0] - reused_tomb.sum())
            pending = pending[~winners]
        return out

    def _slots_for(self, keys: np.ndarray, insert: bool) -> np.ndarray:
        slot, _ = self._probe(keys)
        absent = slot == -1
        if absent.any():
            if not insert:
                raise KeyError(
                    f"{int(absent.sum())} keys absent from ArrayStateStore")
            slot[absent] = self._insert_new(keys[absent])
        return slot

    def _maybe_grow(self, incoming: int) -> None:
        cap = self._k.shape[0]
        if (self._used + incoming) * 10 < cap * 6:
            return
        while (self._used + incoming) * 10 >= cap * 6:
            cap *= 2
        ks, vs, cs = self.items()
        self._k = np.full(cap, _EMPTY, dtype=np.int64)
        self._v = np.zeros(cap, dtype=np.int64)
        self._c = np.zeros(cap, dtype=np.int64)
        self._n = 0
        self._used = 0
        if ks.shape[0]:
            slots = self._insert_new(ks)
            self._v[slots] = vs
            self._c[slots] = cs

    def _materialize(self) -> None:
        """Fold a parked lazy merge into the hash table (first non-flush
        access only; the tumbling-pane hot path never gets here)."""
        if self._lazy is None:
            return
        ks, vs, cs = self._lazy
        self._lazy = None
        self._maybe_grow(ks.shape[0])
        if self._used == 0 and self._bulk_fill(ks, vs, cs):
            return
        slots = self._slots_for(ks, insert=True)
        self._v[slots] += vs
        self._c[slots] += cs

    # -- interface ------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        if self._lazy is not None:
            return self._lazy[0].shape[0]
        return self._n

    def size_bytes(self) -> int:
        return self.num_entries * ENTRY_BYTES

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._materialize()
        uniq, vsum, csum = _reduce(keys, values)
        self._maybe_grow(uniq.shape[0])
        slots = self._slots_for(uniq, insert=True)
        self._v[slots] += vsum
        self._c[slots] += csum

    def merge_entries(self, keys: np.ndarray, values: np.ndarray,
                      counts: np.ndarray, own: bool = False) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.shape[0] == 0:
            return
        if (self._lazy is None and self._n == 0 and self._used == 0
                and (keys.shape[0] == 1 or bool(np.all(keys[1:] > keys[:-1])))):
            vs = np.asarray(values, dtype=np.int64)
            cs = np.asarray(counts, dtype=np.int64)
            if not own:
                # defensive copies — the caller may mutate its arrays;
                # bulk producers (the fused pane flush) hand ownership
                # over instead and skip the ~MB of memcpy per flush
                keys, vs, cs = keys.copy(), vs.copy(), cs.copy()
            self._lazy = (keys, vs, cs)
            return
        self._materialize()
        self._maybe_grow(keys.shape[0])
        if self._used == 0 and self._bulk_fill(keys, values, counts):
            return
        slots = self._slots_for(keys, insert=True)
        self._v[slots] += np.asarray(values, dtype=np.int64)
        self._c[slots] += np.asarray(counts, dtype=np.int64)

    def _bulk_fill(self, keys: np.ndarray, values: np.ndarray,
                   counts: np.ndarray) -> bool:
        """One-pass placement of unique ``keys`` into an *empty* table —
        the fused engine's pane-flush hot path (each tumbling pane store
        receives exactly one merge).  Placing in home-slot order with a
        running ``max(home, prev + 1)`` yields the same contiguous probe
        chains as sequential insertion, so later lookups are unaffected.
        Bails (False) on the rare wrap past the table end."""
        n = keys.shape[0]
        hm = self._home(keys)
        order = np.argsort(hm, kind="stable")
        h = hm[order]
        ar = np.arange(n, dtype=np.int64)
        slots = np.maximum.accumulate(h - ar) + ar
        if slots[-1] >= self._k.shape[0]:
            return False
        self._k[slots] = keys[order]
        self._v[slots] = np.asarray(values, dtype=np.int64)[order]
        self._c[slots] = np.asarray(counts, dtype=np.int64)[order]
        self._n = self._used = n
        return True

    def take(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        self._materialize()
        keys = np.asarray(keys, dtype=np.int64)
        if keys.shape[0] == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        slots = self._slots_for(keys, insert=False)
        vals = self._v[slots].copy()
        cnts = self._c[slots].copy()
        self._k[slots] = _TOMB
        self._v[slots] = 0
        self._c[slots] = 0
        self._n -= int(keys.shape[0])
        return vals, cnts

    def items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._lazy is not None:
            return self._lazy
        live = np.flatnonzero(self._k >= 0)
        ks = self._k[live]
        order = np.argsort(ks, kind="stable")
        live = live[order]
        return ks[order], self._v[live].copy(), self._c[live].copy()


#: device-to-host copies of young columns (a store's two, a slab's one),
#: counted where they are made
READBACKS = {"store": 0}

_LIM = 2 ** 31 - 1


def _reduce(keys: np.ndarray, values: np.ndarray):
    """Per-key (sorted unique keys, Σ value, tuple count) of a raw chunk,
    int64."""
    uniq, inv = np.unique(np.asarray(keys, dtype=np.int64),
                          return_inverse=True)
    vsum = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(vsum, inv, np.asarray(values, dtype=np.int64))
    csum = np.bincount(inv, minlength=uniq.shape[0]).astype(np.int64)
    return uniq, vsum, csum


class ChunkColumns(NamedTuple):
    """G reduced chunks back to back — :meth:`DeviceStateStore.merge_many`'s
    input: chunk g is rows ``[starts[g], starts[g+1])`` of the int64
    ``keys`` (sorted unique within a chunk), ``values`` and ``counts``."""

    keys: np.ndarray
    values: np.ndarray
    counts: np.ndarray
    starts: np.ndarray


class _Slab:
    """Device stores side by side in one int32 buffer ``buf``: their
    sorted tables at ``[0, n)``, young values at ``[n, 2n)`` and young
    counts at ``[2n, 3n)``, with the tables' host int64 mirror ``keys``
    (n,).  A store is rows ``[lo, hi)`` of each.  The slab of a sync
    (:meth:`DeviceStateStore.merge_many`) is that sync's upload: its
    chunks and the probe's pair description follow row ``3n``."""

    __slots__ = ("buf", "keys")

    def __init__(self, buf: torch.Tensor, keys: np.ndarray):
        self.buf, self.keys = buf, keys

    def read(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every row's young (values, counts) as host int64: one copy of
        the contiguous ``[n, 3n)``."""
        n = self.keys.shape[0]
        young = self.buf[n:3 * n].cpu().numpy().astype(np.int64)
        READBACKS["store"] += 1
        return young[:n], young[n:]


class _StoreColumns(Sequence):
    """Column ``j`` of :meth:`DeviceStateStore._rows` (1 the table, 2 the
    young values, 3 the young counts) of each of ``stores``, made when
    indexed: only the plain probe reads them, so a sync on the card makes
    no view a store."""

    __slots__ = ("stores", "j")

    def __init__(self, stores, j: int):
        self.stores, self.j = stores, j

    def __len__(self) -> int:
        return len(self.stores)

    def __getitem__(self, i):
        return self.stores[i]._rows()[self.j]


class DeviceStateStore:
    """Device-resident backend: a store is rows ``[lo, hi)`` of a
    :class:`_Slab` — its sorted slot table and int32 (value, count)
    accumulators on ``device``, and the table's sorted host int64 key
    mirror, which keeps membership checks, sizing and ``items`` ordering
    off-device — plus a host int64 lifetime base (``None``: zero).  One
    accessor, :meth:`_rows`, derives the columns from ``(slab, lo, hi)``;
    a store that has held nothing yet has no slab.  The table is strictly
    ascending by construction, which is the probe kernel's precondition.

    Folding reduced chunks is one probe/accumulate launch for any number
    of stores (:meth:`merge_many` →
    :func:`repro_torch.kernels.store_probe.store_probe_grouped` — the
    hand-written CUDA kernel on a card, its plain PyTorch version on the
    CPU; both columns of each merge in the same launch).  A store that
    gets a new table — its first keys, or keys it has not seen, around
    which the table is rebuilt — moves to that sync's slab.

    Accumulation is generational: the device columns are an int32 *young
    generation* — the kernel's probe/accumulate domain, with inputs
    range-checked per merge — and the lifetime base carries totals beyond
    int32.  A conservative running bound on the young generation's
    magnitude (the sum of per-merge chunk bounds) triggers a spill — read
    the young rows back, add them into the base, zero them in place —
    strictly before any element could reach 2³¹−1, so lifetime aggregates
    stay exact at 10⁸-tuple scale.  ``items``/``take``/:func:`read_stores`
    return base + young.

    ``device``: ``None`` means ``"cuda"`` (raises without a card); pass
    ``"cpu"`` to run the plain versions."""

    backend = "device"
    __slots__ = ("device", "_slab", "_lo", "_hi", "_base_v", "_base_c",
                 "_young_bound")

    def __init__(self, device=None) -> None:
        # a torch.device is taken as resolved (a manager resolves its
        # device once for all its stores)
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self._slab = None  # the _Slab its rows are in; None: it holds none
        self._lo = self._hi = 0  # those rows
        self._base_v = self._base_c = None  # lifetime base, None: zero
        self._young_bound = 0  # ≥ max |young element|, per-merge accumulated

    def _rows(self):
        """The store's rows of its slab: (host keys, table, young values,
        young counts), views."""
        slab, lo, hi = self._slab, self._lo, self._hi
        n, buf = slab.keys.shape[0], slab.buf
        return (slab.keys[lo:hi], buf[lo:hi], buf[n + lo:n + hi],
                buf[2 * n + lo:2 * n + hi])

    def _with_base(self, v: np.ndarray, c: np.ndarray):
        """Young (values, counts) read back, plus the lifetime base."""
        if self._base_v is None:
            return v, c
        return self._base_v + v, self._base_c + c

    # -- interface ------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        return self._hi - self._lo

    def size_bytes(self) -> int:
        return self.num_entries * ENTRY_BYTES

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.merge_entries(*_reduce(keys, values))

    def merge_entries(self, keys: np.ndarray, values: np.ndarray,
                      counts: np.ndarray, own: bool = False) -> None:
        cols = [np.asarray(a, dtype=np.int64) for a in (keys, values, counts)]
        DeviceStateStore.merge_many([self], ChunkColumns(
            *cols, np.array([0, cols[0].shape[0]], dtype=np.int64)))

    @staticmethod
    def merge_many(stores, chunks: ChunkColumns,
                   tracer=NULL_TRACER) -> None:
        """Fold one reduced chunk into each of ``stores`` — a whole pane
        sync — with one packed upload and one probe launch.

        ``chunks`` holds chunk ``g`` for ``stores[g]``: int columns, keys
        sorted unique (every caller guarantees it); each store appears at
        most once.  The range checks and chunk bounds run on the whole
        columns.  A store that holds keys (warm) runs its young
        generation's spill guard and checks its chunk against its key
        mirror.  Every store that gets a new table goes on this sync's
        :class:`_Slab`: a fresh one (its table is its chunk's keys,
        already sorted; no call a store) and a warm one meeting unseen
        keys (the union; its young columns are carried over on the device
        and its base re-indexed).  A warm store that meets no new key
        stays on its slab.  One copy moves the new tables with their
        zeroed young columns — ``[fresh tables | rebuilt tables | young
        values | young counts]`` — then the chunks' keys, values and
        counts, and the kernel's pair description to the device, and one
        ``store_probe_grouped`` launch adds both columns of every merge
        into the young generation.  ``tracer`` times the call (span
        ``state.merge_many``, args ``stores`` and ``slab``: the stores
        placed on the slab) and the packed upload
        (``state.merge_many.upload``)."""
        from ..kernels.store_probe import (meta_from_pointers,
                                           store_probe_grouped)

        span = tracer.span("state.merge_many", cat="state", stores=len(stores))
        keys, vals, cnts, starts = chunks
        lens = np.diff(starts)
        if not lens.all():  # an empty chunk folds nothing
            live = lens > 0
            stores = [st for st, on in zip(stores, live.tolist()) if on]
            lens = lens[live]
            starts = np.concatenate(([0], np.cumsum(lens)))
        g = len(stores)
        if g == 0:
            span.set(slab=0).done()
            return
        if keys.min() < 0 or keys.max() > _LIM:
            raise ValueError(
                "DeviceStateStore keys must fit int32 (got range "
                f"[{keys.min()}, {keys.max()}])")
        bounds = np.maximum.reduceat(np.maximum(np.abs(vals), np.abs(cnts)),
                                     starts[:-1])
        if bounds.max() > _LIM:
            raise ValueError("DeviceStateStore accumulates in int32; chunk "
                             "aggregates exceed its range")
        device = stores[0].device
        if any(st.device is not device and st.device != device
               for st in stores):
            raise ValueError("merge_many: stores on more than one device")
        fresh = np.array([not st.num_entries for st in stores], dtype=bool)

        sl, bl = starts.tolist(), bounds.tolist()
        kept, rebuilt = [], []  # warm stores; rebuilt: (index, union)
        for i in np.flatnonzero(~fresh).tolist():
            st = stores[i]
            # spill young → base before this chunk could push any young
            # element past int32 (each merge adds ≤ its bound per element)
            if st._young_bound + bl[i] > _LIM:
                st._spill()
            st._young_bound += bl[i]
            union = np.union1d(st._rows()[0], keys[sl[i]:sl[i + 1]])
            if union.shape[0] == st.num_entries:
                kept.append(i)
            else:
                rebuilt.append((i, union))

        # the stores that get a new table, fresh ones first, and their
        # rows of this sync's slab
        f_idx = np.flatnonzero(fresh)
        on_slab = np.concatenate(
            [f_idx, np.array([i for i, _ in rebuilt], dtype=np.int64)])
        t_len = np.concatenate([lens[f_idx], np.array(
            [u.shape[0] for _, u in rebuilt], dtype=np.int64)])
        t_hi = np.cumsum(t_len)
        t_lo = t_hi - t_len
        n_tok = keys.shape[0]
        tables = keys if fresh.all() else keys[np.repeat(fresh, lens)]
        if rebuilt:
            tables = np.concatenate([tables] + [u for _, u in rebuilt])
        width = tables.shape[0]
        at_keys = 3 * width
        at_meta = at_keys + 3 * n_tok
        at_meta += at_meta % 2  # 8-byte aligned
        buf = torch.empty(at_meta + 2 * (5 * g + 1), dtype=torch.int32,
                          device=device)
        host = np.empty(buf.shape[0], dtype=np.int32)
        host[:width] = tables
        host[width:at_keys] = 0
        for j, col in enumerate((keys, vals, cnts)):
            host[at_keys + j * n_tok:at_keys + (j + 1) * n_tok] = col
        host[at_keys + 3 * n_tok:at_meta] = 0
        # every store's rows: its slab's address and height, lo, hi
        addr, height, lo, hi = (np.empty(g, dtype=np.int64) for _ in range(4))
        addr[on_slab], height[on_slab] = buf.data_ptr(), width
        lo[on_slab], hi[on_slab] = t_lo, t_hi
        for i in kept:
            st = stores[i]
            addr[i] = st._slab.buf.data_ptr()
            height[i] = st._slab.keys.shape[0]
            lo[i], hi[i] = st._lo, st._hi
        host[at_meta:] = meta_from_pointers(
            addr + 4 * lo, hi - lo, starts, addr + 4 * (height + lo),
            addr + 4 * (2 * height + lo)).view(np.int32)
        with tracer.span("state.merge_many.upload", cat="state",
                         bytes=host.nbytes):
            buf.copy_(torch.from_numpy(host))
        slab = _Slab(buf, tables)
        n_f = f_idx.shape[0]
        for i, a, b in zip(f_idx.tolist(), t_lo.tolist(), t_hi.tolist()):
            st = stores[i]
            st._slab, st._lo, st._hi, st._young_bound = slab, a, b, bl[i]
            st._base_v = st._base_c = None
        for (i, _), a, b in zip(rebuilt, t_lo[n_f:].tolist(),
                                t_hi[n_f:].tolist()):
            stores[i]._move(slab, a, b)
        store_probe_grouped(
            _StoreColumns(stores, 1), buf[at_keys:at_keys + n_tok],
            buf[at_keys + n_tok:at_keys + 2 * n_tok],
            buf[at_keys + 2 * n_tok:at_keys + 3 * n_tok], starts,
            _StoreColumns(stores, 2), _StoreColumns(stores, 3),
            meta=buf[at_meta:].view(torch.int64), slab=buf)
        span.set(slab=int(on_slab.shape[0])).done()

    def _move(self, slab: _Slab, lo: int, hi: int) -> None:
        """Make rows ``[lo, hi)`` of ``slab`` — a table of every key the
        store holds and more, young columns zeroed — the store's: its
        young columns are carried over on the device, its base
        re-indexed."""
        keys, tab, v, c = self._rows()
        self._slab, self._lo, self._hi = slab, lo, hi
        new_keys, new_tab, new_v, new_c = self._rows()
        idx = torch.searchsorted(new_tab, tab)
        new_v[idx] = v
        new_c[idx] = c
        if self._base_v is not None:
            pos = np.searchsorted(new_keys, keys)
            bv, bc = np.zeros((2, hi - lo), dtype=np.int64)
            bv[pos], bc[pos] = self._base_v, self._base_c
            self._base_v, self._base_c = bv, bc

    def _young(self):
        """The young generation read back as host int64 columns."""
        _, _, v, c = self._rows()
        READBACKS["store"] += 2
        return (v.cpu().numpy().astype(np.int64),
                c.cpu().numpy().astype(np.int64))

    def _spill(self) -> None:
        """Add the int32 young generation into the int64 lifetime base and
        zero its rows in place (two readbacks; amortized over
        ~2³¹/chunk_bound merges)."""
        self._base_v, self._base_c = self._with_base(*self._young())
        _, _, v, c = self._rows()
        v.zero_()
        c.zero_()
        self._young_bound = 0

    def take(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Remove ``keys`` (all present) and return their lifetime (values,
        counts); the rest of the store moves to a slab of its own."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.shape[0] == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        hk = (self._rows()[0] if self.num_entries
              else np.empty(0, dtype=np.int64))
        ok = np.isin(keys, hk)
        if not ok.all():
            raise KeyError(
                f"{int((~ok).sum())} keys absent from DeviceStateStore")
        pos = np.searchsorted(hk, keys)
        v, c = self._young()
        bv, bc = self._with_base(v, c)
        vals, cnts = bv[pos], bc[pos]
        keep = np.ones(hk.shape[0], dtype=bool)
        keep[pos] = False
        hk, v, c = hk[keep], v[keep], c[keep]
        self._slab = _Slab(torch.from_numpy(np.concatenate(
            [hk, v, c]).astype(np.int32)).to(self.device), hk)
        self._lo, self._hi = 0, hk.shape[0]
        if self._base_v is not None:
            self._base_v, self._base_c = self._base_v[keep], self._base_c[keep]
        return vals, cnts

    def items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.num_entries == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        return (self._rows()[0].copy(), *self._with_base(*self._young()))


def read_stores(stores) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each store's ``items()``, any backend: a device store from one copy
    of its slab's young columns (:meth:`_Slab.read`, once for all the
    stores read on that slab) plus its base; a host-backend store by its
    own ``items()``."""
    reads = {}
    out = []
    for st in stores:
        if not isinstance(st, DeviceStateStore) or not st.num_entries:
            out.append(st.items())
            continue
        slab, lo, hi = st._slab, st._lo, st._hi
        young = reads.get(slab)
        if young is None:
            young = reads[slab] = slab.read()
        out.append((slab.keys[lo:hi],
                    *st._with_base(young[0][lo:hi], young[1][lo:hi])))
    return out


STORE_BACKENDS = {"dict": DictStateStore, "array": ArrayStateStore,
                  "device": DeviceStateStore}


def make_store(backend: str, device=None):
    """A fresh store of ``backend``; ``device`` only reaches the device
    backend (``None`` = ``"cuda"``)."""
    if backend == "device":
        return DeviceStateStore(device=device)
    try:
        return STORE_BACKENDS[backend]()
    except KeyError:
        raise ValueError(f"unknown state-store backend {backend!r}; one of "
                         f"{sorted(STORE_BACKENDS)}")
