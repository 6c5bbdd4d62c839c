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
        uniq, inv = np.unique(np.asarray(keys, dtype=np.int64),
                              return_inverse=True)
        vsum = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(vsum, inv, np.asarray(values, dtype=np.int64))
        csum = np.bincount(inv, minlength=uniq.shape[0]).astype(np.int64)
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

_COLUMNS = ("_host_keys", "_keys", "_v", "_c", "_base_v", "_base_c")
_LIM = 2 ** 31 - 1


class ChunkColumns(NamedTuple):
    """G reduced chunks back to back — :meth:`DeviceStateStore.merge_many`'s
    input: chunk g is rows ``[starts[g], starts[g+1])`` of the int64
    ``keys`` (sorted unique within a chunk), ``values`` and ``counts``."""

    keys: np.ndarray
    values: np.ndarray
    counts: np.ndarray
    starts: np.ndarray

    @classmethod
    def of(cls, chunks) -> "ChunkColumns":
        """From a sequence of ``(keys, values, counts)``: one concatenation
        a column."""
        cols = [[np.asarray(c[j], dtype=np.int64) for c in chunks]
                for j in range(3)]
        starts = np.zeros(len(chunks) + 1, dtype=np.int64)
        np.cumsum([k.shape[0] for k in cols[0]], out=starts[1:])
        return cls(*(np.concatenate(c) if c else np.empty(0, np.int64)
                     for c in cols), starts)


class _Slab:
    """The fresh stores of one pane sync, side by side in the sync's upload
    ``buf`` (:meth:`DeviceStateStore.merge_many`): their tables at ``[0,
    n)``, young values at ``[width, width + n)`` and young counts at ``[2
    width, 2 width + n)`` — ``width`` counts every new table of the sync,
    the fresh stores' first — and their sorted host key mirrors back to
    back in ``keys`` (n,).  A store on the slab owns rows ``[lo, hi)`` of
    each and has a zero base: whatever would give it a base or a new table
    takes it off first (:meth:`DeviceStateStore._own_columns`)."""

    __slots__ = ("buf", "width", "keys")

    def __init__(self, buf: torch.Tensor, width: int, keys: np.ndarray):
        self.buf, self.width, self.keys = buf, width, keys

    def read(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every slab row's young (values, counts) as host int64: one copy
        of the contiguous ``[width, 2 width + n)``."""
        n, w = self.keys.shape[0], self.width
        young = self.buf[w:2 * w + n].cpu().numpy().astype(np.int64)
        READBACKS["store"] += 1
        return young[:n], young[w:w + n]


class _StoreColumns(Sequence):
    """One device column (``"_keys"``, ``"_v"`` or ``"_c"``) of each of
    ``stores``, fetched when indexed: only the plain probe reads them."""

    __slots__ = ("stores", "name")

    def __init__(self, stores, name: str):
        self.stores, self.name = stores, name

    def __len__(self) -> int:
        return len(self.stores)

    def __getitem__(self, i):
        return getattr(self.stores[i], self.name)


class DeviceStateStore:
    """Device-resident backend: the sorted slot table and int32
    (value, count) accumulators live as torch tensors on ``device``, and
    folding reduced chunks is one probe/accumulate launch for any number
    of stores (:meth:`merge_many` →
    :func:`repro_torch.kernels.store_probe.store_probe_grouped` — the
    hand-written CUDA kernel on a card, its plain PyTorch version on the
    CPU; both columns of each merge in the same launch).  A sorted
    host int64 key mirror keeps membership checks, sizing and ``items``
    ordering off-device; inserting unseen keys rebuilds the device table
    around them (the open-addressing slow path — rare once the key set is
    warm).  The table is strictly ascending by construction, which is the
    probe kernel's precondition.

    Accumulation is generational: the device tensors are an int32 *young
    generation* — the kernel's probe/accumulate domain, with inputs
    range-checked per merge — and a host int64 *lifetime base*
    (``_base_v``/``_base_c``) carries totals beyond int32.  A conservative
    running bound on the young generation's magnitude (the sum of per-merge
    chunk bounds) triggers a spill — read the young columns back, add into
    the base, zero the device tensors — strictly before any element could
    reach 2³¹−1, so lifetime aggregates stay exact at 10⁸-tuple scale.
    ``items``/``take`` return base + young.

    The stores a sync meets empty go on one slab (:class:`_Slab`): their
    columns are rows of the sync's upload and of one host key array, made
    into the attributes ``_host_keys``, ``_keys``, ``_v``, ``_c``,
    ``_base_v``, ``_base_c`` only when first read (:meth:`__getattr__`),
    and :func:`read_stores` reads a slab's young columns back in one copy.

    ``device``: ``None`` means ``"cuda"`` (raises without a card); pass
    ``"cpu"`` to run the plain versions."""

    backend = "device"

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._slab = None  # the _Slab this store's columns are rows of
        self._lo = self._hi = 0  # those rows
        self._young_bound = 0  # ≥ max |young element|, per-merge accumulated

    @classmethod
    def many(cls, n: int, device=None) -> List["DeviceStateStore"]:
        """``n`` fresh stores on one device, resolved once."""
        dev = resolve_device(device)
        stores = [cls.__new__(cls) for _ in range(n)]
        for st in stores:
            st.device, st._slab, st._lo, st._hi = dev, None, 0, 0
            st._young_bound = 0
        return stores

    def __getattr__(self, name: str):
        # a column not made yet: empty for a store that holds nothing, else
        # views of its slab rows (and a zero base)
        if name not in _COLUMNS:
            raise AttributeError(name)
        d = self.__dict__
        slab = d.get("_slab")
        if slab is None:
            d.update(_host_keys=np.empty(0, dtype=np.int64), _keys=None,
                     _v=None, _c=None, _base_v=np.empty(0, dtype=np.int64),
                     _base_c=np.empty(0, dtype=np.int64))
        else:
            lo, hi, w, buf = d["_lo"], d["_hi"], slab.width, slab.buf
            d.update(_host_keys=slab.keys[lo:hi], _keys=buf[lo:hi],
                     _v=buf[w + lo:w + hi], _c=buf[2 * w + lo:2 * w + hi],
                     _base_v=np.zeros(hi - lo, dtype=np.int64),
                     _base_c=np.zeros(hi - lo, dtype=np.int64))
        return d[name]

    def _own_columns(self) -> None:
        """Take the store off its slab before its columns change (a spill,
        a rebuild, ``take``): its attributes stay views of the slab rows
        until replaced, and the slab's readback no longer serves it."""
        if self._slab is not None:
            if "_keys" not in self.__dict__:
                self.__getattr__("_keys")
            self._slab = None

    # -- interface ------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        if self._slab is not None:
            return self._hi - self._lo
        hk = self.__dict__.get("_host_keys")
        return 0 if hk is None else int(hk.shape[0])

    def size_bytes(self) -> int:
        return self.num_entries * ENTRY_BYTES

    @staticmethod
    def reduce_chunk(keys: np.ndarray, values: np.ndarray):
        """Per-key (sorted unique keys, Σ value, tuple count) of a raw
        chunk, int64 — what :meth:`merge_many` folds."""
        uniq, inv = np.unique(np.asarray(keys, dtype=np.int64),
                              return_inverse=True)
        vsum = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(vsum, inv, np.asarray(values, dtype=np.int64))
        csum = np.bincount(inv, minlength=uniq.shape[0]).astype(np.int64)
        return uniq, vsum, csum

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        DeviceStateStore.merge_many([self], [self.reduce_chunk(keys, values)])

    def merge_entries(self, keys: np.ndarray, values: np.ndarray,
                      counts: np.ndarray, own: bool = False) -> None:
        DeviceStateStore.merge_many([self], [(keys, values, counts)])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host int column → device int32 (the caller range-checked it)."""
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    @staticmethod
    def merge_many(stores, chunks, tracer=NULL_TRACER) -> None:
        """Fold one reduced chunk into each of ``stores`` — a whole pane
        sync — with one packed upload and one probe launch.

        ``chunks`` is a :class:`ChunkColumns`, or a sequence whose ``g``-th
        item is ``(keys, values, counts)`` for ``stores[g]``: int columns,
        keys sorted unique (every caller guarantees it); each store appears
        at most once.  The range checks and chunk bounds run on the whole
        columns.  A store that holds keys already (warm) then runs its own
        bookkeeping: the young generation's spill guard, the sorted mirror
        and the rebuild around unseen keys.  The stores that hold none
        (fresh) take no call each: their tables are their chunks' keys,
        already sorted, and they go on one :class:`_Slab`.  One copy moves
        every new table with its zeroed young columns — ``[fresh tables |
        rebuilt tables | their young values | their young counts]`` — then
        the chunks' keys, values and counts, and the kernel's pair
        description to the device, and one ``store_probe_grouped`` launch
        adds both columns of every merge into the young generation.
        ``tracer`` times the call (span ``state.merge_many``, args
        ``stores`` and ``slab``: the stores placed on the slab) and the
        packed upload (``state.merge_many.upload``)."""
        from ..kernels.store_probe import (meta_from_pointers,
                                           store_probe_grouped)

        span = tracer.span("state.merge_many", cat="state", stores=len(stores))
        if not isinstance(chunks, ChunkColumns):
            chunks = ChunkColumns.of(chunks)
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
        rebuilt = []  # (index, union): warm stores meeting unseen keys
        for i in np.flatnonzero(~fresh).tolist():
            st, uniq = stores[i], keys[sl[i]:sl[i + 1]]
            # spill young → base before this chunk could push any young
            # element past int32 (each merge adds ≤ its bound per element)
            if st._young_bound + bl[i] > _LIM:
                st._spill()
            st._young_bound += bl[i]
            hk = st._host_keys
            pos = np.searchsorted(hk, uniq)
            present = (pos < hk.shape[0]) & (
                hk[np.minimum(pos, hk.shape[0] - 1)] == uniq)
            if not present.all():
                rebuilt.append(
                    (i, np.sort(np.concatenate([hk, uniq[~present]]))))

        f_idx = np.flatnonzero(fresh)
        f_len = lens[f_idx]
        f_lo = np.cumsum(f_len) - f_len
        n_f, n_tok = int(f_len.sum()), keys.shape[0]
        f_keys = keys if n_f == n_tok else keys[np.repeat(fresh, lens)]
        width = n_f + sum(u.shape[0] for _, u in rebuilt)
        at_keys = 3 * width
        at_meta = at_keys + 3 * n_tok
        at_meta += at_meta % 2  # 8-byte aligned
        buf = torch.empty(at_meta + 2 * (5 * g + 1), dtype=torch.int32,
                          device=device)
        host = np.empty(buf.shape[0], dtype=np.int32)
        host[:n_f] = f_keys
        host[width:at_keys] = 0
        for j, col in enumerate((keys, vals, cnts)):
            host[at_keys + j * n_tok:at_keys + (j + 1) * n_tok] = col
        host[at_keys + 3 * n_tok:at_meta] = 0
        ptr = buf.data_ptr()
        tptr, vptr, cptr = (np.empty(g, dtype=np.int64) for _ in range(3))
        tlen = np.empty(g, dtype=np.int64)
        tptr[f_idx] = ptr + 4 * f_lo
        vptr[f_idx] = ptr + 4 * (width + f_lo)
        cptr[f_idx] = ptr + 4 * (2 * width + f_lo)
        tlen[f_idx] = f_len
        carry = []  # (new table, new v, new c, old table, old v, old c)
        at = n_f
        for i, union in rebuilt:
            st, kn = stores[i], union.shape[0]
            st._own_columns()
            host[at:at + kn] = union
            tab, nv, nc = (buf[j * width + at:j * width + at + kn]
                           for j in range(3))
            old_pos = np.searchsorted(union, st._host_keys)
            nbv = np.zeros(kn, dtype=np.int64)
            nbc = np.zeros(kn, dtype=np.int64)
            nbv[old_pos] = st._base_v
            nbc[old_pos] = st._base_c
            carry.append((tab, nv, nc, st._keys, st._v, st._c))
            st._host_keys = union
            st._keys, st._v, st._c = tab, nv, nc
            st._base_v, st._base_c = nbv, nbc
            at += kn
        for i in np.flatnonzero(~fresh).tolist():
            st = stores[i]
            tptr[i], vptr[i], cptr[i] = (st._keys.data_ptr(),
                                         st._v.data_ptr(), st._c.data_ptr())
            tlen[i] = st._host_keys.shape[0]
        host[at_meta:] = meta_from_pointers(tptr, tlen, starts, vptr,
                                            cptr).view(np.int32)
        with tracer.span("state.merge_many.upload", cat="state",
                         bytes=host.nbytes):
            buf.copy_(torch.from_numpy(host))
        # a warm store that met unseen keys carries its young columns over
        for tab, nv, nc, old_tab, old_v, old_c in carry:
            idx = torch.searchsorted(tab, old_tab)
            nv[idx] = old_v
            nc[idx] = old_c
        if n_f:
            slab = _Slab(buf, width, f_keys)
            for st, lo, hi, b in zip(
                    (stores[i] for i in f_idx.tolist()), f_lo.tolist(),
                    (f_lo + f_len).tolist(), bounds[f_idx].tolist()):
                d = st.__dict__
                if "_keys" in d:  # columns it was given while empty
                    for name in _COLUMNS:
                        del d[name]
                d["_slab"], d["_lo"], d["_hi"] = slab, lo, hi
                d["_young_bound"] = b
        store_probe_grouped(
            _StoreColumns(stores, "_keys"), buf[at_keys:at_keys + n_tok],
            buf[at_keys + n_tok:at_keys + 2 * n_tok],
            buf[at_keys + 2 * n_tok:at_keys + 3 * n_tok], starts,
            _StoreColumns(stores, "_v"), _StoreColumns(stores, "_c"),
            meta=buf[at_meta:].view(torch.int64), slab=buf)
        span.set(slab=int(f_idx.shape[0])).done()

    def _young(self):
        """The young generation read back as host int64 columns."""
        READBACKS["store"] += 2
        return (self._v.cpu().numpy().astype(np.int64),
                self._c.cpu().numpy().astype(np.int64))

    def _spill(self) -> None:
        """Fold the int32 young generation into the int64 lifetime base
        and zero the device accumulators (one readback; amortized over
        ~2³¹/chunk_bound merges)."""
        self._own_columns()
        if self._v is not None and self._host_keys.shape[0]:
            v, c = self._young()
            self._base_v = self._base_v + v
            self._base_c = self._base_c + c
            self._v.zero_()
            self._c.zero_()
        self._young_bound = 0

    def take(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.shape[0] == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        self._own_columns()
        k = self._host_keys.shape[0]
        pos = np.searchsorted(self._host_keys, keys)
        posc = np.clip(pos, 0, max(k - 1, 0))
        ok = ((pos < k) & (self._host_keys[posc] == keys)) if k else (
            np.zeros(keys.shape[0], dtype=bool))
        if not ok.all():
            raise KeyError(
                f"{int((~ok).sum())} keys absent from DeviceStateStore")
        v, c = self._young()
        vals = (self._base_v[pos] + v[pos]).copy()
        cnts = (self._base_c[pos] + c[pos]).copy()
        keep = np.ones(k, dtype=bool)
        keep[pos] = False
        self._host_keys = self._host_keys[keep]
        self._keys = self._upload(self._host_keys)
        self._v = self._upload(v[keep])
        self._c = self._upload(c[keep])
        self._base_v = self._base_v[keep]
        self._base_c = self._base_c[keep]
        return vals, cnts

    def items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.num_entries == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        v, c = self._young()
        return (self._host_keys.copy(), self._base_v + v, self._base_c + c)


def read_stores(stores) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each store's ``items()``, any backend: the device stores still on a
    slab from one copy of that slab's young columns (their bases are zero),
    every other store by its own ``items()``."""
    reads = {}
    out = []
    for st in stores:
        slab = getattr(st, "_slab", None)
        if slab is None:
            out.append(st.items())
            continue
        cols = reads.get(slab)
        if cols is None:
            cols = reads[slab] = (slab.keys,) + slab.read()
        lo, hi = st._lo, st._hi
        out.append((cols[0][lo:hi], cols[1][lo:hi], cols[2][lo:hi]))
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
