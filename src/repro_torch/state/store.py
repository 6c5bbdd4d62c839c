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

from typing import Dict, List, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs.trace import NULL_TRACER

__all__ = [
    "ENTRY_BYTES",
    "DictStateStore",
    "ArrayStateStore",
    "DeviceStateStore",
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

    ``device``: ``None`` means ``"cuda"`` (raises without a card); pass
    ``"cpu"`` to run the plain versions."""

    backend = "device"

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._host_keys = np.empty(0, dtype=np.int64)  # sorted mirror
        self._keys = None  # device int32, strictly ascending (lazy)
        self._v = None     # device int32 young-gen value accumulators
        self._c = None     # device int32 young-gen count accumulators
        self._base_v = np.empty(0, dtype=np.int64)  # host lifetime base
        self._base_c = np.empty(0, dtype=np.int64)
        self._young_bound = 0  # ≥ max |young element|, per-merge accumulated

    # -- interface ------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        return int(self._host_keys.shape[0])

    def size_bytes(self) -> int:
        return int(self._host_keys.shape[0]) * ENTRY_BYTES

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
        self.merge_many([self], [self.reduce_chunk(keys, values)])

    def merge_entries(self, keys: np.ndarray, values: np.ndarray,
                      counts: np.ndarray, own: bool = False) -> None:
        self.merge_many([self], [(keys, values, counts)])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host int column → device int32 (the caller range-checked it)."""
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    @staticmethod
    def merge_many(stores, chunks, tracer=NULL_TRACER) -> None:
        """Fold one reduced chunk into each of ``stores`` — a whole pane
        sync — with one packed upload and one probe launch.

        ``chunks[g]`` is ``(keys, values, counts)`` for ``stores[g]``: int
        columns, keys sorted unique (every caller guarantees it); each
        store appears at most once.  Each store's host bookkeeping runs
        first: range checks, the young generation's spill guard, the sorted
        mirror and the rebuild around unseen keys.  Then one copy moves
        every new table (fresh and rebuilt stores) with its zeroed young
        columns, the chunks' keys, values and counts, and the kernel's pair
        description to the device, and one ``store_probe_grouped`` launch
        adds both columns of every merge into the young generation.  The
        new tables and young columns are views into that one allocation.
        ``tracer`` times the call (span ``state.merge_many``) and the
        packed upload (``state.merge_many.upload``)."""
        from ..kernels.store_probe import grouped_meta, store_probe_grouped

        span = tracer.span("state.merge_many", cat="state", stores=len(stores))

        lim = 2 ** 31 - 1
        work = []  # (store, keys, values, counts, new table or None)
        for st, (keys, values, counts) in zip(stores, chunks):
            uniq = np.asarray(keys, dtype=np.int64)
            n = uniq.shape[0]
            if n == 0:
                continue
            vsum = np.asarray(values, dtype=np.int64)
            csum = np.asarray(counts, dtype=np.int64)
            if uniq[0] < 0 or uniq[-1] > lim:
                raise ValueError(
                    "DeviceStateStore keys must fit int32 (got range "
                    f"[{uniq[0]}, {uniq[-1]}])")
            chunk_bound = int(max(np.abs(vsum).max(initial=0),
                                  np.abs(csum).max(initial=0)))
            if chunk_bound > lim:
                raise ValueError(
                    "DeviceStateStore accumulates in int32; chunk "
                    "aggregates exceed its range")
            # spill young → base before this chunk could push any young
            # element past int32 (each merge adds ≤ chunk_bound per element)
            if st._young_bound + chunk_bound > lim:
                st._spill()
            st._young_bound += chunk_bound
            hk = st._host_keys
            k = hk.shape[0]
            pos = np.searchsorted(hk, uniq)
            present = ((pos < k) & (hk[np.clip(pos, 0, max(k - 1, 0))]
                                    == uniq)) if k else np.zeros(n, bool)
            union = None
            if not present.all():
                union = np.sort(np.concatenate([hk, uniq[~present]]))
            work.append((st, uniq, vsum, csum, union))
        if not work:
            span.done()
            return
        device = work[0][0].device
        if any(w[0].device != device for w in work):
            raise ValueError("merge_many: stores on more than one device")

        # one int32 buffer: [table | young v | young c] per new table, then
        # the chunks' keys | values | counts, then the int64 pair meta
        g = len(work)
        n_new = sum(3 * w[4].shape[0] for w in work if w[4] is not None)
        n_tok = sum(w[1].shape[0] for w in work)
        at_meta = n_new + 3 * n_tok
        at_meta += at_meta % 2  # 8-byte aligned
        buf = torch.empty(at_meta + 2 * (5 * g + 1), dtype=torch.int32,
                          device=device)
        host = np.zeros(buf.shape[0], dtype=np.int32)
        at = 0
        rebuilt = []  # (new table, new v, new c, old table, old v, old c)
        for st, _, _, _, union in work:
            if union is None:
                continue
            kn = union.shape[0]
            host[at:at + kn] = union
            tab, nv, nc = (buf[at + j * kn:at + (j + 1) * kn]
                           for j in range(3))
            at += 3 * kn
            nbv = np.zeros(kn, dtype=np.int64)
            nbc = np.zeros(kn, dtype=np.int64)
            if st._host_keys.shape[0]:
                old_pos = np.searchsorted(union, st._host_keys)
                nbv[old_pos] = st._base_v
                nbc[old_pos] = st._base_c
                rebuilt.append((tab, nv, nc, st._keys, st._v, st._c))
            st._host_keys = union
            st._keys, st._v, st._c = tab, nv, nc
            st._base_v, st._base_c = nbv, nbc
        offsets = [0]
        for _, uniq, vsum, csum, _ in work:
            lo, n = offsets[-1], uniq.shape[0]
            host[at + lo:at + lo + n] = uniq
            host[at + n_tok + lo:at + n_tok + lo + n] = vsum
            host[at + 2 * n_tok + lo:at + 2 * n_tok + lo + n] = csum
            offsets.append(lo + n)
        keys_d, vals_d, cnts_d = (buf[at + j * n_tok:at + (j + 1) * n_tok]
                                  for j in range(3))
        tables = [w[0]._keys for w in work]
        vout = [w[0]._v for w in work]
        cout = [w[0]._c for w in work]
        host[at_meta:] = grouped_meta(tables, offsets, vout,
                                      cout).view(np.int32)
        with tracer.span("state.merge_many.upload", cat="state",
                         bytes=host.nbytes):
            buf.copy_(torch.from_numpy(host))
        # a warm store that met unseen keys carries its young columns over
        for tab, nv, nc, old_tab, old_v, old_c in rebuilt:
            idx = torch.searchsorted(tab, old_tab)
            nv[idx] = old_v
            nc[idx] = old_c
        store_probe_grouped(tables, keys_d, vals_d, cnts_d, offsets, vout,
                            cout, meta=buf[at_meta:].view(torch.int64))
        span.done()

    def _young(self):
        """The young generation read back as host int64 columns."""
        return (self._v.cpu().numpy().astype(np.int64),
                self._c.cpu().numpy().astype(np.int64))

    def _spill(self) -> None:
        """Fold the int32 young generation into the int64 lifetime base
        and zero the device accumulators (one readback; amortized over
        ~2³¹/chunk_bound merges)."""
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
        if self._host_keys.shape[0] == 0:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        v, c = self._young()
        return (self._host_keys.copy(), self._base_v + v, self._base_c + c)


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
