"""Keyed-state probe/accumulate: the hand-written CUDA kernel, its plain
PyTorch version, and the wrappers that pick one by the tensor's device.

Replaces ``src/repro/kernels/store_probe.py::store_probe`` (the Pallas
kernel behind ``DeviceStateStore._merge``).  It folds one routed chunk
into a slot table: per slot the int32 Σvalue and Σcount of the chunk's
tokens that hit it, plus a per-token hit flag.  :func:`store_probe` is
that function; :func:`store_probe_grouped` folds G (table, chunk) pairs
in one launch of the same kernel — a whole pane sync of
``DeviceStateStore.merge_many`` — adding both columns of each merge
straight into the stores' young columns.

* **Kernel** (``csrc/store_probe.cu``): one thread per token, a binary
  search over the strictly ascending table, ``atomicAdd`` on int32 for the
  slot sums — O(N log K) instead of the TPU kernel's O(N·K) compare matrix.
  Bound by bytes (each token's key and value, plus the sums it touches);
  integer atomics keep the sums exact and order-free.
* **Plain version**: the compare-matrix form of the TPU kernel, tiled over
  tokens (grouped: one call per pair).  It holds for any table, so
  comparing the two on the main path's tables also checks the kernel's
  precondition.

For a CUDA tensor a wrapper launches the kernel (or raises); only a CPU
tensor takes the plain version.  ``LAUNCHES["store_probe"]`` counts kernel
launches of both wrappers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build

__all__ = ["store_probe", "store_probe_plain", "store_probe_grouped",
           "store_probe_grouped_plain", "grouped_meta", "meta_from_pointers",
           "LAUNCHES"]

#: kernel launches, counted where the wrapper launches
LAUNCHES = {"store_probe": 0}

_BLOCK_N = 1024  # tokens per compare-matrix tile (plain version)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"store_probe": (_P, _I, _P, _P, _I, _P, _P, _P, _P),
         "store_probe_grouped": (_I, _P, _P, _P, _P, _I, _P)}


def _check_args(table_keys, batch_keys, batch_vals) -> None:
    for name, t in (("table_keys", table_keys), ("batch_keys", batch_keys),
                    ("batch_vals", batch_vals)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"store_probe: {name} must be 1-D int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != table_keys.device:
            raise ValueError("store_probe: all tensors on one device")
    if batch_keys.shape != batch_vals.shape:
        raise ValueError("store_probe: batch_keys and batch_vals differ in "
                         "shape")


def store_probe_plain(table_keys: torch.Tensor, batch_keys: torch.Tensor,
                      batch_vals: torch.Tensor):
    """Compare-matrix form (any table; -1 marks an empty slot)."""
    k = table_keys.shape[0]
    vsum = torch.zeros(k, dtype=torch.int32, device=table_keys.device)
    csum = torch.zeros_like(vsum)
    matched = []
    live = table_keys >= 0
    for lo in range(0, batch_keys.shape[0], _BLOCK_N):
        ks = batch_keys[lo:lo + _BLOCK_N]
        vs = batch_vals[lo:lo + _BLOCK_N]
        eq = (ks[:, None] == table_keys[None, :]) & live[None, :]
        vsum += torch.where(eq, vs[:, None], 0).sum(0, dtype=torch.int32)
        csum += eq.sum(0, dtype=torch.int32)
        matched.append(eq.any(1))
    hit = (torch.cat(matched) if matched
           else torch.zeros(0, dtype=torch.bool, device=table_keys.device))
    return vsum, csum, hit


def store_probe(table_keys: torch.Tensor, batch_keys: torch.Tensor,
                batch_vals: torch.Tensor, *, validate: bool = False):
    """Probe/accumulate one chunk against a slot table.

    table_keys: (K,) int32, **strictly ascending** on the kernel path
                (``DeviceStateStore`` keeps it so).  ``validate=True``
                checks that on the device (one host sync) and raises.
    batch_keys: (N,) int32 token key ids.
    batch_vals: (N,) int32 per-token values (range-checked by the caller).
    returns:    vsum (K,) int32, csum (K,) int32, matched (N,) bool.
    """
    _check_args(table_keys, batch_keys, batch_vals)
    if table_keys.device.type == "cpu":
        return store_probe_plain(table_keys, batch_keys, batch_vals)
    if table_keys.device.type != "cuda":
        raise ValueError(f"store_probe: no kernel for device "
                         f"{table_keys.device}")
    if validate and table_keys.shape[0] > 1 and not bool(
            (table_keys[1:] > table_keys[:-1]).all()):
        raise ValueError("store_probe: the kernel needs a strictly "
                         "ascending slot table")
    table_keys = table_keys.contiguous()
    batch_keys = batch_keys.contiguous()
    batch_vals = batch_vals.contiguous()
    k, n = table_keys.shape[0], batch_keys.shape[0]
    vsum = torch.empty(k, dtype=torch.int32, device=table_keys.device)
    csum = torch.empty_like(vsum)
    matched = torch.empty(n, dtype=torch.bool, device=table_keys.device)
    err = _build.library("store_probe", _SIGS).store_probe(
        table_keys.data_ptr(), k, batch_keys.data_ptr(),
        batch_vals.data_ptr(), n, vsum.data_ptr(), csum.data_ptr(),
        matched.data_ptr(), _build.stream_ptr(table_keys.device))
    _build.check(err, "store_probe")
    LAUNCHES["store_probe"] += 1
    return vsum, csum, matched


# -- grouped: G (table, chunk) pairs in one launch -------------------------------


def grouped_meta(tables: Sequence[torch.Tensor], offsets: Sequence[int],
                 vout: Sequence[torch.Tensor],
                 cout: Sequence[torch.Tensor]) -> np.ndarray:
    """The kernel's int64 description of G pairs (5G+1 entries): table
    pointers, table lengths, the G+1 token offsets, value-out and count-out
    pointers.  A caller that packs its data into one upload writes this
    beside it and passes the device copy as ``meta``."""
    return meta_from_pointers([t.data_ptr() for t in tables],
                              [t.shape[0] for t in tables], offsets,
                              [t.data_ptr() for t in vout],
                              [t.data_ptr() for t in cout])


def meta_from_pointers(table_ptrs, table_lens, offsets, vout_ptrs,
                       cout_ptrs) -> np.ndarray:
    """:func:`grouped_meta` from the pairs' addresses and lengths, G each
    (G+1 offsets): for a caller that knows where its columns lie in one
    allocation and so reads no tensor's ``data_ptr``."""
    g = len(table_lens)
    meta = np.empty(5 * g + 1, dtype=np.int64)
    meta[:g] = table_ptrs
    meta[g:2 * g] = table_lens
    meta[2 * g:3 * g + 1] = offsets
    meta[3 * g + 1:4 * g + 1] = vout_ptrs
    meta[4 * g + 1:] = cout_ptrs
    return meta


def store_probe_grouped_plain(tables, keys, vals, cnts, offsets):
    """One compare-matrix call per pair: (vsums, csums), a list each."""
    vsums, csums = [], []
    for g, table in enumerate(tables):
        lo, hi = int(offsets[g]), int(offsets[g + 1])
        vs, cs, _ = store_probe_plain(table, keys[lo:hi], vals[lo:hi])
        if cnts is not None:
            cs = store_probe_plain(table, keys[lo:hi], cnts[lo:hi])[0]
        vsums.append(vs)
        csums.append(cs)
    return vsums, csums


def store_probe_grouped(tables: Sequence[torch.Tensor], keys: torch.Tensor,
                        vals: torch.Tensor, cnts: Optional[torch.Tensor],
                        offsets: Sequence[int], vout: Sequence[torch.Tensor],
                        cout: Sequence[torch.Tensor], *,
                        meta: Optional[torch.Tensor] = None,
                        slab: Optional[torch.Tensor] = None) -> None:
    """Fold G (slot table, chunk) pairs in one launch, adding in place:
    ``vout[g] += Σ value`` and ``cout[g] += Σ count`` per slot of
    ``tables[g]`` over the tokens ``[offsets[g], offsets[g+1])`` of the
    packed ``keys``/``vals`` (count: ``cnts``, or 1 per token when None).

    tables:     G 1-D int32, each **strictly ascending** on the kernel path.
    keys, vals, cnts: (N,) int32, the pairs' chunks back to back.
    vout, cout: G 1-D int32 columns, one slot per table entry.
    meta:       the device copy of :func:`grouped_meta` for exactly these
                tensors, when the caller uploaded it with its data; else it
                is built and uploaded here (one more copy).
    slab:       the one 1-D int32 buffer that ``keys``, ``vals``, ``cnts``
                and ``meta`` are views of, from a caller that built every
                table and output column itself (``DeviceStateStore.
                merge_many``): the buffer is checked once in place of each
                view, and the columns are taken as they are, as ``meta``'s
                pointers always are.  Only the plain version reads
                ``tables``, ``vout`` and ``cout`` then (any sequences of G).
    """
    g = len(tables)
    if not (len(vout) == len(cout) == g and len(offsets) == g + 1):
        raise ValueError("store_probe_grouped: G tables, G output pairs and "
                         "G+1 offsets")
    if int(offsets[0]) != 0 or int(offsets[-1]) != keys.shape[0]:
        raise ValueError("store_probe_grouped: offsets must span the chunk")
    if slab is None:
        _check_pairs(tables, keys, vals, cnts, vout, cout)
    else:
        _check_slab(slab, keys, vals, cnts, meta)
    if keys.device.type == "cpu":
        vsums, csums = store_probe_grouped_plain(tables, keys, vals, cnts,
                                                 offsets)
        for v, c, vs, cs in zip(vout, cout, vsums, csums):
            v.add_(vs)
            c.add_(cs)
        return None
    if keys.device.type != "cuda":
        raise ValueError(f"store_probe_grouped: no kernel for device "
                         f"{keys.device}")
    if meta is None:
        meta = torch.from_numpy(grouped_meta(tables, offsets, vout,
                                             cout)).to(keys.device)
    elif meta.dtype != torch.int64 or meta.shape[0] != 5 * g + 1:
        raise ValueError("store_probe_grouped: meta must be the (5G+1,) "
                         "int64 grouped_meta")
    err = _build.library("store_probe", _SIGS).store_probe_grouped(
        g, meta.data_ptr(), keys.data_ptr(), vals.data_ptr(),
        None if cnts is None else cnts.data_ptr(), keys.shape[0],
        _build.stream_ptr(keys.device))
    _build.check(err, "store_probe_grouped")
    LAUNCHES["store_probe"] += 1
    return None


def _check_pairs(tables, keys, vals, cnts, vout, cout) -> None:
    for name, t in [("keys", keys), ("vals", vals), ("cnts", cnts)] + [
            ("table", t) for t in tables] + [("vout", t) for t in vout] + [
            ("cout", t) for t in cout]:
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"store_probe_grouped: {name} must be 1-D int32,"
                            f" got {t.dtype} {tuple(t.shape)}")
        if t.device != keys.device or not t.is_contiguous():
            raise ValueError("store_probe_grouped: contiguous tensors on one "
                             "device")
    for t, v, c in zip(tables, vout, cout):
        if v.shape != t.shape or c.shape != t.shape:
            raise ValueError("store_probe_grouped: an output column does not "
                             "match its table")


def _check_slab(slab, keys, vals, cnts, meta) -> None:
    if slab.dtype != torch.int32 or slab.dim() != 1 or \
            not slab.is_contiguous():
        raise TypeError("store_probe_grouped: slab must be a contiguous 1-D "
                        f"int32 buffer, got {slab.dtype} {tuple(slab.shape)}")
    base = slab.untyped_storage().data_ptr()
    for t in (keys, vals, cnts, meta):
        if t is not None and (t.untyped_storage().data_ptr() != base
                              or not t.is_contiguous()):
            raise ValueError("store_probe_grouped: keys, vals, cnts and meta "
                             "must be contiguous views of the slab")
