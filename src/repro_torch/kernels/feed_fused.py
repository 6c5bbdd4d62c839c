"""Device-resident fused feed hot path: hand-written CUDA kernels for one
(edge, segment), their plain PyTorch versions, and the per-edge runner.

Replaces ``src/repro/kernels/feed_fused.py::_get_seg_fn`` — one jitted XLA
launch per segment that chains

a. **routing** — all six schemes over device state: SG is round-robin
   arithmetic; FG/PKG/DC/WC/FISH look their candidates up in a consistent-
   hash ring table (upper-bound search over the ring points — the device
   mirror of ``chash.lookup_n``); PKG is the exact sequential two-choice;
   DC/WC/FISH classify hot keys against a dense device frequency tracker
   and pick per tuple by a masked argmin (FISH: the Eq. 2 wait-time argmin
   against the Alg. 3 estimator state);
b. **FIFO** — the per-worker recurrence ``f = max(busy[w], t) + caps[w]``
   in the reference scan's operation order, in float64 relative to the
   feed's first arrival (the reference's float32, forced by the TPU, drifts
   past its own 1e-4 contract on a hot worker at the paper's scale);
c. **keyed-state update** — per-(worker, key) pane sums in an
   open-addressing table sized by the pane's tuples (not workers x key
   capacity), warp-aggregated then inserted; panes sync to the host
   :class:`~repro_torch.state.window.KeyedStateManager` only at pane
   boundaries and membership events.

PyTorch has no sequential scan, so the segment is at most six kernels
(``csrc/feed_fused.cu`` — see its header for what bounds each and how the
float sums stay deterministic):

=============== ============ ==============================================
kernel          shape        computes
=============== ============ ==============================================
``ring_rows``   tuple × col  candidate rows (per-key hash cache when the key
                             table is no larger than the segment, else
                             per-tuple hashes — as the reference)
``tracker_count`` tuple      int32 counts per (epoch ordinal, key)
``tracker_fold`` key         decayed dense tracker, its per-epoch
                             snapshots, per-(epoch, block) sum/max
``route_scan``  one block    PKG/DC/WC/FISH: the sequential routing chain
``fifo_workers`` warp/worker the per-worker FIFO (SG/FG gather their
                             fixed routes here)
``pane_update`` tuple        pane (value, count) sums into a compact
                             open-addressing table of pair keys,
                             replicas, ``pane_last``
=============== ============ ==============================================

SG runs ``fifo_workers`` + ``pane_update``; FG adds ``ring_rows``; PKG
adds ``ring_rows`` and ``route_scan``; DC/WC/FISH run all six.  Each
wrapper launches its kernel for a CUDA tensor (or raises) and takes its
plain version only for a CPU tensor;
``LAUNCHES[name]`` counts kernel launches.  ``EdgeResult.dispatches``
keeps the reference's meaning: one per segment.

Semantics vs the reference (DESIGN.md §6): SG/FG/PKG routing, counts,
replicas and window aggregates are exact, and timing agrees with the host
engine to float64 rounding; DC/WC/FISH read frequencies at segment
granularity from a dense tracker and FISH ticks its estimator at segment
starts — bounded drift, the same class as the batched engine's
sub-chunking.  DC/WC trackers hold integer counts and match the reference
exactly.  FISH departs from the reference on purpose: the reference reads
every tuple of a segment against the tracker at the segment's end, which
at 16k-tuple segments (~16 FISH epochs) reclassifies a hot key as light
for the part of the segment before a hot-key flip — its makespan then
drifts far outside the §6 bands.  Here each FISH tuple reads the tracker
at the end of its own epoch (the batched engine's sub-chunk discipline)
and the CHK memory as of its epoch's start.
"""

from __future__ import annotations

import ctypes
from hashlib import sha1 as _sha1
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..obs.telemetry import Telemetry
from . import _build

__all__ = ["FusedEdgeRunner", "fused_reject_reason", "LAUNCHES",
           "MIN_BUCKET", "KEY_CAP_LIMIT", "ring_rows", "ring_rows_plain",
           "tracker_update", "tracker_update_plain", "route_scan",
           "route_scan_plain", "fifo_workers", "fifo_workers_plain",
           "route_prologue", "pane_update", "pane_update_plain",
           "pane_from_entries", "pane_grow", "pane_canonical",
           "pane_capacity", "pane_pairs", "PANE_EMPTY", "SCHEME_IDS"]

#: kernel launches on CUDA tensors, counted where each wrapper launches
LAUNCHES = {"ring_rows": 0, "tracker_count": 0, "tracker_fold": 0,
            "route_scan": 0, "fifo_workers": 0, "pane_update": 0}

#: Shared disabled bundle for runners no session bound telemetry to.
_NULL_TELEMETRY = Telemetry(enabled=False)
MIN_BUCKET = 64  # smallest pow2 padding bucket for segment lengths
KEY_CAP_LIMIT = 1 << 21  # dense per-key tables; larger key ids fall back

_SCHEMES = ("sg", "fg", "pkg", "dc", "wc", "fish")
_RING_SCHEMES = ("fg", "pkg", "dc", "wc", "fish")
SCHEME_IDS = {s: i for i, s in enumerate(_SCHEMES)}  # csrc enum Scheme
_BIG_I32 = 2 ** 30  # masked candidate wait (int schemes)
_FOLD_THREADS = 256   # csrc kFoldThreads: tracker_fold's tree width
_ROUTE_THREADS = 256  # csrc kRouteThreads: route_scan's block
_TILE_INTS = 8192     # csrc kTileInts: route_scan's staged tile
_TILE_MAX = 1024      # csrc kTileMax
_SMEM_LIMIT = 232_448  # a Hopper block's dynamic shared memory (227 KB)
_RING_RUN = 32        # csrc kRun: ring points per staged splitter
_PANE_SMEM = 48 * 1024  # pane_update's (w1,) block maxima, default limit
PANE_EMPTY = -1       # an empty pane slot's pair key (csrc kEmptySlot)
MIN_PANE_SLOTS = 1024  # smallest pane table (csrc: 2^6 at least)


def _bucket(n: int) -> int:
    """Smallest power of two >= n that is >= MIN_BUCKET."""
    return max(MIN_BUCKET, 1 << (int(n) - 1).bit_length())


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def fused_reject_reason(grouper, keys_arr: np.ndarray,
                        values: Optional[np.ndarray],
                        state_sink, tuple_observer) -> Optional[str]:
    """Why this feed cannot run fused (None = it can).  Checked per feed;
    any reason makes the edge fall back to the batched engine for good."""
    scheme = getattr(grouper, "name", None)
    if scheme not in _SCHEMES:
        return f"scheme {scheme!r} has no fused routing"
    if scheme == "fish" and not getattr(grouper, "use_consistent_hash", True):
        return "fused FISH requires the consistent-hash candidate path"
    if tuple_observer is not None:
        return ("fused mode feeds keyed state through state_sink, not "
                "tuple_observer")
    if keys_arr.shape[0]:
        kmin = int(keys_arr.min())
        kmax = int(keys_arr.max())
        if kmin < 0:
            return "fused key tables are dense; negative key ids"
        if kmax >= KEY_CAP_LIMIT:
            return (f"fused key tables are dense; key id {kmax} exceeds "
                    f"capacity limit {KEY_CAP_LIMIT}")
    if state_sink is not None:
        from ..state.window import tuple_values

        op = state_sink.op
        vals = tuple_values(op, keys_arr, payload=values)
        if vals.shape[0]:
            lim = (2 ** 31 - 1) // max(op.stride, 1)
            if int(np.abs(vals).max()) > lim:
                return ("pane aggregates could overflow int32: "
                        f"|value| > {lim} at stride {op.stride}")
    return None


# ---------------------------------------------------------------------------
# ring candidate table — the device mirror of chash.lookup_n
# ---------------------------------------------------------------------------


def _build_ring_table(ring, dmax: int):
    """(sorted ring points uint32, (R, dmax) int32 first-d-distinct-owners).

    ``upper_bound(points, h) % R`` lands on the same ring position as
    ``bisect_right`` + wrap in ``chash.lookup``; row r holds the first
    ``dmax`` distinct owners walking clockwise from position r — exactly
    ``lookup_n``'s prefix for every d <= dmax.  Rebuilt host-side only on
    membership change; rows are padded with -1 past the number of distinct
    live owners.  Vectorised: a worker's rank in row r is the clockwise
    distance from r to its next point, so each row is an argsort of those
    distances (the walk's first-seen order, since distances are distinct).
    """
    pts_l = ring._points
    r_n = len(pts_l)
    pts = np.asarray(pts_l, dtype=np.uint32)
    owners = np.fromiter((ring._owner[p] for p in pts_l), dtype=np.int64,
                         count=r_n)
    workers = np.unique(owners)
    d_eff = min(dmax, workers.shape[0])
    cands = np.full((r_n, dmax), -1, dtype=np.int32)
    if r_n == 0:
        return pts, cands
    positions = [np.flatnonzero(owners == w) for w in workers]
    block = max(1, (1 << 22) // max(workers.shape[0], 1))
    for lo in range(0, r_n, block):
        r = np.arange(lo, min(lo + block, r_n), dtype=np.int64)
        dist = np.empty((r.shape[0], workers.shape[0]), dtype=np.int64)
        for j, pos in enumerate(positions):
            nxt = np.searchsorted(pos, r, side="left")  # first point >= r
            wrap = nxt == pos.shape[0]
            at = np.where(wrap, pos[0] + r_n,
                          pos[np.minimum(nxt, pos.shape[0] - 1)])
            dist[:, j] = at - r
        order = np.argsort(dist, axis=1, kind="stable")[:, :d_eff]
        cands[r, :d_eff] = workers[order]
    return pts, cands


def _u32_bits(arr: np.ndarray) -> np.ndarray:
    """uint32 values as int32 bit patterns: torch carries them in int32
    tensors and the kernels read them as ``unsigned int``."""
    return np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)


def _as_u64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their uint32 values, as int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the kernels' wrappers and plain versions
# ---------------------------------------------------------------------------

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)


class _RouteArgs(ctypes.Structure):
    """Mirror of ``struct RouteArgs`` in csrc/feed_fused.cu."""

    _fields_ = [("scheme", _I), ("m", _I), ("w1", _I), ("width", _I),
                ("rows", _P), ("keys", _P), ("counts", _P), ("workers", _P),
                ("kcap1", _I), ("trk", _P), ("snap", _P), ("psum", _P),
                ("pmax", _P), ("n_part", _I), ("ne", _I), ("g0", _LL),
                ("epoch", _I), ("theta", _F), ("wnum", _F),
                ("act_mask", _P), ("m_k", _P), ("d_min", _I), ("ebl", _P),
                ("eas", _P), ("ecaps", _P), ("do_tick", _I),
                ("elapsed", _F), ("dbuf", _P), ("mbuf", _P)]


_SIGS = {
    "ring_rows": (_P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P),
    "tracker_count": (_P, _I, _I, _LL, _I, _P, _P),
    "tracker_fold": (_P, _I, _P, _I, _F, _I, _P, _P, _P, _P),
    "route_scan": (ctypes.POINTER(_RouteArgs), _P),
    "fifo_workers": (_I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P),
    "pane_update": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                    _P, _P),
}


def _lib():
    return _build.library("feed_fused", _SIGS)


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (plain version); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _need(what: str, device, dtype, **tensors) -> None:
    """Raise unless every given tensor is a contiguous ``dtype`` tensor on
    ``device`` — what the kernel's raw pointers assume."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise TypeError(
                f"{what}: {name} must be a contiguous {dtype} tensor on "
                f"{device}, got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (non-contiguous)'}")


# -- ring_rows ----------------------------------------------------------------


def ring_rows_plain(pts, cands, hashes, keys, m: int, width: int,
                    n_pad: int):
    r_n = pts.shape[0]
    h = _as_u64(hashes)
    hv = h[keys[:m].long()] if keys is not None else h[:m]
    idx = torch.searchsorted(_as_u64(pts), hv, right=True) % r_n
    rows = torch.full((n_pad, width), -1, dtype=torch.int32,
                      device=pts.device)
    rows[:m] = cands[idx, :width]
    return rows


def ring_rows(pts: torch.Tensor, cands: torch.Tensor, hashes: torch.Tensor,
              keys: Optional[torch.Tensor], m: int, width: int,
              n_pad: int) -> torch.Tensor:
    """(n_pad, width) candidate rows: row i is ``cands[upper_bound(pts,
    h_i) % R, :width]`` for tuple i < m (-1 past m).  One search per
    tuple: every 32nd point staged in shared memory, then the run of 32
    settled by one read (a warp per tuple at width >= 32) or a 5-step
    search (a thread per tuple below).

    pts:    (R,) ring points, uint32 bit patterns in int32.
    cands:  (R, dmax) int32 first-distinct-owner rows.
    hashes: uint32 bit patterns in int32 — the per-key hash cache when
            ``keys`` is given (tuple i hashes as ``hashes[keys[i]]``),
            else one hash per tuple.
    """
    if not _on_card(pts, "ring_rows"):
        return ring_rows_plain(pts, cands, hashes, keys, m, width, n_pad)
    _need("ring_rows", pts.device, torch.int32, pts=pts, cands=cands,
          hashes=hashes, keys=keys)
    if width > cands.shape[1]:
        raise ValueError("ring_rows: width exceeds the candidate rows")
    if pts.shape[0] == 0 or 4 * -(-pts.shape[0] // _RING_RUN) > _SMEM_LIMIT:
        raise ValueError(f"ring_rows: {pts.shape[0]} ring points do not fit "
                         "the block's splitter array")
    rows = torch.empty((n_pad, width), dtype=torch.int32, device=pts.device)
    err = _lib().ring_rows(pts.data_ptr(), pts.shape[0], cands.data_ptr(),
                           cands.shape[1], width, hashes.data_ptr(),
                           _ptr(keys), n_pad, m, rows.data_ptr(),
                           _build.stream_ptr(pts.device))
    _build.check(err, "ring_rows")
    LAUNCHES["ring_rows"] += 1
    return rows


# -- tracker ------------------------------------------------------------------


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Shared-memory halving tree along the last axis (the kernels' order)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def tracker_update_plain(trk, cnt, keys, m, g0, epoch, pre, ne, alpha,
                         snap):
    kcap1 = trk.shape[0]
    dev = trk.device
    k = keys[:m].long()
    j = torch.zeros(m, dtype=torch.int64, device=dev)
    if epoch > 0:
        i = torch.arange(m, dtype=torch.int64, device=dev)
        j = (g0 + i) // epoch - g0 // epoch
    cnt.view(-1).index_add_(0, j * kcap1 + k,
                            torch.ones(m, dtype=torch.int32, device=dev))
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    acc = trk.clone()
    if pre:
        acc = acc * a
    nb = -(-kcap1 // _FOLD_THREADS)
    psum = torch.empty((ne, nb), dtype=torch.float32, device=dev)
    pmax = torch.empty_like(psum)
    pad = torch.zeros(nb * _FOLD_THREADS, dtype=torch.float32, device=dev)
    for e in range(ne):
        if e:
            acc = acc * a
        c = cnt[e]
        acc = torch.where(c != 0, acc + c.to(torch.float32), acc)
        if snap is not None:
            snap[e] = acc
        pad[:kcap1] = acc
        x = pad.view(nb, _FOLD_THREADS)
        psum[e] = _tree_sum(x)
        pmax[e] = x.amax(dim=1)
    cnt[:ne].zero_()
    trk.copy_(acc)
    return psum, pmax


def tracker_update(trk: torch.Tensor, cnt: torch.Tensor, keys: torch.Tensor,
                   m: int, *, g0: int = 0, epoch: int = 0, pre: int = 0,
                   ne: int = 1, alpha: float = 1.0,
                   snap: Optional[torch.Tensor] = None):
    """Dense per-key tracker update for one segment, in place.

    Tuple i belongs to epoch ordinal ``(g0+i)//epoch - g0//epoch`` (all 0
    with ``epoch=0`` — the DC/WC undecayed count).  The tracker decays by
    ``alpha`` at every epoch boundary before that epoch's tuples are added
    (once up front when ``pre``: a segment starting on a boundary), as
    Alg. 1's TimeDecayingUpdate.  ``cnt`` is an all-zero (≥ ne, kcap1)
    int32 scratch table, left zeroed; ``snap`` (ne, kcap1), when given,
    receives the tracker at the end of each ordinal.  Returns the
    per-(ordinal, block) partial sums and maxima, (ne, nb) each, that
    ``route_scan`` reduces to each epoch's total and max.  Two kernels:
    ``tracker_count`` then ``tracker_fold``."""
    if ne > cnt.shape[0]:
        raise ValueError("tracker_update: count table has too few epochs")
    if not _on_card(trk, "tracker_update"):
        return tracker_update_plain(trk, cnt, keys, m, g0, epoch, pre, ne,
                                    alpha, snap)
    _need("tracker_update", trk.device, torch.float32, trk=trk, snap=snap)
    _need("tracker_update", trk.device, torch.int32, cnt=cnt, keys=keys)
    kcap1 = trk.shape[0]
    if cnt.shape[1] != kcap1 or (snap is not None
                                 and tuple(snap.shape) != (ne, kcap1)):
        raise ValueError("tracker_update: cnt/snap do not match the tracker")
    nb = -(-kcap1 // _FOLD_THREADS)
    psum = torch.empty((ne, nb), dtype=torch.float32, device=trk.device)
    pmax = torch.empty_like(psum)
    lib = _lib()
    stream = _build.stream_ptr(trk.device)
    err = lib.tracker_count(keys.data_ptr(), m, kcap1, g0, epoch,
                            cnt.data_ptr(), stream)
    _build.check(err, "tracker_count")
    LAUNCHES["tracker_count"] += 1
    err = lib.tracker_fold(trk.data_ptr(), kcap1, cnt.data_ptr(), ne,
                           float(np.float32(alpha)), int(pre), _ptr(snap),
                           psum.data_ptr(), pmax.data_ptr(), stream)
    _build.check(err, "tracker_fold")
    LAUNCHES["tracker_fold"] += 1
    return psum, pmax


# -- route_scan -----------------------------------------------------------------


def _reduce_partials(psum: np.ndarray, pmax: np.ndarray):
    """route_scan's prologue for one epoch: partials summed per thread in
    a fixed stride order, then the block tree; max is order-free."""
    n = psum.shape[0]
    rows = -(-n // _ROUTE_THREADS)
    pad = np.zeros(rows * _ROUTE_THREADS, dtype=np.float32)
    pad[:n] = psum
    acc = np.zeros(_ROUTE_THREADS, dtype=np.float32)
    for r in pad.reshape(rows, _ROUTE_THREADS):
        acc = acc + r
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    mx = np.float32(max(float(pmax.max(initial=0.0)), 0.0))
    return np.float32(acc[0]), mx


def _epoch_bounds(m: int, g0: int, epoch: int, ne: int):
    """[lo, hi) of each epoch ordinal's tuples inside the segment."""
    if epoch <= 0:
        return [(0, m)]
    e0 = g0 // epoch
    return [(0 if j == 0 else min((e0 + j) * epoch - g0, m),
             min((e0 + j + 1) * epoch - g0, m)) for j in range(ne)]


def route_prologue(scheme, m, keys, rows, act, a_live, rr, trk, snap, psum,
                   pmax, g0, epoch, theta, wnum, m_k, d_min):
    """route_scan's parallel prologue, on the host, and the fixed routes
    of SG/FG that fifo_workers gathers: for DC/WC/FISH each tuple's
    candidate count ``d`` (WC hot keys: -1, the whole live set), read
    epoch by epoch against the tracker at the epoch's end — FISH also
    against the CHK memory ``m_k`` at the epoch's start, which it then
    raises (in place).  Returns (routes, d)."""
    f32 = np.float32
    theta32, wnum32 = f32(theta), f32(wnum)
    if scheme == "sg":
        wk = act.cpu().numpy()[(rr + np.arange(m)) % a_live].astype(np.int64)
        return wk, None
    if scheme == "fg":
        return rows[:m, 0].cpu().numpy().astype(np.int64), None
    if scheme == "pkg":
        return None, None
    k = keys[:m].cpu().numpy().astype(np.int64)
    ps, pm = psum.cpu().numpy(), pmax.cpu().numpy()
    ne = ps.shape[0]
    snaps = None if snap is None else snap.cpu().numpy()
    tk = trk.cpu().numpy()
    mk = None if m_k is None else m_k.cpu().numpy().copy()
    d = np.empty(m, dtype=np.int64)
    for j, (lo, hi) in enumerate(_epoch_bounds(m, g0, epoch, ne)):
        total, mx = _reduce_partials(ps[j], pm[j])
        f_top = mx / total if total > 0 else f32(0.0)
        tj = tk if snaps is None else snaps[j]
        kj = k[lo:hi]
        f = tj[kj] / total if total > 0 else np.zeros(hi - lo, np.float32)
        if scheme in ("dc", "wc"):
            hot = f > theta32
            dh = np.ceil(f * wnum32 / np.sqrt(theta32))
            dh = np.minimum(np.maximum(dh, f32(2.0)), wnum32).astype(np.int64)
            d[lo:hi] = np.where(hot, -1 if scheme == "wc" else dh, 2)
        else:
            hot = (f > theta32) & (f > 0) & (f_top > 0)
            ratio = np.maximum(f_top / np.maximum(f, f32(1e-30)), f32(1.0))
            # floor(log2(ratio)) exactly, from the binary exponent
            idx = np.clip(np.frexp(ratio)[1] - 1, 0, 30)
            d0 = np.floor(np.ldexp(wnum32, -idx).astype(np.float32))
            d0 = np.minimum(np.maximum(d0, f32(d_min)),
                            wnum32).astype(np.int64)
            m_prev = mk[kj].astype(np.int64)
            d[lo:hi] = np.where(hot, np.maximum(d0, m_prev), 2)
            mv = np.where(hot, np.maximum(m_prev, d0), 0)
            np.maximum.at(mk, kj, mv.astype(mk.dtype))
    if mk is not None:
        m_k.copy_(torch.from_numpy(mk))
    return None, d


def route_scan_plain(scheme, m, keys, counts, rows, trk=None, snap=None,
                     psum=None, pmax=None, g0=0, epoch=0, theta=0.0,
                     wnum=0.0, act_mask=None, m_k=None, d_min=2, ebl=None,
                     eas=None, ecaps=None, do_tick=0, elapsed=0.0):
    f32 = np.float32
    n_pad = keys.shape[0]
    w1 = counts.shape[0]
    _, d = route_prologue(scheme, m, keys, rows, None, 0, 0, trk, snap,
                          psum, pmax, g0, epoch, theta, wnum, m_k, d_min)
    rw = rows.cpu().numpy()
    am = None if act_mask is None else act_mask.cpu().numpy()
    if scheme == "fish":
        # Alg. 3 Eq. 1 estimator tick, once at segment start when due
        bl = ebl.cpu().numpy().astype(np.float32)
        asn = eas.cpu().numpy().astype(np.float32)
        ec = ecaps.cpu().numpy().astype(np.float32)
        if do_tick:
            el = f32(elapsed)
            work = (bl + asn) * ec
            bl = np.where(work > el, (work - el) / ec, f32(0.0)).astype(
                np.float32)
            asn = np.zeros_like(asn)
    # the sequential chain
    wk = np.empty(m, dtype=np.int64)
    cnt_l = counts.cpu().numpy().astype(np.int64).tolist()
    for i in range(m):
        r = rw[i]
        if scheme == "pkg":
            a0 = int(r[0])
            a1 = int(r[1]) if r[1] >= 0 else a0
            w = a0 if cnt_l[a0] <= cnt_l[a1] else a1
        elif scheme == "fish":
            c = r[:min(int(d[i]), r.shape[0])].astype(np.int64)
            cs = np.maximum(c, 0)
            wt = np.where(c >= 0, (bl[cs] + asn[cs]) * ec[cs],
                          np.float32(np.inf))
            w = int(c[int(np.argmin(wt))])
        elif d[i] < 0:  # WC hot key: least-loaded live worker
            full = np.where(am, np.asarray(cnt_l), _BIG_I32)
            w = int(np.argmin(full))
        else:
            c = r[:min(int(d[i]), r.shape[0])].astype(np.int64)
            wt = [cnt_l[x] if x >= 0 else _BIG_I32 for x in c.tolist()]
            w = int(c[wt.index(min(wt))])
        cnt_l[w] += 1
        if scheme == "fish":
            asn[w] = asn[w] + f32(1.0)
        wk[i] = w
    workers = torch.full((n_pad,), w1 - 1, dtype=torch.int32)
    workers[:m] = torch.from_numpy(wk.astype(np.int32))
    counts.copy_(torch.from_numpy(np.asarray(cnt_l, dtype=np.int32)))
    if scheme == "fish":
        ebl.copy_(torch.from_numpy(bl))
        eas.copy_(torch.from_numpy(asn))
    return workers.to(keys.device)


def route_scan(scheme: str, m: int, *, keys, counts, rows, trk=None,
               snap=None, psum=None, pmax=None, g0: int = 0, epoch: int = 0,
               theta: float = 0.0, wnum: float = 0.0, act_mask=None,
               m_k=None, d_min: int = 2, ebl=None, eas=None, ecaps=None,
               do_tick: int = 0, elapsed: float = 0.0) -> torch.Tensor:
    """Route tuples [0, m) of a PKG/DC/WC/FISH segment: the sequential
    chain, in one block.

    Returns ``workers`` — (n_pad,) int32, the worker of each tuple (entries
    past m undefined on the card).  Updates ``counts`` (w1,) in place, and
    for FISH ``m_k`` (kcap1,) and the estimator ``ebl``/``eas`` (w1,).
    ``rows`` are the ``ring_rows`` candidates; DC/WC/FISH read the tracker
    from ``tracker_update`` — its per-epoch snapshots ``snap`` (or ``trk``
    itself with one epoch) and per-epoch partials — each tuple against its
    own epoch's (``g0``, ``epoch``) state.  SG and FG have fixed routes:
    :func:`fifo_workers` gathers them."""
    if scheme not in ("pkg", "dc", "wc", "fish"):
        raise ValueError(f"route_scan: {scheme!r} has fixed routes")
    if not _on_card(keys, "route_scan"):
        return route_scan_plain(
            scheme, m, keys, counts, rows, trk, snap, psum, pmax, g0, epoch,
            theta, wnum, act_mask, m_k, d_min, ebl, eas, ecaps, do_tick,
            elapsed)
    n_pad = keys.shape[0]
    w1 = counts.shape[0]
    width = rows.shape[1]
    ne = 0 if psum is None else psum.shape[0]
    if _route_scan_smem(w1, ne, width) > _SMEM_LIMIT:
        raise ValueError(f"route_scan: {w1} worker lanes at width {width} "
                         "exceed the block's shared memory")
    dev = keys.device
    _need("route_scan", dev, torch.int32, keys=keys, counts=counts,
          rows=rows, m_k=m_k)
    _need("route_scan", dev, torch.float32, trk=trk, snap=snap, psum=psum,
          pmax=pmax, ebl=ebl, eas=eas, ecaps=ecaps)
    _need("route_scan", dev, torch.bool, act_mask=act_mask)
    workers = torch.empty(n_pad, dtype=torch.int32, device=dev)
    dbuf = torch.empty(n_pad, dtype=torch.int32, device=dev)
    mbuf = torch.empty(n_pad, dtype=torch.int32, device=dev)
    args = _RouteArgs(
        scheme=SCHEME_IDS[scheme], m=m, w1=w1, width=width,
        rows=_ptr(rows), keys=_ptr(keys), counts=_ptr(counts),
        workers=_ptr(workers), kcap1=0 if trk is None else trk.shape[0],
        trk=_ptr(trk), snap=_ptr(snap), psum=_ptr(psum), pmax=_ptr(pmax),
        n_part=0 if psum is None else psum.shape[1], ne=ne, g0=g0,
        epoch=epoch,
        theta=float(np.float32(theta)), wnum=float(np.float32(wnum)),
        act_mask=_ptr(act_mask), m_k=_ptr(m_k), d_min=d_min,
        ebl=_ptr(ebl), eas=_ptr(eas), ecaps=_ptr(ecaps), do_tick=do_tick,
        elapsed=float(np.float32(elapsed)), dbuf=_ptr(dbuf),
        mbuf=_ptr(mbuf))
    err = _lib().route_scan(ctypes.byref(args), _build.stream_ptr(dev))
    _build.check(err, "route_scan")
    LAUNCHES["route_scan"] += 1
    return workers


def _route_scan_smem(w1: int, ne: int, width: int) -> int:
    """route_scan's dynamic shared memory (csrc ``route_scan``)."""
    tile = max(1, min(_TILE_MAX, _TILE_INTS // max(width, 1)))
    return 4 * (2 * tile * width + 2 * tile + 2 * w1) + 4 * (4 * w1 + 2 * ne)


# -- fifo_workers ---------------------------------------------------------------


def fifo_workers_plain(scheme, m, t, busy, caps, counts, workers=None,
                       rows=None, act=None, a_live=0, rr=0):
    n_pad = t.shape[0]
    w1 = busy.shape[0]
    fixed = scheme in ("sg", "fg")
    if fixed:
        wk, _ = route_prologue(scheme, m, None, rows, act, a_live, rr, None,
                               None, None, None, 0, 0, 0.0, 0.0, None, 2)
        workers = torch.full((n_pad,), w1 - 1, dtype=torch.int32)
        workers[:m] = torch.from_numpy(wk.astype(np.int32))
        workers = workers.to(t.device)
        counts.add_(torch.bincount(workers[:m].long(), minlength=w1).to(
            counts.dtype))
    wl = workers[:m].cpu().tolist()
    bz = busy.cpu().double().tolist()
    cp = caps.cpu().double().tolist()
    tt = t[:m].cpu().double().tolist()
    fin = [0.0] * n_pad
    for i in range(m):  # each worker's tuples in arrival order
        w = wl[i]
        fv = max(bz[w], tt[i]) + cp[w]  # _fifo_scan's order
        bz[w] = fv
        fin[i] = fv
    busy.copy_(torch.tensor(bz, dtype=torch.float64))
    return workers, torch.tensor(fin, dtype=torch.float64).to(t.device)


def fifo_workers(scheme: str, m: int, *, t, busy, caps, counts, workers=None,
                 rows=None, act=None, a_live: int = 0, rr: int = 0):
    """The per-worker FIFO of tuples [0, m): ``f = max(busy[w], t) +
    caps[w]`` for each worker's tuples in arrival order, one warp per
    worker.

    Returns ``(workers, fin)`` — (n_pad,) int32 and (n_pad,) f64 finish
    time relative to the feed base (entries past m undefined on the card).
    Updates ``busy`` (w1,) in place.  PKG/DC/WC/FISH pass the
    ``route_scan`` ``workers``; SG (``act``, ``a_live``, ``rr``: round
    robin over the live set) and FG (``rows``, one column) route here, and
    add their routes to ``counts``."""
    fixed = scheme in ("sg", "fg")
    if fixed == (workers is not None):
        raise ValueError("fifo_workers: SG/FG route here; the others pass "
                         "route_scan's workers")
    if not _on_card(t, "fifo_workers"):
        return fifo_workers_plain(scheme, m, t, busy, caps, counts, workers,
                                  rows, act, a_live, rr)
    dev = t.device
    n_pad = t.shape[0]
    w1 = busy.shape[0]
    _need("fifo_workers", dev, torch.int32, counts=counts, workers=workers,
          rows=rows, act=act)
    _need("fifo_workers", dev, torch.float64, t=t, busy=busy, caps=caps)
    if workers is None:
        workers = torch.empty(n_pad, dtype=torch.int32, device=dev)
    fin = torch.empty(n_pad, dtype=torch.float64, device=dev)
    err = _lib().fifo_workers(
        SCHEME_IDS[scheme], m, w1, 0 if rows is None else rows.shape[1],
        _ptr(rows), _ptr(act), a_live, rr, workers.data_ptr(), t.data_ptr(),
        busy.data_ptr(), caps.data_ptr(), counts.data_ptr(), fin.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "fifo_workers")
    LAUNCHES["fifo_workers"] += 1
    return workers, fin


# -- pane_update ------------------------------------------------------------------


def pane_capacity(tuples: int) -> int:
    """Slots of a pane table that ``tuples`` tuples keep at load <= 1/2:
    the smallest power of two >= 2 x tuples, at least MIN_PANE_SLOTS."""
    return max(MIN_PANE_SLOTS, _pow2_at_least(2 * int(tuples)))


def pane_pairs(workers: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Pane pair keys, ``(worker << 32) | key`` as int64: sorted pair keys
    are grouped per worker with keys ascending."""
    return (workers.long() << 32) | keys.long()


def _pane_load_check(n: int, cap: int, what: str) -> None:
    if 2 * n > cap:
        raise ValueError(f"{what}: a pane table of {cap} slots past half "
                         f"load ({n} pairs)")


def pane_canonical(pane_keys: torch.Tensor, pane_vc: torch.Tensor):
    """The pane in canonical form, on the table's device: its occupied
    slots sorted by pair key — ``(pairs (n,) int64, (2, n) int32 value and
    count sums)``.  A slot's place depends on the order its pair arrived
    in, so every reader of a pane table reads this form.  A table past half
    load is refused (``ValueError``): its caller broke the size contract,
    and on the card a pair that found every slot taken was dropped."""
    occ = torch.nonzero(pane_keys != PANE_EMPTY).squeeze(1)
    _pane_load_check(occ.shape[0], pane_keys.shape[0], "pane_canonical")
    pairs, order = torch.sort(pane_keys[occ])
    return pairs, pane_vc[:, occ[order]]


def _pane_merge_plain(pane_keys, pane_vc, pairs, vals, cnts) -> None:
    """Weighted insert, plain: the table's entries plus (pairs, vals,
    cnts), empty pairs skipped, written back as a sorted prefix of the
    slots (the plain version's layout)."""
    p0, vc0 = pane_canonical(pane_keys, pane_vc)
    keep = pairs != PANE_EMPTY
    uniq, inv = torch.unique(torch.cat([p0, pairs[keep]]), sorted=True,
                             return_inverse=True)
    n = uniq.shape[0]
    _pane_load_check(n, pane_keys.shape[0], "pane_update")
    sums = torch.zeros((2, n), dtype=torch.int32, device=pane_keys.device)
    sums[0].index_add_(0, inv, torch.cat([vc0[0], vals[keep]]))
    sums[1].index_add_(0, inv, torch.cat([vc0[1], cnts[keep]]))
    pane_keys.fill_(PANE_EMPTY)
    pane_keys[:n] = uniq
    pane_vc.zero_()
    pane_vc[:, :n] = sums


def pane_update_plain(has_pane, reset, keys, workers, vals, m, seg_base,
                      pane_keys, pane_vc, pane_last, repl):
    w1 = repl.shape[1]
    k = keys[:m].long()
    w = workers[:m].long()
    if has_pane:
        if reset:
            pane_keys.fill_(PANE_EMPTY)
            pane_vc.zero_()
            pane_last.fill_(-1)
        _pane_merge_plain(pane_keys, pane_vc, pane_pairs(w, k), vals[:m],
                          torch.ones(m, dtype=torch.int32,
                                     device=keys.device))
        gidx = seg_base + torch.arange(m, dtype=torch.int32,
                                       device=keys.device)
        pane_last.scatter_reduce_(0, w, gidx, reduce="amax")
    repl.view(-1)[k * w1 + w] = True


def _pane_log2(pane_keys, pane_vc, what: str) -> int:
    cap = pane_keys.shape[0]
    if (pane_keys.dim() != 1 or cap < 64 or cap > 2 ** 31
            or cap & (cap - 1) or tuple(pane_vc.shape) != (2, cap)):
        raise ValueError(f"{what}: a pane table is (C,) int64 keys and "
                         f"(2, C) int32 sums, C a power of two >= 64")
    return cap.bit_length() - 1


def pane_update(keys: torch.Tensor, workers: torch.Tensor, m: int, *,
                repl: torch.Tensor, vals: Optional[torch.Tensor] = None,
                seg_base: int = 0, pane_keys=None, pane_vc=None,
                pane_last=None, reset: bool = False) -> None:
    """Fold tuples [0, m) of a routed segment into the device state, in
    place: ``repl[key, worker] = True``, and with a pane the pair
    ``(worker << 32) | key``'s value and count sums in the open-addressing
    table ``pane_keys`` (C,) int64 / ``pane_vc`` (2, C) int32, and
    ``pane_last`` (w1,) — all cleared first when ``reset``.  The caller
    keeps C >= 2 x the pane's tuples (:func:`pane_capacity`): a reset call
    of more than C / 2 tuples is refused here, and a table driven past half
    load is refused by :func:`pane_canonical`, through which it is read."""
    has_pane = pane_keys is not None
    if has_pane and reset:
        _pane_load_check(m, pane_keys.shape[0], "pane_update")
    if not _on_card(keys, "pane_update"):
        return pane_update_plain(has_pane, reset, keys, workers, vals, m,
                                 seg_base, pane_keys, pane_vc, pane_last,
                                 repl)
    dev = keys.device
    _need("pane_update", dev, torch.int32, keys=keys, workers=workers,
          vals=vals, pane_vc=pane_vc, pane_last=pane_last)
    _need("pane_update", dev, torch.int64, pane_keys=pane_keys)
    _need("pane_update", dev, torch.bool, repl=repl)
    w1 = repl.shape[1]
    log2c = 0
    if has_pane:
        log2c = _pane_log2(pane_keys, pane_vc, "pane_update")
        if vals is None or pane_last is None or pane_last.shape != (w1,):
            raise ValueError("pane_update: a pane needs vals and a (w1,) "
                             "pane_last")
        if 4 * w1 > _PANE_SMEM:
            raise ValueError(f"pane_update: {w1} worker lanes exceed the "
                             "block's pane_last maxima")
    err = _lib().pane_update(1 if has_pane else 0, int(reset),
                             keys.data_ptr(), workers.data_ptr(), None,
                             _ptr(vals), None, m, w1, seg_base, log2c,
                             _ptr(pane_keys), _ptr(pane_vc), _ptr(pane_last),
                             repl.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "pane_update")
    LAUNCHES["pane_update"] += 1
    return None


def pane_from_entries(pairs: torch.Tensor, vals: torch.Tensor,
                      cnts: torch.Tensor, capacity: int):
    """A fresh pane table of ``capacity`` slots holding the weighted
    entries ``pairs`` (int64, :data:`PANE_EMPTY` entries skipped) with
    their own value and count sums — ``pane_update``'s kernel without
    tuples, replicas or ``pane_last``.  Returns (keys (C,), vc (2, C))."""
    dev = pairs.device
    n = pairs.shape[0]
    if vals.shape != (n,) or cnts.shape != (n,):
        raise ValueError("pane_from_entries: pairs, vals and cnts differ in "
                         "length")
    _pane_load_check(n, capacity, "pane_from_entries")
    keys = torch.empty(capacity, dtype=torch.int64, device=dev)
    vc = torch.empty((2, capacity), dtype=torch.int32, device=dev)
    if not _on_card(pairs, "pane_from_entries"):
        keys.fill_(PANE_EMPTY)
        vc.zero_()
        _pane_merge_plain(keys, vc, pairs, vals, cnts)
        return keys, vc
    _need("pane_from_entries", dev, torch.int64, pairs=pairs)
    _need("pane_from_entries", dev, torch.int32, vals=vals, cnts=cnts)
    log2c = _pane_log2(keys, vc, "pane_from_entries")
    err = _lib().pane_update(2, 1, None, None, pairs.data_ptr(),
                             vals.data_ptr(), cnts.data_ptr(), n, 0, 0, log2c,
                             keys.data_ptr(), vc.data_ptr(), None, None,
                             _build.stream_ptr(dev))
    _build.check(err, "pane_update")
    LAUNCHES["pane_update"] += 1
    return keys, vc


def pane_grow(pane_keys: torch.Tensor, pane_vc: torch.Tensor,
              capacity: int):
    """A pane table of ``capacity`` slots holding the entries of the given
    one: its slots re-inserted, as weighted inserts.  Returns (keys, vc)."""
    return pane_from_entries(pane_keys, pane_vc[0], pane_vc[1], capacity)


# ---------------------------------------------------------------------------
# the per-edge runner (device state residency across feeds)
# ---------------------------------------------------------------------------


class FusedEdgeRunner:
    """Device-resident execution state of one fused edge.

    Lives on ``EdgeState.device`` across feeds.  Per-key state —
    frequency tracker, CHK memory, replica matrix, open pane tables —
    stays on the device between launches; per-worker vectors (busy, counts,
    estimator) round-trip with each segment, keeping the host copies
    authoritative so event handling and metrics never need a separate
    sync.  ``host_sync`` folds the replica matrix back into the grouper —
    called before metrics/close and membership events.

    ``device``: ``None`` means ``"cuda"`` (raises without a card);
    ``"cpu"`` runs every kernel's plain version.
    """

    def __init__(self, grouper, state, sink, telemetry=None, device=None):
        self.device = resolve_device(device)
        self.scheme = grouper.name
        self.has_pane = sink is not None
        # launch/pane counters live in the metrics registry; ``dispatches``
        # is a per-feed window over the cumulative counter (one per segment)
        self.tel = telemetry if telemetry is not None else _NULL_TELEMETRY
        self._c_dispatches = self.tel.metrics.counter(
            "fused.dispatches", scheme=self.scheme)
        self._c_pane_flushes = self.tel.metrics.counter(
            "fused.pane_flushes", scheme=self.scheme)
        self._c_host_syncs = self.tel.metrics.counter(
            "fused.host_syncs", scheme=self.scheme)
        self._feed_base_dispatches = 0
        self._prev_hot: set = set()   # fish hot set at the last epoch point
        self._fish_epoch_idx = -1
        self._fish_epochs_crossed = 0
        self.pane_fed = 0         # tuples in the device pane, unsynced
        self._kcap = 0
        self._w1 = 0
        self._dmax = 1 if self.scheme == "fg" else (
            2 if self.scheme == "pkg" else 0)  # 0 = worker-universe width
        self._pts = None          # ring points (np uint32)
        self._cands = None        # ring candidate rows (np int32)
        self._pts_dev = None      # uint32 bit patterns in int32
        self._cands_dev = None
        self._hash_arr = None     # dense key -> hash32 cache (np uint32)
        self._hash_ok = None
        self._hash_dev = None     # device copy of the cache (per-key rows)
        self._hash_dirty = True
        self._repl_dirty = False
        # device-resident per-key state
        self.trk = None
        self.m_k = None
        self.repl = None
        self.pane_keys = None     # (C,) int64 pair keys of the open pane
        self.pane_vc = None       # (2, C) int32 value / count sums
        self.pane_last = None     # (w1,) last stream index per worker
        self._repl_synced = None  # replica pairs already folded to the host
        self._cnt = None          # tracker count scratch, kept all-zero

    @property
    def dispatches(self) -> int:
        """Segments in the current feed (the ``EdgeResult.dispatches``
        source) — a per-feed window on the registry's cumulative
        ``fused.dispatches`` counter."""
        return self._c_dispatches.value - self._feed_base_dispatches

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- shape management (rare) ---------------------------------------------
    def _ensure_shapes(self, grouper, state, kmax: int) -> None:
        w1 = state.busy_until.shape[0] + 1
        new_kcap = self._kcap
        if kmax >= new_kcap:
            new_kcap = _pow2_at_least(max(kmax + 1, MIN_BUCKET))
        if w1 == self._w1 and new_kcap == self._kcap:
            return
        old_k, old_w = self._kcap, self._w1
        kcap1 = new_kcap + 1
        dev = self.device
        self._hash_arr = _grow1(self._hash_arr, old_k, new_kcap, np.uint32)
        self._hash_ok = _grow1(self._hash_ok, old_k, new_kcap, np.bool_)
        self._hash_dirty = True
        if self.scheme in _RING_SCHEMES and new_kcap <= (1 << 14):
            # prefill the whole ring-hash cache at the (rare) resize so
            # steady-state feeds never touch SHA-1; for sparse key spaces
            # past 16k ids stay lazy per feed
            self._fill_hashes(np.flatnonzero(~self._hash_ok))
        # the old phantom key row (index old_k) is dropped by the [:old_k]
        # copy — it only ever holds the padding lanes' sink entries
        self.trk = _grow_dev(self.trk, (old_k,), (kcap1,), torch.float32,
                             dev)
        self.m_k = _grow_dev(self.m_k, (old_k,), (kcap1,), torch.int32, dev)
        self.repl = _grow_dev(self.repl, (old_k, old_w), (kcap1, w1),
                              torch.bool, dev)
        self._repl_synced = _grow_dev(self._repl_synced, (old_k, old_w),
                                      (kcap1, w1), torch.bool, dev)
        self._cnt = None  # re-made at the next tracker launch
        # the pane's pair keys do not depend on kcap1 or w1: it needs no
        # re-layout (pane_last follows w1 at the next segment)
        grew_w = w1 != self._w1
        self._kcap = new_kcap
        self._w1 = w1
        if grew_w:
            self.refresh_membership(grouper, state)

    def refresh_membership(self, grouper, state) -> None:
        """Rebuild the device ring table + live-set arrays after a
        membership change (or worker-universe growth)."""
        ring_span = self.tel.tracer.span("fused.refresh_membership",
                                         cat="fused")
        if self.scheme in _RING_SCHEMES:
            dmax = self._dmax or max(state.busy_until.shape[0], 2)
            self._pts, self._cands = _build_ring_table(grouper.ring, dmax)
            self._pts_dev = self._up(_u32_bits(self._pts))
            self._cands_dev = self._up(self._cands)
        act = np.asarray(sorted(state.active), dtype=np.int32)
        self._act = act
        act_pad = np.full(self._w1, self._w1 - 1, np.int32)
        act_pad[:act.shape[0]] = act
        act_mask = np.zeros(self._w1, bool)
        act_mask[act] = True
        self._act_pad = self._up(act_pad)
        self._act_mask = self._up(act_mask)
        ring_span.set(live=int(act.shape[0])).done()

    # -- per-feed lifecycle -------------------------------------------------
    def begin_feed(self, grouper, state, keys_arr, values, times,
                   sink) -> None:
        self._feed_base_dispatches = self._c_dispatches.value
        with self.tel.tracer.span("fused.begin_feed", cat="fused",
                                  n=int(keys_arr.shape[0])):
            self._base = float(times[0]) if times.shape[0] else 0.0
            kmax = int(keys_arr.max()) if keys_arr.shape[0] else 0
            self._ensure_shapes(grouper, state, kmax)
            self._feed_keys = keys_arr.astype(np.int32)
            self._feed_times = times
            if self.scheme in _RING_SCHEMES:
                self._feed_hash = self._hashes(keys_arr)
            if self.has_pane:
                from ..state.window import tuple_values

                self._feed_vals = tuple_values(
                    sink.op, keys_arr, payload=values).astype(np.int32)

    def _fill_hashes(self, miss: np.ndarray) -> None:
        if miss.shape[0]:
            # inlined hash32 for plain int keys (same SHA-1 bucket as
            # chash.hash32): skips the per-key canonicalise/dispatch
            sha1, fb = _sha1, int.from_bytes
            self._hash_arr[miss] = np.fromiter(
                (fb(sha1(repr(k).encode("utf-8")).digest()[:4], "big")
                 for k in miss.tolist()),
                dtype=np.uint32, count=miss.shape[0])
            self._hash_ok[miss] = True
            self._hash_dirty = True

    def _hashes(self, keys_arr: np.ndarray) -> np.ndarray:
        ok = self._hash_ok[keys_arr]
        if not ok.all():
            self._fill_hashes(np.unique(keys_arr[~ok]))
        return self._hash_arr[keys_arr]

    def _hash_device(self) -> torch.Tensor:
        """The per-key hash cache on the device (re-uploaded after fills)."""
        if self._hash_dirty or self._hash_dev is None:
            self._hash_dev = self._up(_u32_bits(self._hash_arr))
            self._hash_dirty = False
        return self._hash_dev

    def _count_table(self, ne: int) -> torch.Tensor:
        """The all-zero (epochs, kcap1) tracker count scratch."""
        if self._cnt is None or self._cnt.shape[0] < ne:
            self._cnt = torch.zeros((max(ne, 1), self._kcap + 1),
                                    dtype=torch.int32, device=self.device)
        return self._cnt

    def _tracker_args(self, grouper, lo: int, hi: int, offset: int):
        """The segment's tracker update: FISH decays at every epoch
        boundary (the boundary decay fires before the boundary tuple is
        counted; ``pre`` covers a segment starting on a boundary) and
        routes each epoch against its own end-of-epoch tracker; DC/WC do
        not decay (the reference tracker runs alpha=1, one giant epoch)."""
        if self.scheme != "fish":
            return dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
        p = grouper.params
        g0 = offset + lo
        g1 = offset + hi
        pre = 1 if (g0 > 0 and g0 % p.epoch == 0) else 0
        self._fish_epochs_crossed = (g1 - 1) // p.epoch - g0 // p.epoch + pre
        self._fish_epoch_idx = g1 // p.epoch
        return dict(g0=g0, epoch=p.epoch, pre=pre,
                    ne=(g1 - 1) // p.epoch - g0 // p.epoch + 1,
                    alpha=float(np.float32(p.alpha)))

    def _estimator_args(self, grouper, lo: int) -> dict:
        """Alg. 3 estimator state for the segment (host-authoritative)."""
        est = grouper.estimator
        now0 = float(self._feed_times[lo])
        do_tick = 0
        elapsed = 0.0
        if now0 - est._t_prior > est.interval:
            do_tick = 1
            elapsed = now0 - est._t_prior
            est._t_prior = now0
        w1 = self._w1
        ebl = np.zeros(w1, np.float32)
        eas = np.zeros(w1, np.float32)
        ecaps = np.ones(w1, np.float32)
        nw = est.backlog.shape[0]
        ebl[:nw] = est.backlog
        eas[:nw] = est.assigned
        ecaps[:nw] = est.capacities
        return dict(m_k=self.m_k, d_min=grouper.params.d_min,
                    ebl=self._up(ebl), eas=self._up(eas),
                    ecaps=self._up(ecaps), do_tick=do_tick,
                    elapsed=float(np.float32(elapsed)))

    def run_segment(self, grouper, state, lo: int, hi: int) -> np.ndarray:
        """One fused segment for tuples [lo, hi) of the current feed.
        Returns their absolute finish times (float64, host)."""
        tracer = self.tel.tracer
        seg_span = tracer.span("fused.segment", cat="fused",
                               scheme=self.scheme, lo=lo, hi=hi)
        prep_span = tracer.span("fused.segment.prep", cat="fused")
        m = hi - lo
        n_pad = _bucket(m)
        w1 = self._w1
        kcap1 = self._kcap + 1
        scheme = self.scheme

        keys_np = np.full(n_pad, self._kcap, np.int32)  # pad -> phantom row
        keys_np[:m] = self._feed_keys[lo:hi]
        t = np.zeros(n_pad, np.float64)
        t[:m] = self._feed_times[lo:hi] - self._base

        busy = np.zeros(w1, np.float64)
        busy[:w1 - 1] = state.busy_until - self._base
        caps = np.ones(w1, np.float64)
        caps[:w1 - 1] = state.capacities
        counts = np.zeros(w1, np.int32)
        cn = grouper.assigned_counts.shape[0]
        # the device kernel compares counts pairwise (PKG/DC argmin), never
        # absolutely — shifting all workers by the running minimum keeps
        # every comparison identical while the int64 lifetime totals stay
        # host-side, so 10⁸-tuple runs never push the int32 device domain
        # past 2³¹
        counts_base = int(grouper.assigned_counts.min()) if cn else 0
        rebased = grouper.assigned_counts - counts_base
        if rebased.max(initial=0) + m > 2 ** 31 - 1:
            raise ValueError(
                "fused feed: per-worker count spread exceeds int32 "
                f"(max-min = {int(rebased.max(initial=0))}, feed m = {m})")
        counts[:cn] = rebased

        keys = self._up(keys_np)
        busy_d, caps_d, counts_d = self._up(busy), self._up(caps), \
            self._up(counts)
        kw = {}
        rows = None
        if scheme == "sg":
            kw.update(act=self._act_pad, a_live=int(self._act.shape[0]),
                      rr=int(grouper._rr))
        else:
            width = self._cands.shape[1]
            if kcap1 <= n_pad:  # route keys via the cache, gather tuples
                hashes, tuple_keys = self._hash_device(), keys
            else:
                h = np.zeros(n_pad, np.uint32)
                h[:m] = self._feed_hash[lo:hi]
                hashes, tuple_keys = self._up(_u32_bits(h)), None
        if scheme in ("dc", "wc", "fish"):
            targs = self._tracker_args(grouper, lo, hi, state.offset)
        if scheme == "fish":
            kw.update(self._estimator_args(grouper, lo))
        vals = seg_base = None
        reset = False
        if self.has_pane:
            v = np.zeros(n_pad, np.int32)
            v[:m] = self._feed_vals[lo:hi]
            vals = self._up(v)
            reset = self.pane_fed == 0  # first segment of a fresh pane
            self._size_pane(m, w1, reset)
            seg_base = state.offset + lo
        prep_span.done()

        with tracer.span("fused.segment.launch", cat="fused", n_pad=n_pad,
                         phases="route|fifo|state-scatter"):
            if scheme != "sg":
                rows = ring_rows(self._pts_dev, self._cands_dev, hashes,
                                 tuple_keys, m, width, n_pad)
            if scheme in ("dc", "wc", "fish"):
                ne = targs["ne"]
                snap = (torch.empty((ne, kcap1), dtype=torch.float32,
                                    device=self.device) if ne > 1 else None)
                psum, pmax = tracker_update(
                    self.trk, self._count_table(ne), keys, m, snap=snap,
                    **targs)
                kw.update(trk=self.trk, snap=snap, psum=psum, pmax=pmax,
                          g0=targs["g0"], epoch=targs["epoch"],
                          theta=self._theta(grouper),
                          wnum=float(grouper.num_workers))
                if scheme == "wc":
                    kw["act_mask"] = self._act_mask
            fifo = dict(t=self._up(t), busy=busy_d, caps=caps_d,
                        counts=counts_d)
            if scheme in ("sg", "fg"):
                workers, fin_d = fifo_workers(scheme, m, rows=rows, **fifo,
                                              **kw)
            else:
                workers = route_scan(scheme, m, keys=keys, counts=counts_d,
                                     rows=rows, **kw)
                workers, fin_d = fifo_workers(scheme, m, workers=workers,
                                              **fifo)
            pane_update(keys, workers, m, repl=self.repl, vals=vals,
                        seg_base=seg_base if seg_base is not None else 0,
                        pane_keys=self.pane_keys if self.has_pane else None,
                        pane_vc=self.pane_vc, pane_last=self.pane_last,
                        reset=reset)
        self._c_dispatches.add(1)
        if self.has_pane:
            self.pane_fed += m
        self._repl_dirty = True

        # small per-worker vectors ride back after the segment
        with tracer.span("fused.segment.readback", cat="fused"):
            state.busy_until[:] = self._base + busy_d.cpu().numpy()[:w1 - 1]
            grouper.assigned_counts[:] = counts_base + counts_d.cpu().numpy(
            ).astype(np.int64)[:cn]
            if scheme == "sg":
                grouper._rr = int((grouper._rr + m) % self._act.shape[0])
            elif scheme == "fish":
                est = grouper.estimator
                nw = est.backlog.shape[0]
                est.backlog[:] = kw["ebl"].cpu().numpy().astype(
                    np.float64)[:nw]
                est.assigned[:] = kw["eas"].cpu().numpy().astype(
                    np.float64)[:nw]
            fin = self._base + fin_d[:m].cpu().numpy()
        if (scheme == "fish" and self.tel.enabled
                and self._fish_epochs_crossed):
            self._fish_epoch_points(grouper, state, lo, hi)
        seg_span.done()
        return fin

    def _size_pane(self, m: int, w1: int, reset: bool) -> None:
        """Keep the open pane's table at load <= 1/2 with the next ``m``
        tuples — decided on the host from ``pane_fed``, no readback.  A
        fresh pane keeps the last pane's table (the reset clears it), so a
        steady stream never grows; a pane that would pass half load moves
        to a table of ``pane_capacity`` slots, its slots re-inserted.
        ``pane_last`` follows the worker universe."""
        need = pane_capacity(self.pane_fed + m)
        have = 0 if self.pane_keys is None else self.pane_keys.shape[0]
        if need > have:
            if reset:
                self.pane_keys = torch.empty(need, dtype=torch.int64,
                                             device=self.device)
                self.pane_vc = torch.empty((2, need), dtype=torch.int32,
                                           device=self.device)
            else:
                self.pane_keys, self.pane_vc = pane_grow(
                    self.pane_keys, self.pane_vc, need)
        if self.pane_last is None or self.pane_last.shape[0] != w1:
            last = torch.full((w1,), -1, dtype=torch.int32,
                              device=self.device)
            if self.pane_last is not None and not reset:
                n = min(w1, self.pane_last.shape[0])
                last[:n] = self.pane_last[:n]
            self.pane_last = last

    def _theta(self, grouper) -> float:
        if self.scheme == "fish":
            return grouper.params.theta(grouper.num_workers)
        return grouper.theta  # dc/wc property (theta_frac / num_workers)

    def _fish_epoch_points(self, grouper, state, lo: int, hi: int) -> None:
        """Per-epoch FISH timeline (telemetry-enabled only): hot-set size
        and churn read off the *device* tracker after a segment that
        crossed one or more epoch boundaries, plus the per-worker
        imbalance at that instant — one readback per crossed epoch batch,
        never per tuple."""
        epoch_idx = self._fish_epoch_idx
        self.tel.ctx.epoch_idx = epoch_idx
        trk = self.trk.cpu().numpy()[:-1]  # drop the phantom padding row
        total = float(trk.sum())
        theta = grouper.params.theta(grouper.num_workers)
        hot = (set(np.flatnonzero(trk > theta * total).tolist())
               if total > 0.0 else set())
        churn = len(hot ^ self._prev_hot)
        self._prev_hot = hot
        tl = self.tel.timeline
        tl.point("fish.hot_set_size", len(hot), epoch_idx=epoch_idx)
        tl.point("fish.hot_set_churn", churn, epoch_idx=epoch_idx)
        counts = grouper.assigned_counts
        act = self._act
        if act.shape[0] and counts[act].sum() > 0:
            share = counts[act]
            tl.point("fish.worker_imbalance",
                     float(share.max() / max(share.mean(), 1e-12)),
                     epoch_idx=epoch_idx)
        self.tel.tracer.instant(
            "fish.epoch_decay", cat="fish", epoch=epoch_idx,
            crossed=int(self._fish_epochs_crossed), hot_set=len(hot))

    # -- host sync points ---------------------------------------------------
    def flush_pane(self, sink) -> None:
        """Sync the open device pane into the host KeyedStateManager and
        mark it empty (``merge_entries`` accumulates, so the pane can keep
        filling on the device afterwards; the next segment resets the
        table and keeps its size)."""
        if not self.has_pane or self.pane_fed == 0:
            return
        self._c_pane_flushes.add(1)
        flush_span = self.tel.tracer.span("fused.pane_flush", cat="fused",
                                          pane_fed=self.pane_fed)
        # the occupied slots (each with a count > 0), compacted and sorted
        # by pair key on the device: grouped per worker with keys
        # ascending; only the entries cross to the host (padding lanes
        # never enter the table)
        pairs_d, vc_d = pane_canonical(self.pane_keys, self.pane_vc)
        pairs = pairs_d.cpu().numpy()
        vc = vc_d.cpu().numpy().astype(np.int64)
        last = self.pane_last.cpu().numpy()
        entries = []
        if pairs.shape[0]:
            ws = pairs >> 32
            ks = pairs & 0xFFFFFFFF
            vs, cs = vc
            starts = np.concatenate(
                [[0], np.flatnonzero(ws[1:] != ws[:-1]) + 1, [ws.shape[0]]])
            for s, e in zip(starts[:-1].tolist(), starts[1:].tolist()):
                w = int(ws[s])
                entries.append((w, ks[s:e], vs[s:e], cs[s:e], int(last[w])))
        sink.feed_aggregated(self.pane_fed, entries)
        self.pane_fed = 0
        flush_span.done()

    def host_sync(self, grouper) -> None:
        """Fold device-resident per-key state back into the grouper: new
        (key, worker) replica pairs since the last sync.  Called before
        metrics/close and before membership events."""
        if not self._repl_dirty:
            return
        self._c_host_syncs.add(1)
        with self.tel.tracer.span("fused.host_sync", cat="fused"):
            new = self.repl[:-1, :-1] & ~self._repl_synced[:-1, :-1]
            pairs = torch.nonzero(new).cpu().numpy()
            for k, w in pairs.tolist():
                grouper.replicas.setdefault(int(k), set()).add(int(w))
            self._repl_synced.copy_(self.repl)
            self._repl_dirty = False


# -- growth helpers (rare: worker-universe or key-capacity growth) ------------


def _grow1(arr, old, new, dtype):
    out = np.zeros(new, dtype)
    if arr is not None:
        out[:old] = arr[:old]
    return out


def _grow_dev(arr, old_shape, new_shape, dtype, device):
    """Zeros of ``new_shape`` with the ``old_shape`` corner copied over.
    The old phantom column (a worker lane) may only hold phantom-row
    entries, which the key-row slice already drops."""
    out = torch.zeros(new_shape, dtype=dtype, device=device)
    if arr is not None:
        sl = tuple(slice(0, n) for n in old_shape)
        out[sl] = arr[sl]
    return out
