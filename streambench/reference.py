"""Plain NumPy reference of the keyed-stream path the benchmark times.

It imports NumPy and ``hashlib`` only: nothing of the program, no JAX.  It
works out again everything the program derives from the stream:

* the consistent-hash ring (SHA-1 truncated to 32 bits, ``virtual_nodes``
  points a worker, collisions probed forward; the paper's §5) and each
  ring position's first distinct owners clockwise;
* fields grouping (a key's first owner) and FISH: the dense frequency
  tracker decayed by ``alpha`` at every epoch boundary (Alg. 1), the hot
  test and CHK's candidate count from the tracker at the end of the
  tuple's epoch and the monotone memory ``M`` at its start (Alg. 2), the
  Eq. 1 estimator tick at a segment's start and the Eq. 2 argmin over the
  candidates (Alg. 3) — the fused engine's segment discipline;
* the per-worker FIFO ``f = max(busy, t) + P`` in arrival order;
* the periodic noisy capacity samples (a fresh ``default_rng`` of the
  engine's seed, as the simulator seeds its first edge) and the
  estimator's EMA of them;
* per-window, per-key sums and counts straight from the stream.

Floating point follows the stated precisions: timing in float64, the
tracker and the estimator in float32, one rounding per operation.
``Precision.lower()`` gives the control: timing in float32 and the
tracker in bfloat16 (rounded to nearest even after every operation).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

__all__ = ["Precision", "Ring", "EdgeModel", "session_rate",
           "window_aggregates", "hot_set", "imbalance"]

_RING = 1 << 32


def hash32(text: str) -> int:
    """SHA-1 of ``text`` (UTF-8), its first four bytes big-endian."""
    return int.from_bytes(hashlib.sha1(text.encode("utf-8")).digest()[:4],
                          "big")


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even)."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """The arithmetic of one evaluation: ``time`` for the FIFO's clocks
    and the capacity samples' average, ``tracker_bf16`` to round the
    tracker to bfloat16."""

    time: type = np.float64
    tracker_bf16: bool = False

    def lower(self) -> "Precision":
        return Precision(time=np.float32, tracker_bf16=True)

    def trk(self, x):
        x = np.asarray(x, dtype=np.float32)
        return _bf16(x) if self.tracker_bf16 else x


class Ring:
    """The consistent-hash ring of workers ``0..workers-1`` and, for each
    ring position, its owners in clockwise order of first appearance."""

    def __init__(self, workers: int, virtual_nodes: int):
        owner: Dict[int, int] = {}
        for w in range(workers):
            for i in range(virtual_nodes):
                pos = hash32(repr((w, i)))
                while pos in owner:
                    pos = (pos + 1) % _RING
                owner[pos] = w
        self.points = np.asarray(sorted(owner), dtype=np.uint64)
        owners = np.asarray([owner[int(p)] for p in self.points])
        r_n = self.points.shape[0]
        r = np.arange(r_n)
        # distance from each position to each worker's next point at or
        # after it, wrapping: the clockwise walk meets workers in this order
        dist = np.empty((r_n, workers), dtype=np.int64)
        for w in range(workers):
            pos = np.flatnonzero(owners == w)
            nxt = np.searchsorted(pos, r, side="left")
            dist[:, w] = np.where(nxt == pos.shape[0], pos[0] + r_n,
                                  pos[np.minimum(nxt, pos.shape[0] - 1)]) - r
        self.order = np.argsort(dist, axis=1).astype(np.int64)

    def positions(self, keys: np.ndarray) -> np.ndarray:
        """Each key's ring position: the first point clockwise past its
        hash."""
        uniq, inv = np.unique(keys, return_inverse=True)
        h = np.fromiter((hash32(repr(int(k))) for k in uniq.tolist()),
                        dtype=np.uint64, count=uniq.shape[0])
        idx = np.searchsorted(self.points, h, side="right")
        return (idx % self.points.shape[0])[inv]


@dataclasses.dataclass
class EdgeModel:
    """One grouped edge of the deployment, fed in stream order.

    ``scheme`` is ``"fg"`` or ``"fish"``; ``workers``, ``rate`` (the
    tuples per second the simulator infers from a session's first feed,
    :func:`session_rate`), ``utilization``, ``sample_every``,
    ``sample_noise``, ``stride`` (the pane grid the engine cuts segments
    on) and the FISH parameters come from the configuration.
    :meth:`fresh` builds the state of a new session; :meth:`from_state`
    starts from a given one."""

    scheme: str
    workers: int
    ring: Ring
    key_rows: int
    rate: float
    utilization: float
    sample_every: int
    sample_noise: float
    stride: int
    alpha: float = 0.2
    epoch: int = 1000
    theta_frac: float = 0.25
    d_min: int = 2
    interval: float = 10.0
    engine_seed: int = 0
    precision: Precision = Precision()
    state: Optional[dict] = None
    segments: Optional[list] = None

    # -- state -----------------------------------------------------------
    def service_times(self) -> np.ndarray:
        """Each worker's seconds per tuple: utilization spread evenly."""
        return np.full(self.workers, self.utilization * self.workers
                       / self.rate)

    def estimator_capacities(self, offset: int) -> np.ndarray:
        """The FISH estimator's capacities after the first ``offset``
        tuples: the initial sample's EMA, then one noisy sample per worker
        at every ``sample_every`` tuples, drawn from the engine's seed."""
        t = self.precision.time
        caps = self.service_times().astype(t)
        ec = t(0.5) * caps + t(0.5) * np.ones(self.workers, t)
        rng = np.random.default_rng(self.engine_seed)
        for _ in range(offset // self.sample_every):
            noisy = caps * (t(1.0) + rng.normal(0.0, self.sample_noise,
                                                self.workers).astype(t))
            ec = t(0.5) * np.maximum(noisy, t(1e-12)) + t(0.5) * ec
        return ec.astype(np.float64)

    def fresh(self) -> dict:
        w = self.workers
        st = dict(offset=0, busy=np.zeros(w), counts=np.zeros(w, np.int64))
        if self.scheme == "fish":
            st.update(trk=np.zeros(self.key_rows, np.float32),
                      carry=np.zeros(2, np.float32),
                      mk=np.zeros(self.key_rows, np.int64),
                      bl=np.zeros(w, np.float32), asn=np.zeros(w, np.float32),
                      t_prior=0.0)
        return st

    def from_state(self, st: dict) -> None:
        self.state = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                      for k, v in st.items()}

    # -- one feed -----------------------------------------------------------
    def feed(self, keys: np.ndarray, times: np.ndarray):
        """Route and time one feed from :attr:`state` (updated).  Returns
        (workers int64, finish times)."""
        st = self.state
        self.segments = []  # per FISH segment: its shape and counts ``d``
        n = keys.shape[0]
        off = st["offset"]
        cuts = sorted({0, n, *range((-off) % self.stride or self.stride,
                                    n, self.stride)})
        pos = self.ring.positions(keys)
        workers = np.empty(n, dtype=np.int64)
        fin = np.empty(n, dtype=np.float64)
        base = float(times[0])
        tdt = self.precision.time
        caps = self.service_times().astype(tdt)
        ec = self.estimator_capacities(off).astype(np.float32)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            if self.scheme == "fg":
                wk = self.ring.order[pos[lo:hi], 0]
            else:
                wk = self._fish_segment(keys[lo:hi], pos[lo:hi],
                                        float(times[lo]), off + lo, ec)
            workers[lo:hi] = wk
            np.add.at(st["counts"], wk, 1)
            # clocks relative to the feed's first arrival, as the engine
            # keeps them on the device, re-based at every segment
            t = (times[lo:hi] - base).astype(tdt)
            busy = (st["busy"] - base).astype(tdt)
            fin[lo:hi] = self._fifo(wk, t, busy, caps)
            st["busy"] = base + busy.astype(np.float64)
            if self.scheme == "fish":  # samples crossed by the segment
                k0 = (off + lo) // self.sample_every
                if (off + hi) // self.sample_every > k0:
                    ec = self.estimator_capacities(off + hi).astype(
                        np.float32)
        st["offset"] = off + n
        return workers, base + fin

    @staticmethod
    def _fifo(wk, t, busy, caps) -> np.ndarray:
        out = np.empty(t.shape[0], dtype=np.float64)
        bz = busy.tolist()
        cp = caps.tolist()
        lowp = busy.dtype == np.float32
        f32 = np.float32
        for i, (w, ti) in enumerate(zip(wk.tolist(), t.tolist())):
            f = max(bz[w], ti) + cp[w]
            if lowp:
                f = float(f32(f))
            bz[w] = f
            out[i] = f
        busy[:] = bz
        return out

    def _fish_segment(self, keys, pos, now0: float, g0: int,
                      ec: np.ndarray) -> np.ndarray:
        st = self.state
        prec = self.precision
        f32 = np.float32
        m = keys.shape[0]
        e = self.epoch
        a = f32(self.alpha)
        theta = f32(self.theta_frac / float(self.workers))
        wnum = f32(self.workers)
        trk, carry, mk = st["trk"], st["carry"], st["mk"]
        total, mx = f32(carry[0]), f32(carry[1])
        # estimator tick (Eq. 1) when the segment starts past the interval
        bl, asn = st["bl"], st["asn"]
        if now0 - st["t_prior"] > self.interval:
            el = f32(now0 - st["t_prior"])
            work = (bl + asn) * ec
            bl = np.where(work > el, (work - el) / ec, f32(0)).astype(f32)
            asn = np.zeros_like(asn)
            st["t_prior"] = now0
        d = np.empty(m, dtype=np.int64)
        touched = np.unique(keys)
        mk_before = mk[touched].copy()
        for j, lo in enumerate(range(0, m, e) if g0 % e == 0 else
                               [0, *range(e - g0 % e, m, e)]):
            hi = min(m, (g0 + lo) // e * e + e - g0)
            if g0 + lo > 0 and (g0 + lo) % e == 0:  # epoch boundary decay
                trk = prec.trk(trk * a)
                total, mx = (f32(prec.trk(total * a)),
                             f32(prec.trk(mx * a)))
            kj = keys[lo:hi]
            u, c = np.unique(kj, return_counts=True)
            trk[u] = prec.trk(trk[u] + c.astype(f32))
            total = f32(prec.trk(total + f32(hi - lo)))
            mx = max(mx, f32(trk[u].max()))
            f_top = mx / total if total > 0 else f32(0)
            f = (trk[kj] / total if total > 0
                 else np.zeros(hi - lo, f32)).astype(f32)
            hot = (f > theta) & (f > 0) & (f_top > 0)
            ratio = np.maximum(f_top / np.maximum(f, f32(1e-30)), f32(1))
            idx = np.clip(np.frexp(ratio)[1] - 1, 0, 30)
            d0 = np.floor(np.ldexp(wnum, -idx).astype(f32))
            d0 = np.minimum(np.maximum(d0, f32(self.d_min)), wnum).astype(
                np.int64)
            m_prev = mk[kj]
            d[lo:hi] = np.where(hot, np.maximum(d0, m_prev), 2)
            np.maximum.at(mk, kj, np.where(hot, np.maximum(m_prev, d0), 0))
        carry[0], carry[1] = total, mx
        st["trk"] = trk
        self.segments.append(dict(
            m=m, d=d, epochs=j + 1, keys_read=int(touched.shape[0]),
            keys_written=int((mk[touched] != mk_before).sum())))
        # the sequential Eq. 2 chain over the candidates
        order = self.ring.order
        out = np.empty(m, dtype=np.int64)
        for i in range(m):
            c = order[pos[i], :d[i]]
            w = c[np.argmin((bl[c] + asn[c]) * ec[c])]
            asn[w] += f32(1)
            out[i] = w
        st["bl"], st["asn"] = bl, asn
        return out


def session_rate(first_times: np.ndarray, hint: float) -> float:
    """The arrival rate the simulator infers from a session's first feed:
    its tuples over their time span, else the session's hint."""
    m = first_times.shape[0]
    span = float(first_times[-1] - first_times[0]) if m > 1 else 0.0
    return (m - 1) / span if span > 0 else hint


def window_aggregates(keys: np.ndarray, values: np.ndarray, size: int):
    """Tumbling windows of ``size`` tuples: ``{window start: (keys,
    sums, counts)}``, keys ascending, sums of the integer payload."""
    out = {}
    vals = values.astype(np.int64)
    for lo in range(0, keys.shape[0], size):
        k = keys[lo:lo + size].astype(np.int64)
        uniq, inv, cnt = np.unique(k, return_inverse=True,
                                   return_counts=True)
        sums = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(sums, inv, vals[lo:lo + size])
        out[lo] = (uniq, sums, cnt.astype(np.int64))
    return out


def hot_set(trk: np.ndarray, total: float, workers: int,
            theta_frac: float) -> np.ndarray:
    """Keys whose tracked frequency exceeds FISH's threshold."""
    theta = np.float32(theta_frac / float(workers))
    if total <= 0:
        return np.empty(0, dtype=np.int64)
    return np.flatnonzero(trk / np.float32(total) > theta)


def imbalance(counts: np.ndarray) -> float:
    """The paper's imbalance: (max - mean) / mean of tuples per worker."""
    c = counts.astype(np.float64)
    return float((c.max() - c.mean()) / max(c.mean(), 1e-12))
