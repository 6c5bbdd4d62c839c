"""Consistent hashing with virtual nodes (paper §5, Fig. 8).

Maps keys onto a 2^32 ring; workers are placed via ``v`` virtual nodes each
(paper Fig. 8(d)) so that small deployments stay balanced.  Worker addition /
removal only remaps the keys between the affected ring arcs (monotonicity —
property-tested in tests/test_chash.py).

The hash is SHA-1 truncated to 32 bits, per the paper's footnote 3 ([35] =
RFC 3174 SHA-1).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Hashable, Iterable, List, Optional

import numpy as np

__all__ = ["hash32", "ConsistentHashRing"]

_RING = 1 << 32


def _canon(value):
    """Canonicalise numpy scalars so ``np.int32(5)`` and ``5`` hash alike.

    The batched grouping engine interns keys to int32 ids while the sequential
    reference iterates numpy scalars out of the same array; both must land on
    the same ring position.
    """
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, tuple):
        return tuple(_canon(v) for v in value)
    return value


def hash32(value) -> int:
    """SHA-1 based 32-bit bucket id (paper footnote 3)."""
    if not isinstance(value, bytes):
        value = repr(_canon(value)).encode("utf-8")
    return int.from_bytes(hashlib.sha1(value).digest()[:4], "big")


class ConsistentHashRing:
    """Clockwise consistent-hash ring with virtual nodes."""

    def __init__(self, workers: Iterable[Hashable] = (), virtual_nodes: int = 64):
        if virtual_nodes < 1:
            raise ValueError("virtual_nodes must be >= 1")
        self.virtual_nodes = virtual_nodes
        self._points: List[int] = []  # sorted ring positions
        self._owner: Dict[int, Hashable] = {}  # position -> worker
        self._workers: Dict[Hashable, List[int]] = {}
        for w in workers:
            self.add_worker(w)

    # -- membership --------------------------------------------------------------
    def add_worker(self, worker: Hashable) -> None:
        if worker in self._workers:
            raise KeyError(f"worker {worker!r} already on ring")
        points = []
        for i in range(self.virtual_nodes):
            pos = hash32((worker, i))
            while pos in self._owner:  # extremely unlikely collision
                pos = (pos + 1) % _RING
            self._owner[pos] = worker
            bisect.insort(self._points, pos)
            points.append(pos)
        self._workers[worker] = points

    def remove_worker(self, worker: Hashable) -> None:
        points = self._workers.pop(worker)
        for pos in points:
            del self._owner[pos]
            idx = bisect.bisect_left(self._points, pos)
            del self._points[idx]

    def clone(self) -> "ConsistentHashRing":
        """Structural copy without re-hashing any virtual node.

        Building a W=128 ring costs W×v SHA-1 calls; cloning is a few dict
        copies.  Used by the grouper factory to amortise ring construction
        across benchmark runs.
        """
        ring = ConsistentHashRing((), virtual_nodes=self.virtual_nodes)
        ring._points = list(self._points)
        ring._owner = dict(self._owner)
        ring._workers = {w: list(ps) for w, ps in self._workers.items()}
        return ring

    @property
    def workers(self) -> List[Hashable]:
        return list(self._workers)

    def __len__(self) -> int:
        return len(self._workers)

    def __contains__(self, worker) -> bool:
        return worker in self._workers

    # -- lookup -------------------------------------------------------------------
    def lookup(self, key) -> Hashable:
        """Nearest worker clockwise from hash(key) (paper Fig. 8(a))."""
        if not self._points:
            raise LookupError("ring is empty")
        pos = hash32(key)
        idx = bisect.bisect_right(self._points, pos)
        if idx == len(self._points):
            idx = 0  # wrap around the ring
        return self._owner[self._points[idx]]

    def lookup_n(self, key, n: int) -> List[Hashable]:
        """First ``n`` *distinct* workers clockwise — candidate set for a hot
        key that CHK assigned d workers (Alg. 2 'through a consistent hash')."""
        if not self._points:
            raise LookupError("ring is empty")
        n = min(n, len(self._workers))
        pos = hash32(key)
        idx = bisect.bisect_right(self._points, pos)
        out: List[Hashable] = []
        seen = set()
        total = len(self._points)
        for step in range(total):
            owner = self._owner[self._points[(idx + step) % total]]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) == n:
                    break
        return out
