"""Elastic worker membership on a consistent-hash ring (paper §5).

Tracks the active host set for the data pipeline / serving router and
quantifies remap cost when membership changes — the paper's Fig. 17
experiment is the benchmark over this module.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from ..core.chash import ConsistentHashRing

__all__ = ["ElasticPool"]


class ElasticPool:
    def __init__(self, hosts: Iterable[int], virtual_nodes: int = 64):
        self.ring = ConsistentHashRing(hosts, virtual_nodes=virtual_nodes)
        self.remap_log: List[Tuple[str, int, int]] = []  # (op, host, moved)

    @property
    def hosts(self) -> List[int]:
        return sorted(self.ring.workers)

    def owner(self, key) -> int:
        return self.ring.lookup(key)

    def add_host(self, host: int, sample_keys: Iterable = ()) -> int:
        """Add a host; returns how many of ``sample_keys`` moved."""
        before = {k: self.ring.lookup(k) for k in sample_keys}
        self.ring.add_worker(host)
        moved = sum(1 for k, o in before.items() if self.ring.lookup(k) != o)
        self.remap_log.append(("add", host, moved))
        return moved

    def remove_host(self, host: int, sample_keys: Iterable = ()) -> int:
        before = {k: self.ring.lookup(k) for k in sample_keys}
        self.ring.remove_worker(host)
        moved = sum(1 for k, o in before.items() if self.ring.lookup(k) != o)
        self.remap_log.append(("remove", host, moved))
        return moved
