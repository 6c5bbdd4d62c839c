"""Fault tolerance: heartbeat failure detection + restart policy.

This is the control plane a multi-pod deployment runs next to the training
loop.  It is exercised in simulation (tests + examples): a
:class:`HeartbeatMonitor` tracks per-host heartbeats on a logical clock,
declares hosts dead after ``timeout`` missed intervals, and the
:class:`RestartPolicy` decides between (a) elastic continue (drop the host,
rescale via consistent hashing) and (b) checkpoint restart (when too many
hosts died or a non-recoverable component failed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

__all__ = ["HeartbeatMonitor", "RestartPolicy", "FaultEvent"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    time: float
    kind: str              # "host_dead" | "host_joined" | "restart"
    host: Optional[int] = None
    detail: str = ""


class HeartbeatMonitor:
    """Logical-clock heartbeat tracking (paper-style periodic sampling)."""

    def __init__(self, hosts: Sequence[int], timeout: float = 30.0):
        self.timeout = timeout
        self.last_seen: Dict[int, float] = {h: 0.0 for h in hosts}
        self.dead: Set[int] = set()
        self.events: List[FaultEvent] = []

    def heartbeat(self, host: int, now: float) -> None:
        if host in self.dead:
            self.dead.discard(host)
            self.events.append(FaultEvent(now, "host_joined", host))
        self.last_seen[host] = now

    def check(self, now: float) -> List[int]:
        """Returns hosts newly declared dead at ``now``."""
        newly = []
        for h, t in self.last_seen.items():
            if h not in self.dead and now - t > self.timeout:
                self.dead.add(h)
                newly.append(h)
                self.events.append(FaultEvent(now, "host_dead", h))
        return newly

    def alive(self) -> List[int]:
        return sorted(h for h in self.last_seen if h not in self.dead)


class RestartPolicy:
    """Decide elastic-continue vs checkpoint-restart on failures.

    * fewer than ``max_lost_frac`` of hosts lost  -> elastic continue
      (consistent-hash remap keeps most key->host state, paper §5);
    * otherwise -> restore from the last committed checkpoint.
    """

    def __init__(
        self,
        total_hosts: int,
        max_lost_frac: float = 0.25,
        on_rescale: Optional[Callable[[List[int]], None]] = None,
        on_restart: Optional[Callable[[], int]] = None,
    ):
        self.total = total_hosts
        self.max_lost_frac = max_lost_frac
        self.on_rescale = on_rescale
        self.on_restart = on_restart
        self.restarts = 0
        self.rescales = 0

    def handle(self, monitor: HeartbeatMonitor, now: float) -> str:
        alive = monitor.alive()
        lost = self.total - len(alive)
        if lost == 0:
            return "healthy"
        if lost / self.total <= self.max_lost_frac:
            self.rescales += 1
            if self.on_rescale:
                self.on_rescale(alive)
            monitor.events.append(
                FaultEvent(now, "restart", None,
                           f"elastic continue with {len(alive)} hosts")
            )
            return "rescaled"
        self.restarts += 1
        if self.on_restart:
            self.on_restart()
        monitor.events.append(
            FaultEvent(now, "restart", None, "checkpoint restart")
        )
        return "restarted"
