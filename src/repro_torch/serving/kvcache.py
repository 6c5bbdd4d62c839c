"""Batched KV-cache slot manager for continuous batching.

A replica owns a fixed-capacity decode cache (``B_slots`` sequences).  The
manager hands out slots, tracks per-slot sequence positions, and frees slots
on completion — the serving-side "bounded memory" mirror of the paper's
K_max-bounded counter set.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["SlotManager"]


class SlotManager:
    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.free: List[int] = list(range(num_slots))
        self.active: Dict[int, dict] = {}  # slot -> request metadata

    def allocate(self, request_id, session_key, now: float) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop()
        self.active[slot] = {
            "request_id": request_id,
            "session": session_key,
            "start": now,
            "tokens": 0,
        }
        return slot

    def release(self, slot: int) -> dict:
        meta = self.active.pop(slot)
        self.free.append(slot)
        return meta

    def utilization(self) -> float:
        return len(self.active) / self.num_slots

    def __len__(self) -> int:
        return len(self.active)
