"""Keyed operator-state subsystem.

Real downstream operator state for the grouped edges of a topology:
per-worker state stores in two backends (:mod:`.store`), windowed stateful
operators with split-key partials (:mod:`.window`), the downstream merge +
the routing-free oracle (:mod:`.merge`), and the state-migration protocol
under churn (:mod:`.migration`).

Attach a :class:`WindowOp` to a :class:`repro_torch.topology.Stage` and both
topology engines maintain the state, account migration cost on membership
events, and emit partial aggregates into a downstream merge stage; see
DESIGN.md §9.
"""

from .merge import direct_aggregate, merge_partials, topk_cut
from .migration import MigrationStats, apply_membership_change
from .store import (ENTRY_BYTES, STORE_BACKENDS, ArrayStateStore,
                    DeviceStateStore, DictStateStore, make_store)
from .window import (KeyedStateManager, StateReport, WindowOp, WindowPartial,
                     tuple_values)

__all__ = [
    "ENTRY_BYTES",
    "STORE_BACKENDS",
    "ArrayStateStore",
    "DeviceStateStore",
    "DictStateStore",
    "make_store",
    "WindowOp",
    "WindowPartial",
    "StateReport",
    "KeyedStateManager",
    "tuple_values",
    "merge_partials",
    "direct_aggregate",
    "topk_cut",
    "MigrationStats",
    "apply_membership_change",
]
