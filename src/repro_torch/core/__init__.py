"""FISH core of the port: Algs. 1-3 (host parts and the device epoch
table), CHK, consistent hashing, the baseline groupings and the DSPE
simulator (batched, reference and fused engines)."""

from .assignment import WorkerStateEstimator, greedy_allocate, select_min_wait
from .baselines import (
    DChoices,
    FieldGrouping,
    FishGrouper,
    Grouper,
    PartialKeyGrouping,
    ShuffleGrouping,
    WChoices,
)
from .chash import ConsistentHashRing, hash32
from .fish import (
    EpochFrequencyTracker,
    FishParams,
    FishState,
    chk_num_workers,
    chk_num_workers_batch,
    classify_hot_keys,
    epoch_update,
    init_fish_state,
)
from .stream import (
    CapacityEvent,
    EdgeResult,
    EdgeState,
    MembershipEvent,
    StreamMetrics,
    at_time,
    edge_metrics,
    simulate_edge,
)

__all__ = [
    "WorkerStateEstimator",
    "greedy_allocate",
    "select_min_wait",
    "DChoices",
    "FieldGrouping",
    "FishGrouper",
    "Grouper",
    "PartialKeyGrouping",
    "ShuffleGrouping",
    "WChoices",
    "ConsistentHashRing",
    "hash32",
    "EpochFrequencyTracker",
    "FishParams",
    "chk_num_workers",
    "chk_num_workers_batch",
    "FishState",
    "classify_hot_keys",
    "epoch_update",
    "init_fish_state",
    "CapacityEvent",
    "EdgeResult",
    "EdgeState",
    "MembershipEvent",
    "StreamMetrics",
    "at_time",
    "edge_metrics",
    "simulate_edge",
]
