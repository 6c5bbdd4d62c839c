"""Unified dataflow topology API — the front door to the system.

Typed per-scheme configs (:mod:`.configs`), declarative multi-stage
topologies (:mod:`.graph`), and one engine protocol with a DSPE simulator
and a serving-engine adapter behind it (:mod:`.engine`)::

    from repro_torch.topology import (Edge, FishConfig, ShuffleConfig,
                                SimulatorEngine, Source, Stage, Topology,
                                hashed_fanout)

    topo = Topology(
        name="word_count",
        stages=(Stage("split", parallelism=4,
                      transform=hashed_fanout(4, vocab=1_000)),
                Stage("count", parallelism=8)),
        edges=(Edge("source", "split", ShuffleConfig()),
               Edge("split", "count", FishConfig())),
    )
    report = SimulatorEngine().run(topo, Source(keys, arrival_rate=2e4))
    print(report.edge("count").latency_p99)
"""

from ..state.window import WindowOp  # keyed operator state on a Stage
from .configs import (SCHEME_CONFIGS, DChoicesConfig, FieldConfig,
                      FishConfig, PKGConfig, SchemeConfig, ShuffleConfig,
                      WChoicesConfig, build_grouper, config_for)
from .engine import (EdgeReport, Engine, FeedReceipt, RemapAccountant,
                     ServingSession, ServingTopologyEngine, Session,
                     SimulatorEngine, SimulatorSession, TopologyReport)
from .graph import (SOURCE, Edge, KeyTransform, RecordBatch, ScopedEvent,
                    Source, Stage, Topology, hashed_fanout, project_mod)

__all__ = [
    "SCHEME_CONFIGS",
    "SchemeConfig",
    "ShuffleConfig",
    "FieldConfig",
    "PKGConfig",
    "DChoicesConfig",
    "WChoicesConfig",
    "FishConfig",
    "config_for",
    "build_grouper",
    "SOURCE",
    "KeyTransform",
    "hashed_fanout",
    "project_mod",
    "Stage",
    "Edge",
    "Topology",
    "RecordBatch",
    "Source",
    "ScopedEvent",
    "WindowOp",
    "Engine",
    "Session",
    "EdgeReport",
    "TopologyReport",
    "RemapAccountant",
    "SimulatorEngine",
    "SimulatorSession",
    "ServingTopologyEngine",
    "ServingSession",
    "FeedReceipt",
]
