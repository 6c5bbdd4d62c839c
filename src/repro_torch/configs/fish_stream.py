"""The paper's own workload config: FISH stream-grouping defaults (§6.1/§6.3)
for the DSPE simulator, data pipeline and serving router."""

import dataclasses

from ..core.fish import FishParams


@dataclasses.dataclass(frozen=True)
class StreamWorkloadConfig:
    num_workers: int = 128         # paper's largest scale
    num_sources: int = 32          # RQ5 Storm topology: 32 sources
    fish: FishParams = dataclasses.field(default_factory=FishParams)
    arrival_rate: float = 10_000.0  # tuples/s
    estimator_interval: float = 10.0  # paper's T = 10 s
    virtual_nodes: int = 64        # consistent-hash virtual nodes per worker


CONFIG = StreamWorkloadConfig()
