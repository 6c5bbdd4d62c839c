"""Typed grouping-scheme configs — the declarative face of the registry.

One frozen dataclass per scheme (paper §2.2 baselines + FISH), each with
eager validation and a ``build(num_workers)`` method that constructs the
matching :class:`~repro_torch.core.baselines.Grouper`.  An :class:`Edge` in a
:class:`~repro_torch.topology.graph.Topology` carries one of these configs, so a
whole dataflow DAG is a plain, hashable, printable value.

The registry here is the single source of truth for scheme names; code
uses :func:`build_grouper` (accepts a name or a config) or the configs
directly.  The reference's deprecated ``make_grouper`` shim is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Type

import numpy as np

from ..core.baselines import (DChoices, FieldGrouping, FishGrouper, Grouper,
                              PartialKeyGrouping, ShuffleGrouping, WChoices)
from ..core.fish import FishParams

__all__ = [
    "SchemeConfig",
    "ShuffleConfig",
    "FieldConfig",
    "PKGConfig",
    "DChoicesConfig",
    "WChoicesConfig",
    "FishConfig",
    "SCHEME_CONFIGS",
    "config_for",
    "build_grouper",
]


def _check_positive_int(name: str, value: int) -> None:
    if not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


@dataclasses.dataclass(frozen=True)
class SchemeConfig:
    """Base class for per-scheme typed configs.

    Subclasses set ``scheme`` (the registry name) and override
    :meth:`build`.  Configs are frozen values: reusable across edges and
    topologies; ``build`` always returns a *fresh* grouper.
    """

    scheme: ClassVar[str] = "base"

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        """Construct a fresh grouper for ``num_workers`` workers.

        ``capacities`` (seconds/tuple per worker) is honored by
        capacity-aware schemes (FISH) and ignored by the rest.
        """
        raise NotImplementedError

    def _check_workers(self, num_workers: int) -> None:
        _check_positive_int("num_workers", num_workers)


@dataclasses.dataclass(frozen=True)
class ShuffleConfig(SchemeConfig):
    """SG — round-robin over the live worker set; ignores the key."""

    scheme: ClassVar[str] = "sg"

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return ShuffleGrouping(num_workers)


@dataclasses.dataclass(frozen=True)
class FieldConfig(SchemeConfig):
    """FG — single owner per key (nearest live worker on the ring)."""

    scheme: ClassVar[str] = "fg"
    virtual_nodes: int = 64

    def __post_init__(self) -> None:
        _check_positive_int("virtual_nodes", self.virtual_nodes)

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return FieldGrouping(num_workers, virtual_nodes=self.virtual_nodes)


@dataclasses.dataclass(frozen=True)
class PKGConfig(SchemeConfig):
    """PKG — power-of-two-choices between the first 2 ring candidates."""

    scheme: ClassVar[str] = "pkg"
    virtual_nodes: int = 64

    def __post_init__(self) -> None:
        _check_positive_int("virtual_nodes", self.virtual_nodes)

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return PartialKeyGrouping(num_workers,
                                  virtual_nodes=self.virtual_nodes)


@dataclasses.dataclass(frozen=True)
class DChoicesConfig(SchemeConfig):
    """D-Choices — lifetime heavy hitters get d ring candidates."""

    scheme: ClassVar[str] = "dc"
    k_max: int = 1000
    theta_frac: float = 0.25

    def __post_init__(self) -> None:
        _check_positive_int("k_max", self.k_max)
        if self.theta_frac <= 0.0:
            # theta = theta_frac / W; the paper sweeps up to 2/n (Fig. 13)
            raise ValueError(f"theta_frac must be positive, got "
                             f"{self.theta_frac!r}")

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return DChoices(num_workers, k_max=self.k_max,
                        theta_frac=self.theta_frac)


@dataclasses.dataclass(frozen=True)
class WChoicesConfig(DChoicesConfig):
    """W-Choices — heavy hitters may use the entire live worker set."""

    scheme: ClassVar[str] = "wc"

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return WChoices(num_workers, k_max=self.k_max,
                        theta_frac=self.theta_frac)


@dataclasses.dataclass(frozen=True)
class FishConfig(SchemeConfig):
    """FISH — Alg. 1 epoch decay + Alg. 2 CHK + Alg. 3 assignment over
    consistent-hash candidates (the paper's grouper, Table 1 defaults)."""

    scheme: ClassVar[str] = "fish"
    alpha: float = 0.2
    epoch: int = 1000
    k_max: int = 1000
    theta_frac: float = 0.25
    d_min: int = 2
    interval: float = 10.0
    virtual_nodes: int = 64
    use_consistent_hash: bool = True

    def __post_init__(self) -> None:
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha!r}")
        _check_positive_int("epoch", self.epoch)
        _check_positive_int("k_max", self.k_max)
        _check_positive_int("d_min", self.d_min)
        _check_positive_int("virtual_nodes", self.virtual_nodes)
        if self.theta_frac <= 0.0:
            # theta = theta_frac / W; the paper sweeps up to 2/n (Fig. 13)
            raise ValueError(f"theta_frac must be positive, got "
                             f"{self.theta_frac!r}")
        if self.interval <= 0.0:
            raise ValueError(f"interval must be positive, got "
                             f"{self.interval!r}")

    def to_params(self) -> FishParams:
        return FishParams(alpha=self.alpha, epoch=self.epoch,
                          k_max=self.k_max, theta_frac=self.theta_frac,
                          d_min=self.d_min)

    @classmethod
    def from_params(cls, params: FishParams, **overrides) -> "FishConfig":
        return cls(alpha=params.alpha, epoch=params.epoch,
                   k_max=params.k_max, theta_frac=params.theta_frac,
                   d_min=params.d_min, **overrides)

    def build(self, num_workers: int,
              capacities: Optional[np.ndarray] = None) -> Grouper:
        self._check_workers(num_workers)
        return FishGrouper(
            num_workers,
            params=self.to_params(),
            capacities=capacities,
            interval=self.interval,
            virtual_nodes=self.virtual_nodes,
            use_consistent_hash=self.use_consistent_hash,
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCHEME_CONFIGS: Dict[str, Type[SchemeConfig]] = {
    c.scheme: c for c in (ShuffleConfig, FieldConfig, PKGConfig,
                          DChoicesConfig, WChoicesConfig, FishConfig)
}


def config_for(scheme: str, **overrides) -> SchemeConfig:
    """Default typed config for ``scheme``, with field overrides."""
    try:
        cls = SCHEME_CONFIGS[scheme.lower()]
    except KeyError:
        raise ValueError(f"unknown grouping scheme {scheme!r}; one of "
                         f"{sorted(SCHEME_CONFIGS)}")
    return cls(**overrides)


def build_grouper(spec, num_workers: int,
                  capacities: Optional[np.ndarray] = None) -> Grouper:
    """Build a grouper from a :class:`SchemeConfig` or a scheme name
    (string specs resolve to the default config for that scheme)."""
    if isinstance(spec, SchemeConfig):
        return spec.build(num_workers, capacities=capacities)
    if isinstance(spec, str):
        return config_for(spec).build(num_workers, capacities=capacities)
    raise TypeError(f"grouping spec must be a SchemeConfig or scheme name, "
                    f"got {type(spec).__name__}")
