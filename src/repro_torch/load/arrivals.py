"""Arrival processes for open-loop load generation.

Closed-loop sessions feed whenever the engine is ready, so the engine is
never *behind* — the regime where the paper's latency reductions actually
matter (sustained overload, flash crowds) is unreachable.  This module
generates timestamped :class:`~repro_torch.topology.graph.RecordBatch`es on a
fixed tick grid **independent of engine progress**:

* a :class:`RateFn` gives the instantaneous offered rate λ(t) in
  tuples/second.  Rate functions compose multiplicatively (``base * mod``):
  :class:`ConstantRate`, :class:`DiurnalRate` (sinusoid modulation),
  :class:`FlashCrowd` (a transient spike multiplier), and
  :class:`MarkovModulatedRate` (MMPP-style regime switching);
* a key process draws the per-record keys: :class:`ZipfKeys` (steady Zipf,
  optional slow hot-key *rotation* drift) and :class:`FlipZipfKeys` (the
  paper's hot-head flip at a fixed time);
* :class:`ArrivalProcess` ties them together: per tick ``[t, t+Δ)`` it
  draws ``Poisson(λ(t+Δ/2)·Δ)`` arrivals (the standard per-tick
  integration of a nonhomogeneous Poisson process), places them uniformly
  inside the tick, sorts, and emits one batch per tick.

Everything is deterministic given the seed, so closed-loop and open-loop
replays of the same process see bit-identical streams (the ``at_time``
agreement test rides on this).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..data.synthetic import zipf_probs
from ..topology.graph import RecordBatch

__all__ = [
    "RateFn",
    "ConstantRate",
    "DiurnalRate",
    "FlashCrowd",
    "MarkovModulatedRate",
    "ZipfKeys",
    "FlipZipfKeys",
    "ArrivalProcess",
]


class RateFn:
    """Instantaneous offered rate λ(t) ≥ 0 in tuples/second.  Subclasses
    implement ``rate(t)``; ``a * b`` composes pointwise (modulators are
    dimensionless multipliers around 1.0 by convention)."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def __call__(self, t: float) -> float:
        return max(self.rate(float(t)), 0.0)

    def __mul__(self, other: "RateFn") -> "RateFn":
        return _ProductRate(self, other)

    __rmul__ = __mul__


class _ProductRate(RateFn):
    def __init__(self, a: RateFn, b: RateFn):
        self.a = a
        self.b = b

    def rate(self, t: float) -> float:
        return self.a(t) * self.b(t)


class ConstantRate(RateFn):
    """λ(t) = rate — homogeneous Poisson arrivals."""

    def __init__(self, rate: float):
        self.base = float(rate)

    def rate(self, t: float) -> float:
        return self.base


class DiurnalRate(RateFn):
    """Sinusoid modulation ``1 + amplitude·sin(2π(t - phase)/period)`` —
    the day/night load swing, compressed to whatever ``period`` the
    experiment runs over.  Use as a multiplier: ``ConstantRate(r) *
    DiurnalRate(amplitude=0.5, period=60.0)``."""

    def __init__(self, amplitude: float = 0.5, period: float = 86_400.0,
                 phase: float = 0.0):
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.phase = float(phase)

    def rate(self, t: float) -> float:
        return 1.0 + self.amplitude * np.sin(
            2.0 * np.pi * (t - self.phase) / self.period)


class FlashCrowd(RateFn):
    """A transient spike multiplier: 1 everywhere except ``[at, at +
    duration)`` where the rate ramps linearly to ``magnitude`` over
    ``ramp`` seconds, holds, and ramps back down over the last ``ramp``
    seconds — the retweet-storm shape."""

    def __init__(self, at: float, duration: float, magnitude: float,
                 ramp: float = 0.0):
        if magnitude < 1.0:
            raise ValueError(f"magnitude must be >= 1, got {magnitude}")
        if ramp * 2.0 > duration:
            raise ValueError("2*ramp must fit inside duration")
        self.at = float(at)
        self.duration = float(duration)
        self.magnitude = float(magnitude)
        self.ramp = float(ramp)

    def rate(self, t: float) -> float:
        dt = t - self.at
        if dt < 0.0 or dt >= self.duration:
            return 1.0
        boost = self.magnitude - 1.0
        if self.ramp > 0.0:
            if dt < self.ramp:
                return 1.0 + boost * dt / self.ramp
            if dt > self.duration - self.ramp:
                return 1.0 + boost * (self.duration - dt) / self.ramp
        return self.magnitude


class MarkovModulatedRate(RateFn):
    """MMPP-style regime switching: the rate multiplier holds one of
    ``levels`` for an exponentially-distributed dwell time (mean
    ``mean_dwell`` seconds), then jumps to a uniformly-chosen *other*
    level.  The switch path is pre-sampled lazily from ``seed``, so the
    process is deterministic and extending the horizon never perturbs the
    earlier path."""

    def __init__(self, levels: Sequence[float] = (0.5, 1.0, 2.0),
                 mean_dwell: float = 10.0, seed: int = 0):
        if len(levels) < 2:
            raise ValueError("need at least two levels to switch between")
        self.levels = [float(x) for x in levels]
        self.mean_dwell = float(mean_dwell)
        self._rng = np.random.default_rng(seed)
        self._switch_times: List[float] = [0.0]
        self._states: List[int] = [int(self._rng.integers(len(levels)))]

    def _extend_to(self, t: float) -> None:
        while self._switch_times[-1] <= t:
            self._switch_times.append(
                self._switch_times[-1]
                + float(self._rng.exponential(self.mean_dwell)))
            cur = self._states[-1]
            step = int(self._rng.integers(1, len(self.levels)))
            self._states.append((cur + step) % len(self.levels))

    def rate(self, t: float) -> float:
        self._extend_to(t)
        i = int(np.searchsorted(self._switch_times, t, side="right")) - 1
        return self.levels[self._states[i]]


class ZipfKeys:
    """Zipf(z) key popularity over ``num_keys`` interned ids, with optional
    slow hot-key *rotation* drift: every ``drift_period`` seconds the
    rank→id mapping rotates by ``drift_step`` ids, so the hot head wanders
    through the key space (the paper's time-evolving workload, continuous
    flavour)."""

    def __init__(self, num_keys: int, z: float = 1.2,
                 drift_period: Optional[float] = None, drift_step: int = 1):
        self.num_keys = int(num_keys)
        self.probs = zipf_probs(num_keys, z)
        self.drift_period = drift_period
        self.drift_step = int(drift_step)

    def sample(self, n: int, t: float, rng: np.random.Generator
               ) -> np.ndarray:
        ranks = rng.choice(self.num_keys, size=n, p=self.probs)
        if self.drift_period:
            shift = int(t / self.drift_period) * self.drift_step
            ranks = (ranks + shift) % self.num_keys
        return ranks.astype(np.int32)


class FlipZipfKeys(ZipfKeys):
    """Zipf keys whose hot head flips at ``flip_time``: from then on rank
    ``r`` maps to id ``(r + flip_head) % num_keys`` — the cold tail
    becomes the head instantly, the discrete hot-key flip the scenario
    matrix already exercises closed-loop."""

    def __init__(self, num_keys: int, z: float = 1.2,
                 flip_time: float = 0.0, flip_head: Optional[int] = None):
        super().__init__(num_keys, z)
        self.flip_time = float(flip_time)
        self.flip_head = (int(flip_head) if flip_head is not None
                          else num_keys // 2)

    def sample(self, n: int, t: float, rng: np.random.Generator
               ) -> np.ndarray:
        ranks = rng.choice(self.num_keys, size=n, p=self.probs)
        if t >= self.flip_time:
            ranks = (ranks + self.flip_head) % self.num_keys
        return ranks.astype(np.int32)


@dataclasses.dataclass
class ArrivalProcess:
    """Nonhomogeneous Poisson arrivals on a fixed tick grid.

    ``batches(t0, t1)`` yields one :class:`RecordBatch` per tick ``[t,
    t+tick)`` with ``Poisson(λ(t + tick/2)·tick)`` records timestamped
    uniformly inside the tick (sorted; empty ticks yield empty batches so
    the driver's control loop still runs on schedule).  ``payload=True``
    attaches a standard-normal value column."""

    rate_fn: RateFn
    keys: ZipfKeys
    tick: float = 0.1
    seed: int = 0
    payload: bool = False

    def batches(self, t0: float, t1: float) -> Iterator[RecordBatch]:
        if self.tick <= 0.0:
            raise ValueError(f"tick must be positive, got {self.tick}")
        rng = np.random.default_rng(self.seed)
        t = float(t0)
        while t < t1:
            lam = self.rate_fn(t + self.tick / 2.0) * self.tick
            n = int(rng.poisson(lam))
            ts = np.sort(rng.uniform(t, t + self.tick, size=n))
            ks = self.keys.sample(n, t, rng)
            vals = rng.standard_normal(n) if self.payload else None
            yield RecordBatch(ks, ts, vals)
            t += self.tick

    def offered(self, t0: float, t1: float) -> int:
        """Total records the process offers on ``[t0, t1)`` — same draws
        as ``batches`` (deterministic given the seed)."""
        return sum(len(b) for b in self.batches(t0, t1))
