"""The benchmark's own stream generators, driven by a configuration file.

A configuration names one generator and its parameters; the same seed
gives the same keys, payload values and timestamps.  Each generator draws
every tuple's key by inverse-CDF sampling (one ``searchsorted`` over the
whole stream or phase), so an 8-million-tuple stream takes well under a
second.  The distributions are the paper's (§6.1, Table 2):

* ``zf`` — the ZF stream: ``flip_at`` of the stream draws key ``i`` with
  ``Pr[i] ∝ (i + 1)^-z``; the rest with ``Pr[i] ∝ (k - i)^-z`` for
  ``i < k = flip_head`` and ``(i - k + 2)^-z`` beyond, so the hot head
  jumps to key ``k - 1``.
* ``piecewise_zipf`` — Zipf(z) over the key universe whose rank-to-key
  permutation is redrawn at the start of each of ``phases`` equal phases
  (the Amazon-Movie and MemeTracker proxies: the hot set drifts).

Payload values are integers 1..9 (as float64), timestamps the tuple's
index over the configuration's ``arrival_rate`` (simulated seconds).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Stream", "make_stream", "seed_sequence"]


class Stream:
    """One configuration's stream: ``keys`` (int32), ``values`` (float64)
    and ``times`` (float64 seconds)."""

    __slots__ = ("keys", "values", "times")

    def __init__(self, keys: np.ndarray, values: np.ndarray,
                 times: np.ndarray):
        self.keys = keys
        self.values = values
        self.times = times

    def __len__(self) -> int:
        return int(self.keys.shape[0])


def seed_sequence(seed: int, *salt: int) -> np.random.SeedSequence:
    """A seed sequence for any whole ``seed`` (negative ones folded into
    64 bits), with ``salt`` words that separate independent draws."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *salt])


def _zipf_cdf(weights: np.ndarray) -> np.ndarray:
    cdf = np.cumsum(weights)
    return cdf / cdf[-1]


def _draw(rng: np.random.Generator, cdf: np.ndarray, n: int) -> np.ndarray:
    """``n`` indices into ``cdf``'s categories."""
    idx = np.searchsorted(cdf, rng.random(n), side="right")
    return np.minimum(idx, cdf.shape[0] - 1)


def _zf(rng, n: int, keys: int, z: float, flip_at: float,
        flip_head: int) -> np.ndarray:
    ranks = np.arange(1, keys + 1, dtype=np.float64)
    n1 = int(flip_at * n)
    k = min(flip_head, keys)
    after = np.where(ranks <= k, np.maximum(k - ranks + 1.0, 1.0),
                     np.maximum(ranks - k + 1.0, 1.0)) ** (-z)
    return np.concatenate([_draw(rng, _zipf_cdf(ranks ** (-z)), n1),
                           _draw(rng, _zipf_cdf(after), n - n1)])


def _piecewise_zipf(rng, n: int, keys: int, z: float,
                    phases: int) -> np.ndarray:
    cdf = _zipf_cdf(np.arange(1, keys + 1, dtype=np.float64) ** (-z))
    bounds = [ph * (n // phases) for ph in range(phases)] + [n]
    out = np.empty(n, dtype=np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        perm = rng.permutation(keys)  # this phase's rank -> key map
        out[lo:hi] = perm[_draw(rng, cdf, hi - lo)]
    return out


_GENERATORS = {"zf": _zf, "piecewise_zipf": _piecewise_zipf}


def make_stream(config: dict, seed: int, tuples: int = 0) -> Stream:
    """The stream of ``config`` (its ``stream`` section) for ``seed``;
    ``tuples`` > 0 cuts it (CPU tests only)."""
    spec = dict(config["stream"])
    gen = _GENERATORS[spec.pop("generator")]
    n = tuples or int(spec.pop("tuples"))
    spec.pop("tuples", None)
    rate = float(spec.pop("arrival_rate"))
    key_rng, val_rng = (np.random.default_rng(s)
                        for s in seed_sequence(seed, 1).spawn(2))
    keys = gen(key_rng, n, **spec).astype(np.int32)
    values = val_rng.integers(1, 10, n).astype(np.float64)
    times = np.arange(n, dtype=np.float64) / rate
    return Stream(keys, values, times)
