"""FISH epoch match-and-count: the hand-written CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device.

Replaces ``src/repro/kernels/fish_count.py``: ``fish_count`` (K1a, the
per-slot counts of an epoch's keys against the bounded counter table, and
a per-token matched flag) and ``fish_epoch_count`` (K1b, one launch for a
whole Alg. 1 epoch: ``counts·alpha`` plus those counts, the matched flags,
each token's in-epoch key frequency and a first-occurrence flag).  Both
back :func:`repro_torch.core.fish.epoch_update` (``match_fn=`` /
``fused_fn=``).

* **Kernels** (``csrc/fish_count.cu``): one thread per token against the
  table (and, for K1b, the epoch's keys) streamed through shared memory;
  per-slot counts as int32 atomics, turned into floats by a K-wide second
  launch — exact and independent of block order.
* **Plain versions**: the equality-matrix form of the reference, tiled over
  tokens.

For a CUDA tensor a wrapper launches its kernel (or raises); only a CPU
tensor takes the plain version.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fish_count", "fish_epoch_count", "fish_count_plain",
           "fish_epoch_count_plain", "LAUNCHES"]

#: kernel launches, counted where the wrappers launch
LAUNCHES = {"fish_count": 0, "fish_epoch_count": 0}

_BLOCK_N = 1024  # tokens per equality-matrix tile (plain versions)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "fish_count": (_P, _I, _P, _I, _P, _P, _P, _P),
    "fish_epoch_count": (_P, _P, ctypes.c_float, _I, _P, _I, _P, _P, _P, _P,
                         _P, _P),
}


def _check(name, table_keys, batch_keys, table_counts=None) -> None:
    for arg, t in (("table_keys", table_keys), ("batch_keys", batch_keys)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: {arg} must be 1-D int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if batch_keys.device != table_keys.device:
        raise ValueError(f"{name}: all tensors on one device")
    if table_counts is not None and (
            table_counts.dtype != torch.float32
            or table_counts.shape != table_keys.shape
            or table_counts.device != table_keys.device):
        raise TypeError(f"{name}: table_counts must be float32 shaped like "
                        "table_keys, on its device")
    if table_keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {table_keys.device}")


def _tiles(n):
    return range(0, n, _BLOCK_N)


def fish_count_plain(table_keys: torch.Tensor, batch_keys: torch.Tensor):
    """Equality-matrix form: counts (K,) f32, matched (N,) bool."""
    live = table_keys >= 0
    delta = torch.zeros(table_keys.shape[0], dtype=torch.int64,
                        device=table_keys.device)
    matched = torch.zeros(batch_keys.shape[0], dtype=torch.bool,
                          device=table_keys.device)
    for lo in _tiles(batch_keys.shape[0]):
        eq = (batch_keys[lo:lo + _BLOCK_N, None] == table_keys[None, :]) \
            & live[None, :]
        delta += eq.sum(0)
        matched[lo:lo + _BLOCK_N] = eq.any(1)
    return delta.to(torch.float32), matched


def fish_epoch_count_plain(table_keys: torch.Tensor,
                           table_counts: torch.Tensor,
                           batch_keys: torch.Tensor, *, alpha: float):
    """Decay + match-count + candidate histogram, as equality matrices."""
    delta, matched = fish_count_plain(table_keys, batch_keys)
    a = torch.tensor(alpha, dtype=torch.float32, device=table_keys.device)
    new_counts = table_counts * a + delta
    n = batch_keys.shape[0]
    cand = torch.empty(n, dtype=torch.float32, device=table_keys.device)
    first = torch.empty(n, dtype=torch.bool, device=table_keys.device)
    col = torch.arange(n, device=table_keys.device)
    for lo in _tiles(n):
        eq = batch_keys[lo:lo + _BLOCK_N, None] == batch_keys[None, :]
        cand[lo:lo + _BLOCK_N] = eq.sum(1).to(torch.float32)
        earlier = eq & (col[None, :] < col[lo:lo + _BLOCK_N, None])
        first[lo:lo + _BLOCK_N] = ~earlier.any(1)
    return new_counts, matched, cand, first


def fish_count(table_keys: torch.Tensor, batch_keys: torch.Tensor):
    """Epoch match-and-count (K1a).

    table_keys: (K,) int32, -1 marks an empty slot.
    batch_keys: (N,) int32 key ids (>= 0).
    returns:    counts (K,) float32, matched (N,) bool.
    """
    _check("fish_count", table_keys, batch_keys)
    if table_keys.device.type == "cpu":
        return fish_count_plain(table_keys, batch_keys)
    table_keys = table_keys.contiguous()
    batch_keys = batch_keys.contiguous()
    k, n = table_keys.shape[0], batch_keys.shape[0]
    dev = table_keys.device
    delta = torch.empty(k, dtype=torch.int32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _build.library("fish_count", _SIGS)
    err = lib.fish_count(table_keys.data_ptr(), k, batch_keys.data_ptr(), n,
                         delta.data_ptr(), counts.data_ptr(),
                         matched.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "fish_count")
    LAUNCHES["fish_count"] += 1
    return counts, matched


def fish_epoch_count(table_keys: torch.Tensor, table_counts: torch.Tensor,
                     batch_keys: torch.Tensor, *, alpha: float):
    """One fused pass over an epoch (K1b).

    table_keys:   (K,) int32, -1 marks an empty slot.
    table_counts: (K,) float32 decayed counters.
    batch_keys:   (N,) int32 key ids (>= 0).
    returns:      new_counts (K,) f32 = fl(counts·alpha) + epoch counts,
                  matched (N,) bool, cand_count (N,) f32 (each token's
                  in-epoch key frequency), is_first (N,) bool.
    """
    _check("fish_epoch_count", table_keys, batch_keys, table_counts)
    if table_keys.device.type == "cpu":
        return fish_epoch_count_plain(table_keys, table_counts, batch_keys,
                                      alpha=alpha)
    table_keys = table_keys.contiguous()
    table_counts = table_counts.contiguous()
    batch_keys = batch_keys.contiguous()
    k, n = table_keys.shape[0], batch_keys.shape[0]
    dev = table_keys.device
    delta = torch.empty(k, dtype=torch.int32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    cand = torch.empty(n, dtype=torch.float32, device=dev)
    first = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _build.library("fish_count", _SIGS)
    err = lib.fish_epoch_count(
        table_keys.data_ptr(), table_counts.data_ptr(), float(alpha), k,
        batch_keys.data_ptr(), n, delta.data_ptr(), counts.data_ptr(),
        matched.data_ptr(), cand.data_ptr(), first.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "fish_epoch_count")
    LAUNCHES["fish_epoch_count"] += 1
    return counts, matched, cand, first
