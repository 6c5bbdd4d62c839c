"""FISH epoch match-and-count: the hand-written CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device.

Replaces ``src/repro/kernels/fish_count.py``: ``fish_count`` (K1a, the
per-slot counts of an epoch's keys against the bounded counter table, and
a per-token matched flag) and ``fish_epoch_count`` (K1b, one launch for a
whole Alg. 1 epoch: ``counts·alpha`` plus those counts, the matched flags,
each token's in-epoch key frequency and a first-occurrence flag).  Both
back :func:`repro_torch.core.fish.epoch_update` (``match_fn=`` /
``fused_fn=``), which composes the rest of the epoch (candidates, top-k,
the batched ReplaceMin) around them in :func:`compose_epoch`.
``fish_epoch_update`` is the whole epoch, that composition included, in
one launch (``epoch_update(epoch_fn=)``), for an epoch and a table that
fit one block's shared memory (:func:`check_epoch_shape`).

* **Kernels** (``csrc/fish_count.cu``): K1a/K1b one thread per token
  against the table (and, for K1b, the epoch's keys) streamed through
  shared memory; per-slot counts as int32 atomics, turned into floats by a
  K-wide second launch — exact and independent of block order.
  ``fish_epoch_update``: one block holding the epoch and the table in
  shared memory, every order a bitonic sort on one 64-bit key.
* **Plain versions**: the equality-matrix form of the reference, tiled over
  tokens; ``fish_epoch_update_plain`` is :func:`compose_epoch` over them.

For a CUDA tensor a wrapper launches its kernel (or raises); only a CPU
tensor takes the plain version.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fish_count", "fish_epoch_count", "fish_epoch_update",
           "fish_count_plain", "fish_epoch_count_plain",
           "fish_epoch_update_plain", "compose_epoch", "check_epoch_shape",
           "epoch_smem_bytes", "EPOCH_SMEM_LIMIT", "TIES", "LAUNCHES"]

#: kernel launches, counted where the wrappers launch
LAUNCHES = {"fish_count": 0, "fish_epoch_count": 0, "fish_epoch_update": 0}

#: ``fish_epoch_update``'s size limit: the shared memory one block may use
#: on Hopper, 227 KB (``csrc/fish_count.cu``)
EPOCH_SMEM_LIMIT = 232_448

#: the tie rules among equally frequent candidates: "first" (the lower
#: first token position, the fused path) and "key" (the lower key, the
#: match path)
TIES = ("first", "key")

_BLOCK_N = 1024  # tokens per equality-matrix tile (plain versions)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "fish_count": (_P, _I, _P, _I, _P, _P, _P, _P),
    "fish_epoch_count": (_P, _P, ctypes.c_float, _I, _P, _I, _P, _P, _P, _P,
                         _P, _P),
    "fish_epoch_update": (_P, _P, ctypes.c_float, _I, _P, _I, _I, _I, _P, _P,
                          _P),
    "fish_noop": (_P,),
    "fish_barrier_probe": (_I, _I, _P, _P),
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


def epoch_smem_bytes(k: int, n: int) -> int:
    """Shared memory ``fish_epoch_update``'s block needs for a table of
    ``k`` slots and an epoch of ``n`` keys: 16 N' + 8 K' + 8 K bytes, N'
    and K' the powers of two at or above N and K."""
    def pow2(x):
        return 1 << max(x - 1, 0).bit_length()
    return 16 * pow2(n) + 8 * pow2(k) + 8 * k


def check_epoch_shape(k: int, n: int) -> None:
    """Raise ``ValueError`` unless ``fish_epoch_update``'s one block holds
    a table of ``k`` slots and an epoch of ``n`` keys: N <= 8,192 at any K,
    K <= 4,480 at N = 8,192 (exactly the limit), K <= 10,624 at N = 1,000.
    There is no fallback: a larger epoch goes through ``epoch_update``'s
    ``fused_fn=`` / ``match_fn=``, or is split."""
    need = epoch_smem_bytes(k, n)
    if need > EPOCH_SMEM_LIMIT:
        raise ValueError(
            f"fish_epoch_update: an epoch of N = {n} keys against K = {k} "
            f"slots needs {need:,} B of shared memory, past the one-block "
            f"limit of {EPOCH_SMEM_LIMIT:,} B (N <= 8,192; K <= 4,480 at "
            "N = 8,192); use epoch_update's fused_fn= or match_fn=")


def _top(scores: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` leaves the tie order open)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def compose_epoch(table_keys: torch.Tensor, table_counts: torch.Tensor,
                  batch_keys: torch.Tensor, *, alpha: float, max_new: int,
                  match_fn=None, fused_fn=None):
    """One epoch of Alg. 1 with epoch-batched ReplaceMin, around a
    match-count function: ``fused_fn`` (K1b's signature: decay, match,
    candidate histogram) or else ``match_fn`` (K1a's).  Returns the new
    ``(keys (K,) int32, counts (K,) float32)``.

    Equally frequent candidates go to the lower first token position on
    the fused path and to the lower key on the match path, as the
    reference's two paths break them.  ``max_new`` is clipped to
    ``min(max_new, K, N)``: a partial final epoch may carry fewer keys, and
    more than K inserts can never land."""
    dev = table_keys.device
    n = batch_keys.shape[0]
    max_new = min(max_new, int(table_keys.shape[0]), n)

    if fused_fn is not None:
        counts, matched, cand_count, is_first = fused_fn(
            table_keys, table_counts, batch_keys, alpha=alpha)
        scores = torch.where(is_first & ~matched, cand_count, 0.0)
        top_len, top_idx = _top(scores, max_new)
        top_key = batch_keys[top_idx]
    else:
        a = torch.tensor(alpha, dtype=torch.float32, device=dev)
        counts_delta, matched = match_fn(table_keys, batch_keys)
        counts = table_counts * a + counts_delta  # TimeDecayingUpdate

        # candidate new keys: sort the unmatched keys so equal ids are
        # adjacent, then count each run
        cand_keys = torch.where(matched, -1, batch_keys)
        sorted_keys = torch.sort(cand_keys).values
        new_run = torch.ones(n, dtype=torch.bool, device=dev)
        new_run[1:] = sorted_keys[1:] != sorted_keys[:-1]
        run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
        run_len = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, run_id, torch.ones(n, dtype=torch.float32, device=dev))
        run_key = torch.full((n,), torch.iinfo(torch.int32).min,
                             dtype=torch.int32, device=dev
                             ).scatter_reduce_(0, run_id, sorted_keys, "amax")
        run_len = torch.where(run_key >= 0, run_len, 0.0)  # drop the -1 run
        top_len, top_idx = _top(run_len, max_new)
        top_key = run_key[top_idx]

    # batched ReplaceMin: the bottom max_new slots (ascending by counter,
    # empty slots as free minima) take the top max_new candidates
    empty = table_keys < 0
    eff = torch.where(empty, 0.0, counts)
    bottom = torch.sort(eff, stable=True).indices[:max_new]
    do = top_len > 0.0
    table_keys = table_keys.clone()
    table_keys[bottom] = torch.where(do, top_key, table_keys[bottom])
    counts = counts.clone()
    counts[bottom] = torch.where(do, eff[bottom] + top_len, counts[bottom])
    return table_keys, counts


def _check_ties(ties) -> None:
    if ties not in TIES:
        raise ValueError(f"fish_epoch_update: ties must be one of {TIES}, "
                         f"got {ties!r}")


def fish_epoch_update_plain(table_keys: torch.Tensor,
                            table_counts: torch.Tensor,
                            batch_keys: torch.Tensor, *, alpha: float,
                            max_new: int, ties: str = "first"):
    """The epoch as the port composes it around the plain K1b (``ties=
    "first"``) or the plain K1a (``"key"``); any size."""
    _check_ties(ties)
    return compose_epoch(
        table_keys, table_counts, batch_keys, alpha=alpha, max_new=max_new,
        fused_fn=fish_epoch_count_plain if ties == "first" else None,
        match_fn=fish_count_plain)


def fish_epoch_update(table_keys: torch.Tensor, table_counts: torch.Tensor,
                      batch_keys: torch.Tensor, *, alpha: float, max_new: int,
                      ties: str = "first"):
    """One whole Alg. 1 epoch (decay, match, candidate count, top-k,
    batched ReplaceMin) in one launch of one thread block.

    table_keys:   (K,) int32, -1 marks an empty slot.
    table_counts: (K,) float32 decayed counters (>= 0).
    batch_keys:   (N,) int32 key ids (>= 0); N and K within
                  :func:`check_epoch_shape`'s limit.
    ties:         "first" or "key", the tie rule of :func:`compose_epoch`'s
                  fused or match path.
    returns:      the new keys (K,) int32 and counts (K,) float32, bit for
                  bit :func:`fish_epoch_update_plain` under ``ties``.
    Past the size limit it raises ``ValueError`` on either device.
    """
    _check("fish_epoch_update", table_keys, batch_keys, table_counts)
    _check_ties(ties)
    k, n = table_keys.shape[0], batch_keys.shape[0]
    check_epoch_shape(k, n)
    if table_keys.device.type == "cpu":
        return fish_epoch_update_plain(table_keys, table_counts, batch_keys,
                                       alpha=alpha, max_new=max_new,
                                       ties=ties)
    table_keys = table_keys.contiguous()
    table_counts = table_counts.contiguous()
    batch_keys = batch_keys.contiguous()
    dev = table_keys.device
    keys_out = torch.empty(k, dtype=torch.int32, device=dev)
    counts_out = torch.empty(k, dtype=torch.float32, device=dev)
    lib = _build.library("fish_count", _SIGS)
    err = lib.fish_epoch_update(
        table_keys.data_ptr(), table_counts.data_ptr(), float(alpha), k,
        batch_keys.data_ptr(), n, min(max_new, k, n),
        int(ties == "key"), keys_out.data_ptr(), counts_out.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "fish_epoch_update")
    LAUNCHES["fish_epoch_update"] += 1
    return keys_out, counts_out
