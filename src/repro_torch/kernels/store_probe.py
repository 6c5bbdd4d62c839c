"""Keyed-state probe/accumulate: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper that picks one by the tensor's device.

Replaces ``src/repro/kernels/store_probe.py::store_probe`` (the Pallas
kernel behind ``DeviceStateStore._merge``).  It folds one routed chunk
into a slot table: per slot the int32 Σvalue and Σcount of the chunk's
tokens that hit it, plus a per-token hit flag.

* **Kernel** (``csrc/store_probe.cu``): one thread per token, a binary
  search over the strictly ascending table, ``atomicAdd`` on int32 for the
  slot sums — O(N log K) instead of the TPU kernel's O(N·K) compare matrix.
  Bound by bytes (each token's key and value, plus the sums it touches);
  integer atomics keep the sums exact and order-free.
* **Plain version**: the compare-matrix form of the TPU kernel, tiled over
  tokens.  It holds for any table, so comparing the two on the main path's
  tables also checks the kernel's precondition.

For a CUDA tensor the wrapper launches the kernel (or raises); only a CPU
tensor takes the plain version.  ``LAUNCHES["store_probe"]`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["store_probe", "store_probe_plain", "LAUNCHES"]

#: kernel launches, counted where the wrapper launches
LAUNCHES = {"store_probe": 0}

_BLOCK_N = 1024  # tokens per compare-matrix tile (plain version)

_SIGS = {"store_probe": (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)}


def _check_args(table_keys, batch_keys, batch_vals) -> None:
    for name, t in (("table_keys", table_keys), ("batch_keys", batch_keys),
                    ("batch_vals", batch_vals)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"store_probe: {name} must be 1-D int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != table_keys.device:
            raise ValueError("store_probe: all tensors on one device")
    if batch_keys.shape != batch_vals.shape:
        raise ValueError("store_probe: batch_keys and batch_vals differ in "
                         "shape")


def store_probe_plain(table_keys: torch.Tensor, batch_keys: torch.Tensor,
                      batch_vals: torch.Tensor):
    """Compare-matrix form (any table; -1 marks an empty slot)."""
    k = table_keys.shape[0]
    vsum = torch.zeros(k, dtype=torch.int32, device=table_keys.device)
    csum = torch.zeros_like(vsum)
    matched = []
    live = table_keys >= 0
    for lo in range(0, batch_keys.shape[0], _BLOCK_N):
        ks = batch_keys[lo:lo + _BLOCK_N]
        vs = batch_vals[lo:lo + _BLOCK_N]
        eq = (ks[:, None] == table_keys[None, :]) & live[None, :]
        vsum += torch.where(eq, vs[:, None], 0).sum(0, dtype=torch.int32)
        csum += eq.sum(0, dtype=torch.int32)
        matched.append(eq.any(1))
    hit = (torch.cat(matched) if matched
           else torch.zeros(0, dtype=torch.bool, device=table_keys.device))
    return vsum, csum, hit


def store_probe(table_keys: torch.Tensor, batch_keys: torch.Tensor,
                batch_vals: torch.Tensor, *, validate: bool = False):
    """Probe/accumulate one chunk against a slot table.

    table_keys: (K,) int32, **strictly ascending** on the kernel path
                (``DeviceStateStore`` keeps it so).  ``validate=True``
                checks that on the device (one host sync) and raises.
    batch_keys: (N,) int32 token key ids.
    batch_vals: (N,) int32 per-token values (range-checked by the caller).
    returns:    vsum (K,) int32, csum (K,) int32, matched (N,) bool.
    """
    _check_args(table_keys, batch_keys, batch_vals)
    if table_keys.device.type == "cpu":
        return store_probe_plain(table_keys, batch_keys, batch_vals)
    if table_keys.device.type != "cuda":
        raise ValueError(f"store_probe: no kernel for device "
                         f"{table_keys.device}")
    if validate and table_keys.shape[0] > 1 and not bool(
            (table_keys[1:] > table_keys[:-1]).all()):
        raise ValueError("store_probe: the kernel needs a strictly "
                         "ascending slot table")
    table_keys = table_keys.contiguous()
    batch_keys = batch_keys.contiguous()
    batch_vals = batch_vals.contiguous()
    k, n = table_keys.shape[0], batch_keys.shape[0]
    vsum = torch.empty(k, dtype=torch.int32, device=table_keys.device)
    csum = torch.empty_like(vsum)
    matched = torch.empty(n, dtype=torch.bool, device=table_keys.device)
    lib = _build.library("store_probe", _SIGS)
    err = lib.store_probe(table_keys.data_ptr(), k, batch_keys.data_ptr(),
                          batch_vals.data_ptr(), n, vsum.data_ptr(),
                          csum.data_ptr(), matched.data_ptr(),
                          _build.stream_ptr(table_keys.device))
    _build.check(err, "store_probe")
    LAUNCHES["store_probe"] += 1
    return vsum, csum, matched
