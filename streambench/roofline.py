"""Peaks of the card and the operations and bytes of the kernels whose
roofline share the benchmark reports.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity) at its full 700 W: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32
outside the tensor cores (the integer and float32 work these kernels do).
A kernel's least time is the larger of its bytes over the memory rate and
its operations over the float32 rate; its share of the roofline is that
least time over the time the profiler measured.

Bytes count each input byte read once and each output byte written once,
for the data of the run: a tuple reads the candidate rows its count ``d``
needs, not the whole row; scratch the kernel keeps for itself is neither.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "route_scan_bytes",
           "route_scan_ops", "least_seconds"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: operations of ``route_scan``'s prologue per tuple: the frequency and
#: top ratio (2 divisions), the hot tests (3 compares), the ratio's clamp
#: (1), its binary exponent (1), ``wnum / 2^idx`` (1), the floor (1), the
#: clamp to [d_min, W] (2), the max with ``M`` (1)
PROLOGUE_OPS = 12


def route_scan_bytes(m: int, d: np.ndarray, workers: int, epochs: int,
                     keys_read: int, keys_written: int) -> int:
    """Bytes of one FISH ``route_scan`` launch over ``m`` tuples.

    Read: the tuples' keys and tracker values (4 B each), the candidate
    entries each tuple's chain reads (4 B each, ``d`` of them), the
    epochs' totals and maxima (8 B an epoch), the CHK memory of the
    segment's ``keys_read`` distinct keys, and per worker lane (``workers
    + 1``) the count, backlog, assigned and capacity (16 B).  Written: the
    tuples' workers (4 B), the CHK memory of the ``keys_written`` keys it
    raises, and per lane the count, backlog and assigned (12 B)."""
    lanes = workers + 1
    read = 8 * m + 4 * int(np.asarray(d).sum()) + 8 * epochs \
        + 4 * keys_read + 16 * lanes
    written = 4 * m + 4 * keys_written + 12 * lanes
    return read + written


def route_scan_ops(m: int, d: np.ndarray) -> int:
    """Operations: the prologue per tuple, then per candidate an add, a
    multiply and a compare (Eq. 2's wait and its argmin), and the
    assignment's increment per tuple."""
    return (PROLOGUE_OPS + 1) * m + 3 * int(np.asarray(d).sum())


def least_seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
