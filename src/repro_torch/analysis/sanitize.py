"""Differential sanitizer: the dynamic twin of the determinism rules.

A determinism bug is, operationally, two same-seed runs whose reports
differ.  Protocol (DESIGN.md §15):

1. run a session factory **twice**, same seed, each run under
   :func:`sanitized` — ``np.seterr(all="raise")`` so silent overflow /
   invalid ops become exceptions, and the fused runner's finite-value
   check, so a NaN or Inf in a value the runner reads back from the
   device raises ``FloatingPointError`` where it crosses to the host;
2. diff the two :class:`~repro_torch.topology.engine.TopologyReport`\\ s
   **field-by-field through their dict forms**, floats compared by bit
   pattern (``struct.pack``) — not ``==``, which would wave through
   same-printed-differently values and choke on NaN;
3. any divergence is a list of ``path: a != b`` strings — empty means the
   run is bit-deterministic.

The finite-value check reads only what the runner already brings to the
host: ``run_segment``'s per-worker clocks, finish times and FISH's
estimator state, its only float readbacks (the pane flush and
``host_sync`` read back integer sums and indices).  It adds no sync and
no launch, and when it is off it costs one flag test a segment.

The module is import-light (stdlib only at module level); numpy and the
runner load inside :func:`sanitized`.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Any, Callable, List, Tuple

__all__ = ["sanitized", "diff_values", "diff_reports", "double_run"]


@contextlib.contextmanager
def sanitized():
    """Strict-numerics context: numpy floating-point faults raise, and the
    fused runner raises ``FloatingPointError`` on a NaN or Inf in a value
    it reads back from the device.  Both settings are restored on exit
    (contexts nest)."""
    import numpy as np

    from ..kernels import feed_fused

    saved_np = np.seterr(all="raise")
    feed_fused.FINITE_CHECK["depth"] += 1
    try:
        yield
    finally:
        feed_fused.FINITE_CHECK["depth"] -= 1
        np.seterr(**saved_np)


def _normalize(v: Any) -> Any:
    """Fold numpy scalars to Python scalars so 3 == np.int64(3) compares
    by value, while arrays stay arrays (compared elementwise below)."""
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "shape", None) == ():
        return v.item()
    return v


def _float_bits(x: float) -> bytes:
    return struct.pack("<d", x)


def diff_values(a: Any, b: Any, path: str = "report") -> List[str]:
    """Recursive bit-exact diff of two report-shaped values.  Returns
    human-readable divergence strings (empty list = identical).

    dicts diff by key set then per key; lists/tuples by length then per
    index; floats by IEEE-754 bit pattern (NaN == NaN, 0.0 != -0.0);
    numpy arrays by shape, dtype, and exact element equality.
    """
    a, b = _normalize(a), _normalize(b)
    if isinstance(a, dict) and isinstance(b, dict):
        out: List[str] = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a:
                out.append(f"{path}.{k}: only in second run")
            elif k not in b:
                out.append(f"{path}.{k}: only in first run")
            else:
                out.extend(diff_values(a[k], b[k], f"{path}.{k}"))
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out.extend(diff_values(x, y, f"{path}[{i}]"))
        return out
    # numpy arrays (anything with shape + dtype): exact comparison
    if getattr(a, "shape", None) is not None \
            or getattr(b, "shape", None) is not None:
        import numpy as np
        aa, bb = np.asarray(a), np.asarray(b)
        if aa.shape != bb.shape:
            return [f"{path}: shape {aa.shape} != {bb.shape}"]
        if aa.dtype != bb.dtype:
            return [f"{path}: dtype {aa.dtype} != {bb.dtype}"]
        if not np.array_equal(aa, bb, equal_nan=True):
            n = int((aa != bb).sum())
            return [f"{path}: arrays differ at {n} element(s)"]
        return []
    if isinstance(a, float) and isinstance(b, float):
        if _float_bits(a) != _float_bits(b):
            return [f"{path}: {a!r} != {b!r} (bitwise)"]
        return []
    if type(a) is not type(b):
        return [f"{path}: type {type(a).__name__} != {type(b).__name__}"]
    if a != b:
        return [f"{path}: {a!r} != {b!r}"]
    return []


def diff_reports(r1: Any, r2: Any) -> List[str]:
    """Field-by-field bit diff of two ``TopologyReport``-likes (anything
    with ``to_dict``; plain dicts pass through)."""
    d1 = r1.to_dict() if hasattr(r1, "to_dict") else r1
    d2 = r2.to_dict() if hasattr(r2, "to_dict") else r2
    return diff_values(d1, d2)


def double_run(factory: Callable[[], Any]) -> Tuple[Any, Any, List[str]]:
    """Run ``factory`` twice under :func:`sanitized` and diff the reports.

    ``factory`` must build *everything* (engine, topology, source) fresh on
    each call — shared state between the two runs would mask exactly the
    bugs this exists to catch.  Returns ``(report1, report2, divergences)``.
    """
    with sanitized():
        r1 = factory()
    with sanitized():
        r2 = factory()
    return r1, r2, diff_reports(r1, r2)
