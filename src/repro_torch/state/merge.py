"""Merging split-key partial aggregates + the stream oracle.

PKG/DC/WC/FISH split hot keys across several workers, so a key's window
aggregate exists as several partials that a downstream merge stage must
combine (the paper's stated cost of key splitting); SG splits *every* key.
:func:`merge_partials` is that combine: vectorised segment-reduce over all
partial entries of a window, then per-``agg`` finalisation (top-k cut for
``topk``).

:func:`direct_aggregate` computes the same result straight from the input
key stream — the routing-free oracle: merged results must equal it for
every scheme, engine, churn pattern and migration policy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .window import WindowOp, WindowPartial, tuple_values

__all__ = ["merge_partials", "direct_aggregate", "topk_cut"]


def topk_cut(keys: np.ndarray, counts: np.ndarray, k: int) -> List[List[int]]:
    """The k heaviest keys, ties broken toward the smaller key id
    (deterministic): ``[[key, count], ...]`` sorted heaviest-first."""
    order = np.lexsort((keys, -counts))[:k]
    return [[int(keys[i]), int(counts[i])] for i in order.tolist()]


def _finalize(op: WindowOp, acc: Dict[int, Dict[int, np.ndarray]]) -> Dict:
    out: Dict[int, object] = {}
    for w in sorted(acc):
        ks, vs = acc[w]
        if op.agg == "topk":
            out[int(w)] = topk_cut(ks, vs, op.k)
        else:
            out[int(w)] = {int(k): int(v)
                           for k, v in zip(ks.tolist(), vs.tolist())}
    return out


def merge_partials(partials: Sequence[WindowPartial], op: WindowOp) -> Dict:
    """Combine per-worker partials into final per-window results:
    ``{window_start: {key: value}}`` (count/sum) or
    ``{window_start: [[key, count], ...]}`` (topk)."""
    by_window: Dict[int, List[WindowPartial]] = {}
    for p in partials:
        by_window.setdefault(int(p.window), []).append(p)
    acc: Dict[int, Dict[int, np.ndarray]] = {}
    for w, ps in by_window.items():
        ks = np.concatenate([p.keys for p in ps])
        vs = np.concatenate([p.values for p in ps])
        uniq, inv = np.unique(ks, return_inverse=True)
        tot = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(tot, inv, vs)
        acc[w] = (uniq, tot)
    return _finalize(op, acc)


def direct_aggregate(keys, op: WindowOp, values=None) -> Dict:
    """The oracle: window results computed directly from the key stream
    (plus the payload ``values`` column for ``value="payload"`` operators),
    bypassing routing, state stores, churn and migration entirely."""
    keys = np.asarray(keys).astype(np.int64, copy=False)
    values = tuple_values(op, keys, payload=values)
    n = keys.shape[0]
    acc: Dict[int, Dict[int, np.ndarray]] = {}
    for start in range(0, n, op.stride):
        lo, hi = start, min(start + op.size, n)
        uniq, inv = np.unique(keys[lo:hi], return_inverse=True)
        tot = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(tot, inv, values[lo:hi])
        acc[start] = (uniq, tot)
    return _finalize(op, acc)
