"""Time-evolving stream dataset generators (paper Table 2 / §6.1).

* :func:`zipf_time_evolving` — the paper's ZF dataset, generated exactly per
  §6.1: first ``0.8·N`` tuples draw key ``i`` with ``Pr[i] ∝ i^-z``; the last
  ``0.2·N`` tuples draw with ``Pr[i] ∝ (k - i + 1)^-z`` (k = 10^4), i.e. the
  hot head jumps to the other end of the key space — a hard hot-key flip.
* :func:`piecewise_zipf` — a generalised generator with ``phases`` hot-set
  rotations; used as the proxy for the MemeTracker / Amazon-Movie real-world
  datasets (catchwords drift across time), with tuple/key cardinalities scaled
  from Table 2 (noted in DESIGN.md §7).
* :func:`token_stream` — keyed *document* stream for the data-pipeline
  integration (keys follow piecewise zipf; payload is a token array).
* :func:`record_batches` — the token stream re-columnated as session-ready
  :class:`~repro_torch.topology.RecordBatch` chunks: keys + a real
  float64 payload column + uniform-grid timestamps, so the Table-2 dataset
  proxies replay end to end through ``Engine.open(...).feed``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "zipf_probs",
    "zipf_time_evolving",
    "piecewise_zipf",
    "token_stream",
    "record_batches",
    "intern_keys",
]


def intern_keys(keys: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Map arbitrary hashable keys to contiguous int32 ids.

    Returns ``(ids, vocab)`` with ``vocab[ids[i]] == keys[i]``.  The batched
    grouping engine routes on interned ids so the per-tuple hot path never
    hashes Python objects; generators below emit int32 directly.
    """
    vocab, ids = np.unique(np.asarray(keys), return_inverse=True)
    return ids.astype(np.int32), vocab


def zipf_probs(num_keys: int, z: float) -> np.ndarray:
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    p = ranks ** (-z)
    return p / p.sum()


def zipf_time_evolving(
    num_tuples: int,
    num_keys: int = 100_000,
    z: float = 1.2,
    flip_at: float = 0.8,
    flip_head: int = 10_000,
    seed: int = 0,
) -> np.ndarray:
    """Paper §6.1 ZF generator.  Returns interned int32 key ids in
    [0, num_keys) — contiguous ids keep the batched engine hash-free."""
    rng = np.random.default_rng(seed)
    n1 = int(flip_at * num_tuples)
    n2 = num_tuples - n1
    p1 = zipf_probs(num_keys, z)
    # Pr[i] ∝ (k - i + 1)^-z for i in [1, k]; keys beyond k keep tail mass
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    k = min(flip_head, num_keys)
    head = np.maximum(k - ranks + 1.0, 1.0) ** (-z)
    tail = np.maximum(ranks - k + 1.0, 1.0) ** (-z)
    p2 = np.where(ranks <= k, head, tail)
    p2 = p2 / p2.sum()
    part1 = rng.choice(num_keys, size=n1, p=p1)
    part2 = rng.choice(num_keys, size=n2, p=p2)
    return np.concatenate([part1, part2]).astype(np.int32)


def _piecewise_key_chunks(
    rng: np.random.Generator,
    num_tuples: int,
    num_keys: int,
    z: float,
    phases: int,
    chunk: int = 4096,
) -> Iterator[np.ndarray]:
    """Lazy piecewise-Zipf key chunks: the hot set rotates (rank->key
    permutation reshuffles) every ``num_tuples/phases`` tuples.  Shared by
    :func:`piecewise_zipf` (which concatenates) and :func:`token_stream`
    (which streams — callers routinely pass ``num_docs=10**9`` as
    "infinite", so nothing may be materialised upfront).

    Exactly ``phases`` rotations: the last phase absorbs the remainder when
    ``phases`` does not divide ``num_tuples``."""
    p = zipf_probs(num_keys, z)
    per = num_tuples // phases
    starts = [ph * per for ph in range(phases)] + [num_tuples]
    perm = np.arange(num_keys)
    for ph in range(phases):
        n_phase = starts[ph + 1] - starts[ph]
        if n_phase <= 0:
            continue
        rng.shuffle(perm)  # new rank->key mapping = new hot set
        done = 0
        while done < n_phase:
            n = min(chunk, n_phase - done)
            yield perm[rng.choice(num_keys, size=n, p=p)]
            done += n


def piecewise_zipf(
    num_tuples: int,
    num_keys: int,
    z: float = 1.2,
    phases: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """Hot set rotates every num_tuples/phases tuples (real-dataset proxy).
    Returns interned int32 key ids."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        list(_piecewise_key_chunks(rng, num_tuples, num_keys, z, phases))
    ).astype(np.int32)


# Table 2 cardinality-matched proxies (tuples scaled down 50x for CI speed;
# scale=1.0 reproduces the paper's cardinalities).
def memetracker_proxy(scale: float = 0.02, seed: int = 1) -> np.ndarray:
    return piecewise_zipf(int(49_210_000 * scale), int(390_000 * max(scale, 0.02)),
                          z=1.1, phases=8, seed=seed)


def amazon_movie_proxy(scale: float = 0.02, seed: int = 2) -> np.ndarray:
    return piecewise_zipf(int(7_910_000 * scale), int(250_000 * max(scale, 0.02)),
                          z=1.2, phases=6, seed=seed)


def token_stream(
    num_docs: int,
    num_keys: int,
    doc_len: int,
    vocab_size: int,
    z: float = 1.2,
    phases: int = 4,
    seed: int = 0,
    token_z: float = 1.3,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (doc_key, tokens) pairs with a time-evolving key distribution.

    Token payloads are zipf-distributed with a key-dependent rotation, so a
    language model has learnable (unigram + doc-conditional) structure.

    Keys stream lazily from :func:`_piecewise_key_chunks` (same phase
    structure as :func:`piecewise_zipf`).  Callers routinely pass
    ``num_docs=10**9`` as "infinite"; materialising that key array upfront
    cost ~4 GB and minutes of rng.choice before the first doc was yielded.
    """
    rng = np.random.default_rng(seed)
    p_tok = zipf_probs(vocab_size, token_z)
    for keys in _piecewise_key_chunks(rng, num_docs, num_keys, z, phases):
        for k in keys.tolist():
            draws = rng.choice(vocab_size, size=doc_len, p=p_tok)
            toks = (draws + (k * 7)) % vocab_size  # doc-conditional shift
            yield int(k), toks.astype(np.int32)


def record_batches(
    num_docs: int,
    num_keys: int,
    doc_len: int,
    vocab_size: int,
    batch: int = 1_024,
    arrival_rate: float = 10_000.0,
    z: float = 1.2,
    phases: int = 4,
    seed: int = 0,
    token_z: float = 1.3,
):
    """Replay :func:`token_stream` as session-ready record batches.

    Each document becomes one record: key = the doc key, value = the doc's
    token sum (a real — and integral, so ``sum`` aggregation is exact —
    float64 payload), timestamp = its position on the uniform
    ``arrival_rate`` grid.  Yields :class:`~repro_torch.topology.RecordBatch`
    chunks of ``batch`` records (last one short), lazily — nothing is
    materialised upfront, matching :func:`token_stream`'s contract.
    """
    from ..topology.graph import RecordBatch

    dt = 1.0 / arrival_rate
    ks: list = []
    vs: list = []
    base = 0
    for k, toks in token_stream(num_docs, num_keys, doc_len, vocab_size,
                                z=z, phases=phases, seed=seed,
                                token_z=token_z):
        ks.append(k)
        vs.append(float(int(toks.sum())))
        if len(ks) == batch:
            n = len(ks)
            yield RecordBatch(np.asarray(ks, dtype=np.int32),
                              (base + np.arange(n, dtype=np.float64)) * dt,
                              np.asarray(vs))
            base += n
            ks, vs = [], []
    if ks:
        n = len(ks)
        yield RecordBatch(np.asarray(ks, dtype=np.int32),
                          (base + np.arange(n, dtype=np.float64)) * dt,
                          np.asarray(vs))
