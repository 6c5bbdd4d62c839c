"""FISH-grouped streaming data pipeline: the port's copy of the JAX
package's ``data/pipeline.py`` (host NumPy, over the port's groupers).

Keyed documents stream in; a pluggable grouping scheme (any of
``repro_torch.core.baselines``, FISH by default) assigns each document to a
data-parallel *host shard*; each shard packs tokens into fixed (B_local, S)
batches.  This is the paper's DAG (source -> grouping -> worker) with the
worker = a training host's input queue:

* hot document keys are spread over several hosts (CHK) so no host's input
  queue backs up (latency = step-time jitter at the training level);
* per-host *state* (e.g. dedup tables / tokenizer caches keyed by doc key)
  is replicated only where a key was actually routed — the paper's memory
  metric, exposed via ``memory_overhead()``;
* straggler mitigation: the Alg. 3 estimator routes fewer documents to slow
  hosts (heterogeneous ``P_w``), and :meth:`report_host_time` feeds measured
  step times back as capacity samples;
* elastic scaling: host join/leave remaps via consistent hashing (§5).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.baselines import Grouper
from ..core.fish import FishParams

__all__ = ["StreamingPipeline"]


class StreamingPipeline:
    """Route keyed documents to host shards and pack token batches."""

    def __init__(
        self,
        num_hosts: int,
        seq_len: int,
        batch_per_host: int,
        grouping: Union[str, "SchemeConfig"] = "fish",
        fish_params: Optional[FishParams] = None,
        host_capacities: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        from ..topology.configs import FishConfig, SchemeConfig, config_for

        self.num_hosts = num_hosts
        self.seq_len = seq_len
        self.batch_per_host = batch_per_host
        # grouping: a typed SchemeConfig or a scheme name
        if not isinstance(grouping, SchemeConfig):
            grouping = config_for(grouping)
        if isinstance(grouping, FishConfig) and fish_params is not None:
            grouping = FishConfig.from_params(
                fish_params, interval=grouping.interval,
                virtual_nodes=grouping.virtual_nodes,
                use_consistent_hash=grouping.use_consistent_hash)
        self.grouper: Grouper = grouping.build(num_hosts,
                                               capacities=host_capacities)
        self._buffers: Dict[int, deque] = {h: deque() for h in range(num_hosts)}
        self._clock = 0.0
        self._docs_routed = np.zeros(num_hosts, dtype=np.int64)
        self._rng = np.random.default_rng(seed)

    # -- ingestion ---------------------------------------------------------------
    def ingest(self, doc_key, tokens: np.ndarray) -> int:
        """Route one document; returns the host it went to."""
        host = self.grouper.assign(doc_key, self._clock)
        self._clock += 1e-4
        buf = self._buffers.setdefault(host, deque())
        buf.extend(tokens.tolist())
        self._docs_routed[host] += 1
        return host

    def ingest_batch(self, doc_keys: Sequence,
                     token_arrays: Sequence[np.ndarray]) -> np.ndarray:
        """Route a whole chunk of documents with one ``assign_batch`` call.

        ``doc_keys`` must be interned integer ids (see
        :func:`repro_torch.data.synthetic.intern_keys`); returns the host id per
        document.  This is the data-pipeline face of the batched grouping
        engine — no per-document Python hashing or routing.
        """
        keys = np.asarray(doc_keys)
        hosts = self.grouper.assign_batch(keys, self._clock, 1e-4)
        self._clock += 1e-4 * keys.shape[0]
        for h, toks in zip(hosts.tolist(), token_arrays):
            self._buffers.setdefault(h, deque()).extend(toks.tolist())
        counts = np.bincount(hosts, minlength=self._docs_routed.shape[0])
        if counts.shape[0] > self._docs_routed.shape[0]:
            self._docs_routed = np.concatenate(
                [self._docs_routed,
                 np.zeros(counts.shape[0] - self._docs_routed.shape[0],
                          dtype=np.int64)]
            )
        self._docs_routed[: counts.shape[0]] += counts
        return hosts

    def ingest_stream(self, stream: Iterator[Tuple[int, np.ndarray]],
                      max_docs: Optional[int] = None, batch: int = 1024) -> None:
        """Drain ``stream`` through :meth:`ingest_batch` in chunks."""
        pending_k: List[int] = []
        pending_t: List[np.ndarray] = []
        for i, (key, tokens) in enumerate(stream):
            if max_docs is not None and i >= max_docs:
                break
            pending_k.append(key)
            pending_t.append(tokens)
            if len(pending_k) >= batch:
                self.ingest_batch(np.asarray(pending_k), pending_t)
                pending_k, pending_t = [], []
        if pending_k:
            self.ingest_batch(np.asarray(pending_k), pending_t)

    # -- batching ----------------------------------------------------------------
    def host_ready(self, host: int) -> bool:
        need = self.seq_len * self.batch_per_host + self.batch_per_host
        return len(self._buffers.get(host, ())) >= need

    def ready(self) -> bool:
        return all(self.host_ready(h) for h in self._active_hosts())

    def _active_hosts(self) -> List[int]:
        return sorted(self._buffers)

    def next_host_batch(self, host: int) -> Optional[Dict[str, np.ndarray]]:
        """(B_local, S) tokens + next-token labels, or None if not ready."""
        if not self.host_ready(host):
            return None
        buf = self._buffers[host]
        n = self.batch_per_host * (self.seq_len + 1)
        flat = np.array([buf.popleft() for _ in range(n)], dtype=np.int32)
        flat = flat.reshape(self.batch_per_host, self.seq_len + 1)
        return {"tokens": flat[:, :-1], "labels": flat[:, 1:]}

    def next_global_batch(self, steal: bool = True
                          ) -> Optional[Dict[str, np.ndarray]]:
        """Assemble one global batch; with ``steal`` (default) starved hosts
        borrow tokens from the longest backlog (work stealing — the batch-
        assembly form of straggler mitigation).  Stolen tokens are a
        *contiguous run from the donor's head*, so both the donor's and the
        recipient's token streams stay in ingestion order (``pop()`` from
        the tail would hand the recipient a reversed slice of the donor's
        newest tokens)."""
        hosts = self._active_hosts()
        if steal:
            need = self.seq_len * self.batch_per_host + self.batch_per_host
            for h in hosts:
                while not self.host_ready(h):
                    donor = max(hosts, key=lambda x: len(self._buffers[x]))
                    dbuf = self._buffers[donor]
                    deficit = need - len(self._buffers[h])
                    if donor == h or len(dbuf) <= need:
                        return None  # nothing to steal anywhere
                    take = min(deficit, len(dbuf) - need)
                    if take <= 0:
                        return None
                    self._buffers[h].extend(
                        dbuf.popleft() for _ in range(take))
        parts = []
        for h in hosts:
            p = self.next_host_batch(h)
            if p is None:
                return None
            parts.append(p)
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }

    # -- runtime feedback / elasticity --------------------------------------------
    def report_host_time(self, host: int, seconds_per_doc: float) -> None:
        """Measured host speed -> Alg. 3 capacity sample (straggler feedback)."""
        self.grouper.record_capacity_sample(host, seconds_per_doc)

    def backlog(self) -> np.ndarray:
        return np.array([len(self._buffers.get(h, ()))
                         for h in self._active_hosts()])

    def memory_overhead(self) -> int:
        return self.grouper.memory_overhead()

    def rescale(self, hosts: Sequence[int]) -> None:
        """Elastic membership change (consistent hashing remap, §5).

        A removed host's backlog is *redistributed*, not stranded: its
        buffered tokens move as one in-order run to a surviving host chosen
        by the grouper (ring route for key-affine schemes; least-loaded for
        SG), and the dead buffer is deleted — otherwise ``_active_hosts``
        would keep the dead host and ``ready()``/``next_global_batch()``
        would wait forever on a queue nothing drains.
        """
        hosts = sorted(int(h) for h in hosts)
        live = set(hosts)
        self.grouper.on_membership_change(hosts)
        for h in hosts:
            self._buffers.setdefault(h, deque())
        for h in list(self._buffers):
            if h in live:
                continue
            buf = self._buffers.pop(h)
            if buf:
                target = self.grouper.probe_route(("rescale", h))
                if target is None or target not in live:
                    target = min(hosts,
                                 key=lambda x: len(self._buffers[x]))
                self._buffers[target].extend(buf)
        self.num_hosts = len(hosts)
        grow = max(hosts) + 1 - self._docs_routed.shape[0]
        if grow > 0:
            self._docs_routed = np.concatenate(
                [self._docs_routed, np.zeros(grow, dtype=np.int64)]
            )
