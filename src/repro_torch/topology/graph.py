"""Declarative dataflow topologies — named stages, grouped edges.

The paper evaluates grouping schemes *per edge* inside Storm topologies
(DAGs of operators — the classic split→count word-count pipeline).  This
module is the declarative half of that API:

* :class:`Stage` — a named operator: ``parallelism`` workers, a per-tuple
  processing cost, and an optional vectorised :class:`KeyTransform` that
  maps each processed tuple onto ``fanout`` downstream tuples (a sentence
  splitting into words).
* :class:`Edge` — connects two stages (or the reserved ``"source"``) and
  carries a typed :class:`~repro_torch.topology.configs.SchemeConfig`: the
  grouping applied to tuples crossing the edge.
* :class:`Topology` — the validated DAG.  Supported shape: a tree rooted at
  the source (every stage has exactly one inbound grouped edge; a stage may
  broadcast its output along several outbound edges).  That covers the
  paper's pipelines (chains) and fan-out trees; fan-in (shared worker pools
  fed by several grouped edges) is out of scope and rejected eagerly.
* :class:`RecordBatch` — a frozen columnar chunk of the input stream
  (int keys + optional float64 payload ``values`` + explicit nondecreasing
  ``timestamps``): the unit a session ingests.
* :class:`Source` — the keyed input stream: an array one-batch convenience
  form, or an iterable of record batches.
* :class:`ScopedEvent` — a membership/capacity event targeted at one
  stage's worker pool, with ``at`` indexing that edge's input stream (or
  ``at_time`` addressing it by stream timestamp).

Engines that execute a topology live in :mod:`repro_torch.topology.engine`.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from ..core.stream import CapacityEvent, MembershipEvent
from ..state.window import WindowOp
from .configs import SchemeConfig

__all__ = [
    "SOURCE",
    "KeyTransform",
    "hashed_fanout",
    "project_mod",
    "Stage",
    "Edge",
    "Topology",
    "RecordBatch",
    "Source",
    "ScopedEvent",
]

SOURCE = "source"  # reserved name: the topology's input stream endpoint


# ---------------------------------------------------------------------------
# key transforms (what a stage emits downstream)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KeyTransform:
    """Vectorised tuple emission: ``fn(keys) -> (n * fanout,)`` int array.

    The ``fanout`` outputs of input tuple ``i`` occupy the contiguous block
    ``out[i*fanout : (i+1)*fanout]`` and are released when tuple ``i``
    finishes at the emitting stage.  Must be deterministic — both engines
    and the reference oracle replay it.
    """

    fanout: int
    fn: Callable[[np.ndarray], np.ndarray]
    label: str = "custom"

    def __post_init__(self) -> None:
        if self.fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {self.fanout}")

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        out = np.asarray(self.fn(keys))
        if out.shape != (keys.shape[0] * self.fanout,):
            raise ValueError(
                f"transform {self.label!r} returned shape {out.shape}, "
                f"expected ({keys.shape[0] * self.fanout},)")
        return out


_MIX = np.int64(2654435761)  # Knuth multiplicative-hash constant


def hashed_fanout(fanout: int, vocab: int, salt: int = 0x9E37) -> KeyTransform:
    """Word-split-style transform: key ``k`` always emits the same ``fanout``
    pseudo-random "word" ids in ``[0, vocab)``.

    Because the word set is a deterministic function of the sentence key, a
    hot upstream key fans into hot downstream keys — the multi-hop skew the
    topology API exists to study (a hot partition feeding a hot partition).
    """
    if vocab < 1:
        raise ValueError(f"vocab must be >= 1, got {vocab}")

    def fn(keys: np.ndarray) -> np.ndarray:
        k = keys.astype(np.int64)[:, None]
        j = np.arange(fanout, dtype=np.int64)[None, :]
        h = (k * _MIX + (j + 1) * np.int64(salt)) & np.int64(0x7FFFFFFF)
        return (h % vocab).reshape(-1)

    return KeyTransform(fanout, fn, label=f"hashed_fanout({fanout},{vocab})")


def project_mod(vocab: int) -> KeyTransform:
    """1→1 projection onto a smaller key space (aggregation-style rekeying):
    many upstream keys collapse onto each downstream key."""
    if vocab < 1:
        raise ValueError(f"vocab must be >= 1, got {vocab}")
    return KeyTransform(
        1, lambda keys: keys.astype(np.int64) % vocab,
        label=f"project_mod({vocab})")


# ---------------------------------------------------------------------------
# stages / edges / topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """A named operator: ``parallelism`` FIFO workers processing one tuple in
    ``cost`` seconds each (or per-worker ``capacities``, cycled over the
    pool — the Fig. 7 fast/slow mix), optionally emitting downstream tuples
    via ``transform`` *or* running a windowed keyed aggregation via
    ``operator``.

    An ``operator`` stage holds per-worker keyed state (DESIGN.md §9): the
    engines maintain its window stores, account migration cost on churn,
    and — if the stage has a downstream edge — emit one partial-aggregate
    tuple per state entry at window close, keyed by the aggregation key
    (the merge stage's input).  ``transform`` and ``operator`` are mutually
    exclusive: an operator's emission *is* its partial stream.
    """

    name: str
    parallelism: int
    cost: Optional[float] = None          # uniform seconds/tuple
    capacities: Tuple[float, ...] = ()    # per-worker override (cycled)
    transform: Optional[KeyTransform] = None
    operator: Optional[WindowOp] = None

    def __post_init__(self) -> None:
        if not self.name or self.name == SOURCE:
            raise ValueError(f"invalid stage name {self.name!r} "
                             f"({SOURCE!r} is reserved)")
        if self.parallelism < 1:
            raise ValueError(f"stage {self.name!r}: parallelism must be "
                             f">= 1, got {self.parallelism}")
        if self.cost is not None and self.cost <= 0.0:
            raise ValueError(f"stage {self.name!r}: cost must be positive")
        if self.cost is not None and self.capacities:
            raise ValueError(f"stage {self.name!r}: give cost or "
                             f"capacities, not both")
        if any(c <= 0.0 for c in self.capacities):
            raise ValueError(f"stage {self.name!r}: capacities must be "
                             f"positive")
        if self.operator is not None:
            if not isinstance(self.operator, WindowOp):
                raise TypeError(f"stage {self.name!r}: operator must be a "
                                f"repro_torch.state.WindowOp, got "
                                f"{type(self.operator).__name__}")
            if self.transform is not None:
                raise ValueError(f"stage {self.name!r}: transform and "
                                 f"operator are mutually exclusive (an "
                                 f"operator emits its partial aggregates)")

    @property
    def fanout(self) -> int:
        return self.transform.fanout if self.transform else 1

    def worker_capacities(self, arrival_rate: float,
                          utilization: float = 0.9) -> np.ndarray:
        """Seconds/tuple per worker.  Defaults to a feasible pool at
        ``utilization`` for the given input rate (the simulator's
        ``0.9 · W / λ`` convention)."""
        if self.capacities:
            pat = np.asarray(self.capacities, dtype=np.float64)
            return pat[np.arange(self.parallelism) % pat.shape[0]]
        if self.cost is not None:
            return np.full(self.parallelism, float(self.cost))
        return np.full(self.parallelism,
                       utilization * self.parallelism / arrival_rate)


@dataclasses.dataclass(frozen=True)
class Edge:
    """A grouped connection ``src → dst``; ``src`` may be ``"source"``."""

    src: str
    dst: str
    grouping: SchemeConfig

    def __post_init__(self) -> None:
        if self.dst == SOURCE:
            raise ValueError("an edge cannot point at the source")
        if self.src == self.dst:
            raise ValueError(f"self-edge on stage {self.src!r}")
        if not isinstance(self.grouping, SchemeConfig):
            raise TypeError(
                f"edge {self.src}->{self.dst}: grouping must be a "
                f"SchemeConfig, got {type(self.grouping).__name__} "
                f"(use repro_torch.topology.configs.config_for(name))")

    @property
    def name(self) -> str:
        return f"{self.src}->{self.dst}"


@dataclasses.dataclass(frozen=True)
class Topology:
    """A validated dataflow DAG: a tree of stages rooted at the source."""

    name: str
    stages: Tuple[Stage, ...]
    edges: Tuple[Edge, ...]

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("topology needs at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        known = set(names)
        indeg: Dict[str, int] = {n: 0 for n in names}
        for e in self.edges:
            if e.src != SOURCE and e.src not in known:
                raise ValueError(f"edge {e.name}: unknown src {e.src!r}")
            if e.dst not in known:
                raise ValueError(f"edge {e.name}: unknown dst {e.dst!r}")
            indeg[e.dst] += 1
        for n, d in indeg.items():
            if d == 0:
                raise ValueError(f"stage {n!r} has no inbound edge "
                                 f"(unreachable)")
            if d > 1:
                raise ValueError(
                    f"stage {n!r} has {d} inbound edges; fan-in onto a "
                    f"shared worker pool is not supported — split it into "
                    f"separate stages")
        # in-degree exactly 1 everywhere ⇒ the edge set is a forest of
        # trees; reachability from the source makes it a single tree (and
        # therefore acyclic) — verify by walking the BFS order
        if len(self.ordered_edges()) != len(self.edges):
            raise ValueError("topology is not connected to the source "
                             "(cycle or disconnected component)")

    # -- lookups ---------------------------------------------------------------
    def stage(self, name: str) -> Stage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"no stage named {name!r}")

    def ordered_edges(self) -> List[Edge]:
        """Edges in dataflow (BFS-from-source) order."""
        out: List[Edge] = []
        frontier = [SOURCE]
        remaining = list(self.edges)
        while frontier:
            nxt: List[str] = []
            keep: List[Edge] = []
            for e in remaining:
                if e.src in frontier:
                    out.append(e)
                    nxt.append(e.dst)
                else:
                    keep.append(e)
            remaining = keep
            frontier = nxt
        return out

    def sinks(self) -> List[str]:
        srcs = {e.src for e in self.edges}
        return [s.name for s in self.stages if s.name not in srcs]

    def fanout_to(self, name: str) -> int:
        """Cumulative source→stage tuple multiplication (transform fanouts
        along the unique path from the source)."""
        parent = {e.dst: e.src for e in self.edges}
        f = 1
        node = parent[name]
        while node != SOURCE:
            f *= self.stage(node).fanout
            node = parent[node]
        return f


def _frozen_column(arr: Optional[np.ndarray], dtype=None) -> Optional[np.ndarray]:
    """A read-only copy-on-write view of one batch column: callers keep
    their arrays writable; the batch's view can never mutate mid-session."""
    if arr is None:
        return None
    out = np.asarray(arr) if dtype is None else np.asarray(arr, dtype=dtype)
    if out.flags.writeable:
        out = out.copy()
        out.setflags(write=False)
    return out


class RecordBatch:
    """A frozen columnar chunk of a keyed stream — the unit a
    :class:`~repro_torch.topology.engine.Session` ingests via ``feed``:

    * ``keys`` — 1-D interned integer key ids (int32 preferred: the batched
      grouping engine routes without hashing Python objects);
    * ``timestamps`` — float64 per-record arrival times in seconds,
      nondecreasing within the batch (and across the batches of one
      session);
    * ``values`` — optional float64 payload column (the real tuple values a
      ``WindowOp(value="payload")`` aggregates instead of the pseudo-payload).

    Columns are copied read-only on construction and exposed as read-only
    properties, so a batch can be fed to several sessions (or replayed)
    without aliasing hazards.  Equality is identity, as in the reference.
    """

    __slots__ = ("_keys", "_timestamps", "_values")

    def __init__(self, keys, timestamps, values=None) -> None:
        keys = np.asarray(keys)
        if keys.ndim != 1 or keys.dtype.kind not in "iu":
            raise TypeError(
                f"RecordBatch keys must be a 1-D integer array, got "
                f"dtype={keys.dtype} shape={keys.shape} (intern via "
                f"repro_torch.data.synthetic.intern_keys)")
        ts = np.asarray(timestamps, dtype=np.float64)
        if ts.shape != keys.shape:
            raise ValueError(
                f"timestamps shape {ts.shape} != keys shape {keys.shape}")
        if ts.shape[0] > 1 and np.any(np.diff(ts) < 0.0):
            raise ValueError("timestamps must be nondecreasing")
        if values is not None:
            values = np.asarray(values, dtype=np.float64)
            if values.shape != keys.shape:
                raise ValueError(
                    f"values shape {values.shape} != keys shape {keys.shape}")
        self._keys = _frozen_column(keys)
        self._timestamps = _frozen_column(ts)
        self._values = _frozen_column(values)

    @property
    def keys(self) -> np.ndarray:
        return self._keys

    @property
    def timestamps(self) -> np.ndarray:
        return self._timestamps

    @property
    def values(self) -> Optional[np.ndarray]:
        return self._values

    def __len__(self) -> int:
        return int(self._keys.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class Source:
    """The topology's input stream, in either of two forms:

    * **array form** (the one-batch convenience): ``Source(keys,
      arrival_rate=...)`` — interned integer keys at ``arrival_rate``
      tuples/second (tuple ``i`` arrives at ``i / arrival_rate``), with
      optional per-tuple ``values`` payload and explicit ``timestamps``
      overriding the uniform grid;
    * **batch form**: ``Source(batches=<iterable of
      RecordBatch>)`` — an incremental stream whose batches a session feeds
      one at a time.  ``arrival_rate`` remains the capacity-planning hint
      for stages without an explicit cost.

    A Source wrapping a generator is single-use (the generator is consumed
    by ``iter_batches``); the array form is reusable.
    """

    keys: Optional[np.ndarray] = None
    arrival_rate: float = 10_000.0
    values: Optional[np.ndarray] = None
    timestamps: Optional[np.ndarray] = None
    batches: Optional[Iterable[RecordBatch]] = None

    def __post_init__(self) -> None:
        if self.arrival_rate <= 0.0:
            raise ValueError("arrival_rate must be positive")
        if (self.keys is None) == (self.batches is None):
            raise ValueError("give exactly one of keys= (array form) or "
                             "batches= (record-batch form)")
        if self.batches is not None and (self.values is not None
                                         or self.timestamps is not None):
            raise ValueError("values/timestamps columns belong inside each "
                             "RecordBatch in batch form")

    def iter_batches(self, batch_size: Optional[int] = None
                     ) -> Iterator[RecordBatch]:
        """The stream as :class:`RecordBatch` chunks.  Array form yields one
        batch (or uniform-grid chunks of ``batch_size`` — the session-API
        replay of a materialized stream); batch form yields the wrapped
        iterable as-is (``batch_size`` must be ``None``)."""
        if batch_size is not None and batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if self.batches is not None:
            if batch_size is not None:
                raise ValueError("batch_size only applies to the array form")
            for b in self.batches:
                if not isinstance(b, RecordBatch):
                    raise TypeError(f"batches must yield RecordBatch, got "
                                    f"{type(b).__name__}")
                yield b
            return
        keys = np.asarray(self.keys)
        n = int(keys.shape[0])
        if self.timestamps is not None:
            ts = np.asarray(self.timestamps, dtype=np.float64)
        else:
            ts = np.arange(n, dtype=np.float64) * (1.0 / self.arrival_rate)
        vals = self.values
        if batch_size is None:
            batch_size = max(n, 1)
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            yield RecordBatch(
                keys[lo:hi], ts[lo:hi],
                None if vals is None else np.asarray(vals)[lo:hi])


@dataclasses.dataclass(frozen=True)
class ScopedEvent:
    """A membership/capacity event on one stage's worker pool; the wrapped
    event's ``at`` indexes that stage's *input* stream (tuples crossing its
    inbound edge)."""

    stage: str
    event: object

    def __post_init__(self) -> None:
        if not isinstance(self.event, (MembershipEvent, CapacityEvent)):
            raise TypeError(
                f"ScopedEvent wraps MembershipEvent or CapacityEvent, got "
                f"{type(self.event).__name__}")
