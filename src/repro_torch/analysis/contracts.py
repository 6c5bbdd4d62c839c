"""Dataflow contracts as data.

Two things live here, both *imported* by the code they govern instead of
being re-derived at every call site:

1. **The exactness-contract table** — scheme × engine → ``exact`` |
   ``banded``.  This is the single source of truth for which engine modes
   must reproduce the per-tuple reference oracle bit-for-bit and which are
   only §6-banded (DESIGN.md §6/§11).  The equivalence tests import
   :data:`EXACT_SCHEMES` / :data:`BANDED_SCHEMES` from here, and the
   ``exactness-contract`` lint rule flags any module that hardcodes its own
   partition — a test asserting the wrong contract is a lint finding, not a
   flake.

2. **Static mirrors of the runtime ``Topology``/``SchemeConfig`` build
   errors** — the checks :class:`repro_torch.topology.Topology` and the typed
   scheme configs run eagerly at construction, re-expressed over plain
   literals (stage names, edge endpoint pairs, config kwargs) so the
   ``topology-config`` lint rule can run them over an AST at review time,
   before any runtime exists.  Config kwargs are validated by actually
   constructing the (pure, frozen) config dataclass: the runtime validator
   *is* the static validator, so the two can never drift.

The launch/transfer budgets of the fused feed path (DESIGN.md §11) and
the DESIGN.md §6 bands of a banded scheme are also declared here, so the
auditor (:mod:`repro_torch.analysis.audit`), the parity tests and
``chip_smoke.py`` assert the documented numbers rather than private
copies (:func:`row_violations` holds one report row against another).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SCHEMES",
    "ENGINE_MODES",
    "EXACT",
    "BANDED",
    "EXACTNESS",
    "EXACT_SCHEMES",
    "BANDED_SCHEMES",
    "DRIFT_SCHEMES",
    "exactness",
    "exact_schemes",
    "banded_schemes",
    "STEADY_FEED_DISPATCHES",
    "SEGMENT_KERNELS",
    "HOST_DISPATCHES",
    "HOST_SYNC_POINTS",
    "SCALE_TARGET",
    "WALL_CLOCK_STAMP_MODULES",
    "F32_REL",
    "BANDS",
    "EXACT_METRICS",
    "TIMING_METRICS",
    "row_violations",
    "band_violations",
    "validate_config_literal",
    "validate_stage_literal",
    "validate_edge_literal",
    "validate_topology_literal",
]

# ---------------------------------------------------------------------------
# exactness-contract table (scheme × engine mode → contract vs the oracle)
# ---------------------------------------------------------------------------

SCHEMES: Tuple[str, ...] = ("sg", "fg", "pkg", "dc", "wc", "fish")
ENGINE_MODES: Tuple[str, ...] = ("reference", "batched", "fused")

EXACT = "exact"    # bit-identical routing/counts/replicas vs the oracle
BANDED = "banded"  # bounded drift within the DESIGN.md §6 bands

#: The contract of each (scheme, engine mode) against the per-tuple
#: reference oracle.  SG/FG/PKG route sequentially-exactly in every engine;
#: DC/WC/FISH read frequencies at sub-chunk/segment granularity in the
#: batched and fused engines, so they are banded there (DESIGN.md §6, §11).
#: Fused-mode timing additionally carries an f32 epsilon — that is a
#: *metric* tolerance, not a routing contract, and is not encoded here.
EXACTNESS: Dict[Tuple[str, str], str] = {}
for _s in SCHEMES:
    EXACTNESS[(_s, "reference")] = EXACT
    _routed_exact = _s in ("sg", "fg", "pkg")
    EXACTNESS[(_s, "batched")] = EXACT if _routed_exact else BANDED
    EXACTNESS[(_s, "fused")] = EXACT if _routed_exact else BANDED


def exactness(scheme: str, mode: str) -> str:
    """``exact`` | ``banded`` for one (scheme, engine-mode) pair."""
    try:
        return EXACTNESS[(scheme, mode)]
    except KeyError:
        raise ValueError(
            f"unknown (scheme, mode) = ({scheme!r}, {mode!r}); schemes: "
            f"{SCHEMES}, modes: {ENGINE_MODES}")


def exact_schemes(mode: str = "batched") -> Tuple[str, ...]:
    return tuple(s for s in SCHEMES if exactness(s, mode) == EXACT)


def banded_schemes(mode: str = "batched") -> Tuple[str, ...]:
    return tuple(s for s in SCHEMES if exactness(s, mode) == BANDED)


#: The canonical partitions the equivalence tests parameterize over.
#: (Identical for the batched and fused engines — asserted by the table
#: construction above and re-asserted in tests/test_analysis.py.)
EXACT_SCHEMES: Tuple[str, ...] = exact_schemes("batched")
BANDED_SCHEMES: Tuple[str, ...] = banded_schemes("batched")
DRIFT_SCHEMES = BANDED_SCHEMES  # historical alias used by the test suite

# ---------------------------------------------------------------------------
# trace / transfer budgets of the fused feed path (DESIGN.md §11)
# ---------------------------------------------------------------------------

#: Segments (``EdgeReport.dispatches``) per steady-state ``session.feed``
#: (feed boundaries on pane boundaries, no events).
STEADY_FEED_DISPATCHES = 1

#: The kernels one fused segment launches besides ``pane_update``, per
#: scheme: the launch budget is one launch of each (and of ``pane_update``,
#: plus one per pane-table growth) per segment, ``store_probe`` once per
#: pane sync, nothing anywhere else.
SEGMENT_KERNELS: Dict[str, Tuple[str, ...]] = {
    "sg": ("fifo_workers",),
    "fg": ("ring_rows", "fifo_workers"),
    "pkg": ("ring_rows", "route_scan", "fifo_workers"),
    "dc": ("ring_rows", "tracker_segment", "route_scan", "fifo_workers"),
    "wc": ("ring_rows", "tracker_segment", "route_scan", "fifo_workers"),
    "fish": ("ring_rows", "tracker_segment", "route_scan", "fifo_workers"),
}

#: Device launches made by the host engines (batched / reference): none.
HOST_DISPATCHES = 0

#: The only sanctioned device→host sync points of a fused edge.  The
#: auditor classifies every observed ``flush_pane`` / ``host_sync`` into
#: one of these; anything else is a budget violation.
HOST_SYNC_POINTS: Tuple[str, ...] = ("pane_boundary", "event", "close")

# ---------------------------------------------------------------------------
# determinism & numerics targets
# ---------------------------------------------------------------------------

#: The tuple count every counter/accumulator must survive — the ROADMAP's
#: multi-host north star (10⁷–10⁸ tuples/run).  The ``int32-overflow``
#: pass phrases its findings against this number, and the accepted-findings
#: baseline records which target its justifications were audited against
#: (a baseline justified at 10⁸ says nothing about 10¹⁰).
SCALE_TARGET: int = 10 ** 8

#: The only modules allowed to read the wall clock: the obs stamp points
#: (trace spans and metric-timeline stamps carry real timestamps *by
#: design*).  A ``time.*``/``datetime.now`` value escaping a function
#: anywhere else can reach ``TopologyReport``/timeline state, making two
#: same-seed runs diverge — the ``wall-clock-leak`` rule flags exactly
#: those escapes.
WALL_CLOCK_STAMP_MODULES: Tuple[str, ...] = (
    "src/repro_torch/obs/trace.py",
    "src/repro_torch/obs/timeline.py",
)

# ---------------------------------------------------------------------------
# metric tolerances of one engine's report row against another's
# ---------------------------------------------------------------------------

#: Timing of an exact scheme on the fused engine against the host engine:
#: a relative float epsilon (a metric tolerance, not a routing contract).
F32_REL: float = 1e-4

#: The DESIGN.md §6 bands of a banded scheme against the host engine:
#: (metric, kind, bound).  ``rel``: |got - want| <= bound * |want|;
#: ``above``: got <= want + bound; ``times``: got <= max(want * bound,
#: 0.05).
BANDS: Tuple[Tuple[str, str, float], ...] = (
    ("execution_time", "rel", 0.05),
    ("throughput", "rel", 0.05),
    ("memory_overhead", "rel", 0.25),
    ("imbalance", "above", 0.05),
    ("latency_p99", "times", 10.0),
)

#: Metrics an exact scheme reproduces exactly, and those held to F32_REL.
EXACT_METRICS: Tuple[str, ...] = ("memory_overhead", "imbalance")
TIMING_METRICS: Tuple[str, ...] = ("execution_time", "latency_avg",
                                   "latency_p99")


def row_violations(scheme: str, got: Dict, want: Dict,
                   mode: str = "fused") -> List[str]:
    """Where the report row ``got`` (engine ``mode``) breaks its contract
    against the host engine's row ``want`` on the same input: exact metrics
    and ``F32_REL`` timing for an exact scheme, the :data:`BANDS` for a
    banded one.  Rows are ``EdgeReport.row()`` dicts (or any mapping with
    those keys; ``n_tuples`` is compared where both rows have it).
    Returns the violations (empty: the contract holds)."""
    out: List[str] = []
    if got.get("n_tuples") != want.get("n_tuples"):
        out.append(f"n_tuples {got.get('n_tuples')} != "
                   f"{want.get('n_tuples')}")
    if exactness(scheme, mode) == EXACT:
        for k in EXACT_METRICS:
            if got[k] != want[k]:
                out.append(f"{k} {got[k]!r} != {want[k]!r}")
        for k in TIMING_METRICS:
            if abs(got[k] - want[k]) > F32_REL * abs(want[k]):
                out.append(f"{k} {got[k]!r} vs {want[k]!r} beyond rel "
                           f"{F32_REL}")
        return out
    return out + band_violations(got, want)


def band_violations(got: Dict, want: Dict) -> List[str]:
    """Where the row ``got`` leaves the DESIGN.md §6 :data:`BANDS` around
    ``want`` (empty: within every band)."""
    out: List[str] = []
    for k, kind, bound in BANDS:
        a, b = got[k], want[k]
        ok = (abs(a - b) <= bound * abs(b) if kind == "rel"
              else a <= b + bound if kind == "above"
              else a <= max(b * bound, 0.05))
        if not ok:
            out.append(f"{k} {a!r} vs {b!r} outside the {kind} band "
                       f"{bound}")
    return out


# ---------------------------------------------------------------------------
# static mirrors of the runtime Topology / SchemeConfig build errors
# ---------------------------------------------------------------------------


def validate_config_literal(scheme: str, kwargs: Dict[str, object]
                            ) -> Optional[str]:
    """Validate a ``config_for(scheme, **kwargs)`` call whose arguments are
    all literals, by running the real (pure, frozen-dataclass) constructor.
    Returns an error message, or None when the config is valid."""
    from ..topology.configs import config_for

    try:
        config_for(scheme, **kwargs)
    except (ValueError, TypeError) as e:
        return str(e)
    return None


SOURCE = "source"  # mirror of repro_torch.topology.graph.SOURCE


def validate_stage_literal(name: object, parallelism: object,
                           cost: object = None,
                           capacities: object = None) -> Optional[str]:
    """Literal mirror of ``Stage.__post_init__`` (the checks expressible
    without constructing transforms/operators)."""
    if isinstance(name, str) and (not name or name == SOURCE):
        return f"invalid stage name {name!r} ({SOURCE!r} is reserved)"
    if isinstance(parallelism, int) and parallelism < 1:
        return (f"stage {name!r}: parallelism must be >= 1, "
                f"got {parallelism}")
    if isinstance(cost, (int, float)) and cost <= 0.0:
        return f"stage {name!r}: cost must be positive"
    if cost is not None and capacities:
        return f"stage {name!r}: give cost or capacities, not both"
    return None


def validate_edge_literal(src: object, dst: object,
                          grouping_is_config: Optional[bool] = None
                          ) -> Optional[str]:
    """Literal mirror of ``Edge.__post_init__``."""
    if dst == SOURCE:
        return "an edge cannot point at the source"
    if isinstance(src, str) and src == dst:
        return f"self-edge on stage {src!r}"
    if grouping_is_config is False:
        return (f"edge {src}->{dst}: grouping must be a SchemeConfig "
                f"(use repro_torch.topology.configs.config_for(name))")
    return None


def validate_topology_literal(stage_names: Sequence[str],
                              edges: Iterable[Tuple[str, str]]
                              ) -> List[str]:
    """Literal mirror of ``Topology.__post_init__`` over extracted stage
    names and (src, dst) endpoint pairs: duplicate stages, unknown
    endpoints, fan-in, unreachable stages, disconnection/cycles."""
    errors: List[str] = []
    names = list(stage_names)
    if not names:
        return ["topology needs at least one stage"]
    if len(set(names)) != len(names):
        errors.append(f"duplicate stage names in {names}")
    known = set(names)
    edges = list(edges)
    indeg = {n: 0 for n in names}
    for src, dst in edges:
        if src != SOURCE and src not in known:
            errors.append(f"edge {src}->{dst}: unknown src {src!r}")
        if dst not in known:
            errors.append(f"edge {src}->{dst}: unknown dst {dst!r}")
        else:
            indeg[dst] += 1
    for n, d in indeg.items():
        if d == 0:
            errors.append(f"stage {n!r} has no inbound edge (unreachable)")
        elif d > 1:
            errors.append(f"stage {n!r} has {d} inbound edges; fan-in onto "
                          f"a shared worker pool is not supported")
    # BFS from the source over the edge list (the runtime ordered_edges walk)
    if not errors:
        reached = 0
        frontier = [SOURCE]
        remaining = list(edges)
        while frontier:
            nxt, keep = [], []
            for src, dst in remaining:
                if src in frontier:
                    reached += 1
                    nxt.append(dst)
                else:
                    keep.append((src, dst))
            remaining, frontier = keep, nxt
        if reached != len(edges):
            errors.append("topology is not connected to the source "
                          "(cycle or disconnected component)")
    return errors
