"""The port's engines against the JAX package's, end to end.

* batched: the host engines are NumPy in both packages — whole reports,
  events and windows included, must be identical for all six schemes;
* fused (port on ``device="cpu"``) vs the JAX fused engine: SG/FG/PKG
  exact in counts, replicas and imbalance, timing within ``F32_REL`` (the
  reference's device clock is float32); DC/WC/FISH within the DESIGN.md
  §6 bands; merged windows exact under the array and device stores and
  through membership/capacity events; the same ``dispatches``;
* a same-seed double run is bit-identical, and a stream started in JAX
  continues in the port through ``repro_torch.convert``;
* isolation: the port and ``chip_smoke.py`` import neither ``jax`` nor
  ``repro``, and the device entry points raise without a card.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.topology as RT
import repro_torch.core as PC
import repro_torch.topology as PT
from repro.core.stream import simulate_edge as ref_simulate_edge
from repro_torch.convert import runner_from_reference
from repro_torch.core.stream import simulate_edge
from repro_torch.state import direct_aggregate

from torch_helpers import (CPU, DRIFT, EXACT, F32_REL, SCHEMES,
                           assert_within_bands, one_stage, run_session,
                           zf_stream)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stream():
    return zf_stream(3_000, num_keys=400)


def _events(T):
    C = PC if T is PT else RC
    return [T.ScopedEvent("agg", C.MembershipEvent(
                at=1_100, workers=tuple(range(10)))),
            T.ScopedEvent("agg", C.CapacityEvent(at=1_700,
                                                 capacities={0: 4e-3})),
            T.ScopedEvent("agg", C.MembershipEvent(
                at=2_300, workers=tuple(range(1, 10))))]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_reports_identical(scheme, stream):
    keys, values = stream
    runs = []
    for T in (PT, RT):
        op = T.WindowOp(agg="sum", value="payload", size=700)
        runs.append(run_session(T, "batched", one_stage(T, scheme, op),
                                keys, values, feeds=3, events=_events(T)))
    assert runs[0].to_dict() == runs[1].to_dict()


def _fused_pair(scheme, keys, values, backend="array", feeds=3,
                events=False, size=1_000):
    out = []
    for T, kw in ((PT, {"device": CPU}), (RT, {})):
        op = T.WindowOp(agg="sum", value="payload", size=size,
                        backend=backend)
        out.append(run_session(T, "fused", one_stage(T, scheme, op), keys,
                               values, feeds=feeds,
                               events=_events(T) if events else (), **kw))
    return out


def _assert_fused_contract(scheme, rp, rr, keys, values, size):
    ep, er = rp.edges[0], rr.edges[0]
    assert ep.dispatches == er.dispatches
    assert ep.n_tuples == er.n_tuples
    if scheme in EXACT:
        assert ep.memory_overhead == er.memory_overhead
        assert ep.imbalance == er.imbalance
        for k in ("execution_time", "latency_avg", "latency_p99"):
            assert getattr(ep, k) == pytest.approx(getattr(er, k),
                                                   rel=F32_REL)
    else:
        assert_within_bands(ep, er)
    merged = rp.state["agg"]["merged"]
    assert merged == rr.state["agg"]["merged"]
    op = PT.WindowOp(agg="sum", value="payload", size=size)
    assert merged == direct_aggregate(keys, op, values=values)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_matches_jax_fused(scheme, stream):
    keys, values = stream
    rp, rr = _fused_pair(scheme, keys, values)
    _assert_fused_contract(scheme, rp, rr, keys, values, 1_000)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_device_store_matches_jax_fused(scheme, stream):
    keys, values = stream
    rp, rr = _fused_pair(scheme, keys, values, backend="device")
    _assert_fused_contract(scheme, rp, rr, keys, values, 1_000)
    assert rp.state["agg"]["backend"] == "device"


@pytest.mark.parametrize("scheme", ["pkg"])
def test_fused_events_match_jax_fused(scheme, stream):
    keys, values = stream
    rp, rr = _fused_pair(scheme, keys, values, backend="dict", feeds=4,
                         events=True, size=800)
    _assert_fused_contract(scheme, rp, rr, keys, values, 800)
    ep, er = rp.edges[0], rr.edges[0]
    assert len(ep.remap_events) == len(er.remap_events) == 2
    if scheme in EXACT:
        assert rp.state["agg"]["migration_bytes"] == \
            rr.state["agg"]["migration_bytes"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_events_device_store_match_jax_fused(scheme, stream):
    """Two membership changes and a capacity change, the device window
    store: every scheme against the JAX fused engine (the contract above:
    exact or banded, merged windows exact), both remaps seen."""
    keys, values = stream
    rp, rr = _fused_pair(scheme, keys, values, backend="device", feeds=4,
                         events=True, size=800)
    _assert_fused_contract(scheme, rp, rr, keys, values, 800)
    assert rp.state["agg"]["backend"] == "device"
    ep, er = rp.edges[0], rr.edges[0]
    assert len(ep.remap_events) == len(er.remap_events) == 2
    if scheme in EXACT:
        assert rp.state["agg"]["migration_bytes"] == \
            rr.state["agg"]["migration_bytes"]


def _two_hop(T, scheme, backend):
    """source → split (hashed_fanout ×2) → windowed count sink, the scheme
    on both edges."""
    op = T.WindowOp(agg="count", size=1_200, backend=backend)
    return T.Topology(
        name="two-hop",
        stages=(T.Stage("split", 4, transform=T.hashed_fanout(2, vocab=300)),
                T.Stage("count", 8, operator=op)),
        edges=(T.Edge("source", "split", T.config_for(scheme)),
               T.Edge("split", "count", T.config_for(scheme))))


def _two_hop_events(T):
    C = PC if T is PT else RC
    return [T.ScopedEvent("split", C.MembershipEvent(at=900,
                                                     workers=(0, 1, 2))),
            T.ScopedEvent("count", C.MembershipEvent(
                at=2_000, workers=tuple(range(10)))),
            T.ScopedEvent("count", C.CapacityEvent(at=3_100,
                                                   capacities={0: 4e-3})),
            T.ScopedEvent("count", C.MembershipEvent(
                at=4_400, workers=tuple(range(1, 10))))]


def _edge_row(e):
    return dict(e.row(), n_tuples=e.n_tuples)


@pytest.mark.parametrize("scheme", ["sg", "pkg", "fish"])
def test_two_hop_with_scoped_events_matches_jax(scheme, stream):
    """A word-count topology — a ``hashed_fanout`` stage, then a windowed
    sink — with membership and capacity events scoped to both edges, fed in
    three batches, under the array and the device store.

    Batched: the port's report equals the JAX package's (array store; the
    device store's run equals it in every edge and every merged window).
    Fused (``device="cpu"``): the first edge meets its contract against
    the JAX fused engine (``contracts.row_violations``).  The sink edge's
    input is ordered by the first edge's finish times, which both fused
    engines round differently from the host (the port in float64 relative
    time, the reference in float32), so near-ties may swap and the sink
    edge is held to the DESIGN.md §6 bands for every scheme; its merged
    windows, segments and remaps equal the JAX fused engine's."""
    from repro_torch.analysis.contracts import band_violations, \
        row_violations

    keys, values = stream
    want_b = run_session(RT, "batched", _two_hop(RT, scheme, "array"), keys,
                         values, feeds=3, events=_two_hop_events(RT))
    want_f = run_session(RT, "fused", _two_hop(RT, scheme, "array"), keys,
                         values, feeds=3, events=_two_hop_events(RT))
    for backend in ("array", "device"):
        got_b = run_session(PT, "batched", _two_hop(PT, scheme, backend),
                            keys, values, feeds=3,
                            events=_two_hop_events(PT), device=CPU)
        db, dw = got_b.to_dict(), want_b.to_dict()
        if backend == "array":
            assert db == dw
        assert db["edges"] == dw["edges"]
        assert got_b.state["count"]["merged"] == \
            want_b.state["count"]["merged"]
        got_f = run_session(PT, "fused", _two_hop(PT, scheme, backend),
                            keys, values, feeds=3,
                            events=_two_hop_events(PT), device=CPU)
        (p1, p2), (r1, r2) = got_f.edges, want_f.edges
        assert row_violations(scheme, _edge_row(p1), _edge_row(r1)) == []
        assert band_violations(_edge_row(p2), _edge_row(r2)) == []
        for ep, er in ((p1, r1), (p2, r2)):
            assert ep.n_tuples == er.n_tuples
            assert ep.dispatches == er.dispatches
            assert len(ep.remap_events) == len(er.remap_events)
        assert len(p2.remap_events) == 2
        assert got_f.state["count"]["merged"] == \
            want_f.state["count"]["merged"]


@pytest.mark.parametrize("scheme", DRIFT)
def test_fused_same_seed_double_run_bit_identical(scheme, stream):
    keys, values = stream
    runs = []
    for _ in range(2):
        op = PT.WindowOp(agg="sum", value="payload", size=1_000,
                         backend="device")
        runs.append(run_session(PT, "fused", one_stage(PT, scheme, op),
                                keys, values, feeds=3, device=CPU))
    assert runs[0].to_dict() == runs[1].to_dict()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_jax_started_stream_continues_in_port(scheme, stream):
    """Feed 1 runs fused in JAX, with a keyed window whose pane is still
    open on the device at the cut; the converter carries runner, grouper,
    edge state and window manager into the port, which runs feed 2.
    Against an all-JAX two-feed run: windows exact for every scheme;
    SG/FG/PKG exact in counts and replicas, finish times within F32_REL;
    DC/WC/FISH within the bands."""
    from repro.state import KeyedStateManager as RefManager
    from repro.state import WindowOp as RefWindowOp
    from repro.topology.configs import config_for as ref_config
    from repro_torch.convert import manager_from_reference

    keys, values = stream
    n1 = 1_600  # inside the second 1,000-tuple pane
    ts = np.arange(keys.shape[0], dtype=np.float64) / 2e4
    caps = np.full(8, 4e-4)
    op = dict(agg="sum", value="payload", size=1_000)
    g_ref = ref_config(scheme).build(8)
    mgr_ref = RefManager(RefWindowOp(**op))
    r1 = ref_simulate_edge(g_ref, keys[:n1], times=ts[:n1], mode="fused",
                           capacities=caps, arrival_rate=2e4,
                           state_sink=mgr_ref, values=values[:n1])
    mgr_port = manager_from_reference(mgr_ref, device=CPU)
    g_port, st_port = runner_from_reference(
        r1.state.device, g_ref, r1.state, sink=mgr_port, device=CPU)
    assert st_port.device.pane_fed == 600
    p2 = simulate_edge(g_port, keys[n1:], times=ts[n1:], mode="fused",
                       state=st_port, arrival_rate=2e4, state_sink=mgr_port,
                       values=values[n1:], device=CPU)
    r2 = ref_simulate_edge(g_ref, keys[n1:], times=ts[n1:], mode="fused",
                           state=r1.state, arrival_rate=2e4,
                           state_sink=mgr_ref, values=values[n1:])
    assert p2.dispatches == r2.dispatches
    for dev, mgr in ((st_port.device, mgr_port), (r1.state.device, mgr_ref)):
        dev.flush_pane(mgr)
    rep_p, rep_r = mgr_port.report("agg"), mgr_ref.report("agg")
    assert rep_p.merged == rep_r.merged == direct_aggregate(
        keys, PT.WindowOp(**op), values=values)
    if scheme in EXACT:
        assert rep_p.partials == rep_r.partials
        np.testing.assert_array_equal(g_port.assigned_counts,
                                      g_ref.assigned_counts)
        assert g_port.replicas == g_ref.replicas
        np.testing.assert_allclose(p2.finishes, r2.finishes, rtol=F32_REL)
    else:
        assert_within_bands(_as_edge(p2), _as_edge(r2))


def _recorded(mgr):
    """Record every pane flush the manager is fed: (tuples, entries)."""
    got = []
    real = mgr.feed_aggregated

    def feed_aggregated(n_tuples, entries):
        got.append((n_tuples, entries))
        return real(n_tuples, entries)
    mgr.feed_aggregated = feed_aggregated
    return got


@pytest.mark.parametrize("scheme", EXACT)
def test_fused_runner_pane_flushes_match_jax(scheme):
    """The JAX package's FusedEdgeRunner and the port's (``device="cpu"``)
    on the same seeded feeds: eight feeds of 400 into 2,000-tuple panes, so
    a pane spans five segments; the key space grows from 64 to 1,024 ids
    in the first pane (a key-capacity growth mid-pane), and the port's
    compact pane table grows from 1,024 to 4,096 slots in it.  Every
    flush hands the sink the same entries: per worker, keys ascending,
    value and count sums, and the worker's last stream index."""
    from repro.state import KeyedStateManager as RefManager
    from repro.state import WindowOp as RefWindowOp
    from repro.topology.configs import config_for as ref_config
    from repro_torch.state import KeyedStateManager, WindowOp

    rng = np.random.default_rng(21)
    n, feed = 3_200, 400
    keys = np.concatenate([rng.integers(0, 60, 2 * feed),
                           rng.integers(0, 1_000, n - 2 * feed)])
    values = rng.integers(1, 10, n).astype(np.float64)
    ts = np.arange(n, dtype=np.float64) / 2e4
    caps = np.full(8, 4e-4)
    op = dict(agg="sum", value="payload", size=2_000)
    g_ref, g_port = ref_config(scheme).build(8), PT.config_for(scheme).build(8)
    mgr_ref = RefManager(RefWindowOp(**op))
    mgr_port = KeyedStateManager(WindowOp(**op))
    got_ref, got_port = _recorded(mgr_ref), _recorded(mgr_port)
    st_ref = st_port = None
    slots, kcaps = [], []
    for lo in range(0, n, feed):
        sl = slice(lo, lo + feed)
        kw = dict(times=ts[sl], mode="fused", capacities=caps,
                  arrival_rate=2e4, values=values[sl])
        st_ref = ref_simulate_edge(g_ref, keys[sl], state=st_ref,
                                   state_sink=mgr_ref, **kw).state
        st_port = simulate_edge(g_port, keys[sl], state=st_port,
                                state_sink=mgr_port, device=CPU,
                                **kw).state
        slots.append(st_port.device.pane_keys.shape[0])
        kcaps.append(st_port.device._kcap)
    for st, mgr in ((st_port, mgr_port), (st_ref, mgr_ref)):
        st.device.flush_pane(mgr)
    assert slots[0] == 1_024 and max(slots) == 4_096
    assert kcaps[:2] == [64, 64] and kcaps[2] == 1_024  # inside pane 1
    assert [t for t, _ in got_port] == [t for t, _ in got_ref] \
        == [2_000, 1_200]
    for (_, ep), (_, er) in zip(got_port, got_ref):
        assert len(ep) == len(er)
        for a, b in zip(ep, er):
            assert a[0] == b[0] and a[4] == b[4]
            for x, y in zip(a[1:4], b[1:4]):
                np.testing.assert_array_equal(x, y)


def _as_edge(res):
    m = res.metrics

    class E:
        n_tuples = res.finishes.shape[0]
        execution_time = m.execution_time
        throughput = m.throughput
        memory_overhead = m.memory_overhead
        imbalance = m.imbalance
        latency_p99 = m.latency_p99
    return E


def test_telemetry_leaves_fused_reports_identical(stream):
    from repro_torch.obs import Telemetry

    keys, values = stream
    reps = []
    for tel in (None, Telemetry(enabled=True)):
        op = PT.WindowOp(agg="sum", value="payload", size=1_000)
        sess = PT.SimulatorEngine(mode="fused", device=CPU).open(
            one_stage(PT, "fish", op), arrival_rate=2e4, telemetry=tel)
        ts = np.arange(keys.shape[0]) / 2e4
        for lo in range(0, keys.shape[0], 1_000):
            sess.feed(PT.RecordBatch(keys[lo:lo + 1_000], ts[lo:lo + 1_000],
                                     values[lo:lo + 1_000]))
        reps.append(sess.close().to_dict())
    on = reps[1].pop("timeline")
    assert reps[0] == reps[1]
    assert on["series"]["fish.hot_set_size"]["n_points"] > 0
    assert on["metrics"]["fused.dispatches"]["value"] == 3


def test_tracer_and_timeline_stamp_through_injected_clocks():
    """The port's obs modules read time only through the clocks they are
    given: a fake clock makes spans and timeline points reproducible."""
    from repro_torch.obs import NULL_SPAN, Telemetry, Timeline, Tracer

    ticks = iter(range(100))
    tr = Tracer(clock=lambda: float(next(ticks)), wall_clock=lambda: 7.0)
    with tr.span("a", cat="x", n=1):
        pass
    tr.instant("b")
    assert (tr.t0, tr.wall0) == (0.0, 7.0)
    assert [(s.name, s.t0, s.t1) for s in tr.spans] == [("a", 1.0, 2.0)]
    assert tr.instants == [(3.0, "b", "run", None)]
    tl = Timeline(clock=lambda: 5.0)
    tl.point("m", 2.0, engine_clock=1.5, feed_idx=0, epoch_idx=3)
    assert tl.export()["series"]["m"]["points"] == [[0.0, 1.5, 0, 3, 2.0]]
    off = Telemetry(enabled=False)
    assert off.tracer.span("x") is NULL_SPAN and off.timeline_dict() is None


# ---------------------------------------------------------------------------
# isolation and device defaults
# ---------------------------------------------------------------------------


def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_device_entry_points_raise_without_a_card(stream):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.state.store import DeviceStateStore
    from repro_torch.topology.configs import config_for

    keys, _ = stream
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_edge(config_for("fg").build(4), keys[:100], mode="fused",
                      arrival_rate=1e4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_session(PT, "fused", one_stage(PT, "sg"), keys[:100])
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStateStore()
