"""The port's contract tools on the CPU: the launch and sync auditor of a
fused edge (``repro_torch.analysis.audit``), the differential sanitizer
(``repro_torch.analysis.sanitize``) and trace export with its CLI
(``repro_torch.obs.export``, ``repro_torch.obs.cli``).

The fused runner runs on ``device="cpu"`` (the kernels' plain versions):
the launch budget is then held on the kernel wrappers' calls, and no
``LAUNCHES`` counter may move.  The audited call sequence (kinds,
lengths, offsets, sync contexts) must equal the reference auditor's over
the JAX package's fused engine on the same stream.
"""

import json
import math

import numpy as np
import pytest

import repro.topology as RT
import repro_torch.topology as PT
from repro.analysis.audit import EdgeAuditor as RAuditor
from repro_torch.analysis import contracts
from repro_torch.analysis.audit import EdgeAuditor, LaunchBudget
from repro_torch.analysis.sanitize import (diff_reports, diff_values,
                                           double_run, sanitized)
from repro_torch.core import MembershipEvent
from repro_torch.data.synthetic import zipf_time_evolving
from repro_torch.kernels import feed_fused as ff
from repro_torch.kernels import store_probe as sp
from repro_torch.obs.cli import main as obs_main
from repro_torch.obs.cli import summarize_trace
from repro_torch.obs.export import TraceWriter, validate_chrome_trace
from repro_torch.obs.telemetry import Telemetry

from torch_helpers import CPU, SCHEMES

RATE = 2e4


@pytest.fixture(scope="module")
def stream():
    keys = zipf_time_evolving(6_000, num_keys=500, z=1.2, seed=0)
    values = np.random.default_rng(1).integers(1, 10, 6_000).astype(
        np.float64)
    return keys, values


def _topo(T, scheme, op=None, workers=8):
    return T.Topology(name="aud",
                      stages=(T.Stage("agg", workers, operator=op),),
                      edges=(T.Edge("source", "agg", T.config_for(scheme)),))


def _open(T, scheme, op=None, **kw):
    eng = T.SimulatorEngine(mode="fused", **kw)
    return eng.open(_topo(T, scheme, op), arrival_rate=RATE)


def _mixed_batches(T, keys, values, sizes):
    """Uneven slices of the stream on one clock; the first record carries
    the largest key so the key capacity is fixed from the warm-up on."""
    total = sum(sizes)
    ks = np.resize(keys, total).copy()
    ks[0] = ks.max()
    vs = np.resize(values, total)
    ts = np.arange(total, dtype=np.float64) / RATE
    out, lo = [], 0
    for n in sizes:
        out.append(T.RecordBatch(keys=ks[lo:lo + n],
                                 timestamps=ts[lo:lo + n],
                                 values=vs[lo:lo + n]))
        lo += n
    return out


def _zero_launches():
    return dict(ff.LAUNCHES, **sp.LAUNCHES)


def _trail(aud):
    """The audited call sequence both auditors record."""
    return [(e.kind, e.tuples, e.offset, e.context) for e in aud.events]


# ---------------------------------------------------------------------------
# the contracts table (repro_torch.analysis.contracts)
# ---------------------------------------------------------------------------


def test_contracts_match_reference():
    from repro.analysis import contracts as R

    for name in ("SCHEMES", "ENGINE_MODES", "EXACTNESS", "EXACT_SCHEMES",
                 "BANDED_SCHEMES", "DRIFT_SCHEMES", "STEADY_FEED_DISPATCHES",
                 "HOST_DISPATCHES", "HOST_SYNC_POINTS", "SCALE_TARGET"):
        assert getattr(contracts, name) == getattr(R, name), name
    assert set(contracts.SEGMENT_KERNELS) == set(contracts.SCHEMES)


@pytest.mark.parametrize("scheme,kwargs", [
    ("fish", {}), ("fish", {"d_min": 0}), ("pkg", {"nope": 1}),
    ("dc", {"theta_frac": 2.0}), ("wc", {}), ("sg", {"seed": 3})])
def test_validate_config_literal_matches_reference(scheme, kwargs):
    from repro.analysis import contracts as R

    got = contracts.validate_config_literal(scheme, kwargs)
    assert got == R.validate_config_literal(scheme, kwargs)


@pytest.mark.parametrize("stages,edges", [
    (["a", "b"], [("source", "a"), ("a", "b")]),
    (["a", "a"], [("source", "a")]),
    (["a", "b"], [("source", "a"), ("source", "b"), ("a", "b")]),
    (["a", "b"], [("source", "a"), ("x", "b")]),
    ([], [])])
def test_validate_topology_literal_matches_reference(stages, edges):
    from repro.analysis import contracts as R

    assert contracts.validate_topology_literal(stages, edges) == \
        R.validate_topology_literal(stages, edges)
    assert contracts.validate_stage_literal("source", 0) == \
        R.validate_stage_literal("source", 0)
    assert contracts.validate_edge_literal("a", "a") == \
        R.validate_edge_literal("a", "a")


def test_row_violations_exact_and_banded():
    row = dict(n_tuples=100, execution_time=10.0, latency_avg=1.0,
               latency_p99=2.0, throughput=10.0, memory_overhead=40,
               imbalance=0.1)
    assert contracts.row_violations("pkg", dict(row), row) == []
    assert contracts.row_violations("fish", dict(row), row) == []
    near = dict(row, execution_time=10.002, memory_overhead=41)
    assert contracts.row_violations("fish", near, row) == []
    bad = contracts.row_violations("pkg", near, row)
    assert len(bad) == 2 and bad[0].startswith("memory_overhead")
    far = dict(row, execution_time=11.0, imbalance=0.2, n_tuples=99)
    assert len(contracts.row_violations("dc", far, row)) == 3
    assert contracts.band_violations(dict(row, latency_p99=20.0), row) == []
    assert contracts.band_violations(dict(row, latency_p99=20.1), row)


# ---------------------------------------------------------------------------
# the launch budget (tests/test_fused_engine.py's retrace case)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_auditor_launch_budget_mixed_batch_sizes(scheme, stream):
    keys, values = stream
    sizes = (900, 1_500, 64, 700, 1_500, 900, 2_000, 64)
    sess = _open(PT, scheme, device=CPU)
    batches = _mixed_batches(PT, keys, values, sizes)
    sess.feed(batches[0])  # warm-up: creates the runner, pins kcap
    runner = sess._st["source->agg"].state.device
    assert runner is not None and not EdgeAuditor(runner).on_card
    before = _zero_launches()
    n_kernels = len(contracts.SEGMENT_KERNELS[scheme]) + 1
    with LaunchBudget(n_kernels * (len(sizes) - 1), what="mixed sweep"):
        with EdgeAuditor(runner) as aud:
            for b in batches[1:]:
                sess.feed(b)
    aud.assert_launch_budget()
    assert aud.dispatches == len(sizes) - 1  # no panes, no events
    assert [e.tuples for e in aud.events if e.kind == "segment"] == \
        list(sizes[1:])
    want = {("tracker_update" if k == "tracker_segment" else k):
            len(sizes) - 1 for k in contracts.SEGMENT_KERNELS[scheme]}
    want["pane_update"] = len(sizes) - 1
    assert aud.totals("calls") == want
    assert aud.totals() == {}  # the plain versions launch nothing
    assert _zero_launches() == before
    sess.close()


def test_launch_budget_guard(stream):
    keys, values = stream
    sess = _open(PT, "pkg", device=CPU)
    batches = _mixed_batches(PT, keys, values, (500, 500, 500))
    sess.feed(batches[0])
    with LaunchBudget(4, what="one PKG segment") as lb:
        sess.feed(batches[1])
    assert lb.calls == 4 and lb.launches == 0
    with pytest.raises(AssertionError, match="launches > budget"):
        with LaunchBudget(3, what="guarded feed"):
            sess.feed(batches[2])
    sess.close()


def test_auditor_flags_launches_off_the_budget():
    class _Stub:
        scheme = "pkg"
        device = None
        begin_feed = run_segment = flush_pane = host_sync = \
            refresh_membership = staticmethod(lambda *a, **k: None)

    with EdgeAuditor(_Stub()) as aud:
        aud.runner.host_sync(None)
        aud.runner.run_segment(None, None, 0, 8)
    aud.events[0].calls = {"fifo_workers": 1}  # a launch in a sync
    with pytest.raises(AssertionError, match="none allowed"):
        aud.assert_launch_budget()
    aud.events[0].calls = {}
    # a PKG segment that called nothing is short of its four kernels
    with pytest.raises(AssertionError, match="wrapper calls"):
        aud.assert_launch_budget()
    aud.events[1].calls = {"ring_rows": 1, "route_scan": 1,
                           "fifo_workers": 1, "pane_update": 1}
    aud.assert_launch_budget()
    aud.events[1].launches = {"route_scan": 1}  # a launch on the CPU
    with pytest.raises(AssertionError, match="CPU"):
        aud.assert_launch_budget()


def test_auditor_rejects_unknown_sync_context():
    class _Stub:
        begin_feed = run_segment = flush_pane = host_sync = \
            refresh_membership = staticmethod(lambda *a, **k: None)

    with EdgeAuditor(_Stub()) as aud:
        with pytest.raises(ValueError, match="unknown sync context"):
            with aud.expect("metrics"):
                pass


# ---------------------------------------------------------------------------
# the sync budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["array", "device"])
def test_auditor_sync_budget_pane_boundaries(backend, stream):
    keys, values = stream

    def run(T, Auditor, **kw):
        op = T.WindowOp(agg="sum", value="payload", size=1_500,
                        backend=backend)
        sess = _open(T, "fg", op, **kw)
        src = T.Source(keys, arrival_rate=RATE, values=values)
        feeds = list(src.iter_batches(batch_size=1_500))
        sess.feed(feeds[0])
        runner = sess._st["source->agg"].state.device
        with Auditor(runner, pane_stride=1_500) as aud:
            for b in feeds[1:]:
                sess.feed(b)
            with aud.expect("close"):
                rep = sess.close()
        aud.assert_sync_budget(closed=True)
        return aud, rep, len(feeds)

    # the reference's host stores only: its device store is the JAX one
    aud, rep, n_feeds = run(PT, EdgeAuditor, device=CPU)
    aud.assert_launch_budget()
    assert aud.dispatches == n_feeds - 1
    assert rep.edges[0].n_tuples == keys.shape[0]
    flushes = [e for e in aud.events
               if e.kind == "flush_pane" and e.context == "feed"]
    assert flushes and all(e.offset % 1_500 == 0 for e in flushes)
    probes = aud.totals("calls").get("store_probe_grouped", 0)
    n_syncs = sum(1 for e in aud.events if e.kind == "flush_pane"
                  and e.calls)
    assert probes == (n_syncs if backend == "device" else 0)
    if backend == "device":
        assert probes >= n_feeds - 1  # one grouped probe per pane sync
    if backend == "array":
        raud, _, _ = run(RT, RAuditor)
        assert _trail(aud) == _trail(raud)


@pytest.mark.parametrize("scheme", ["pkg", "fish"])
def test_auditor_budgets_across_membership_events(scheme, stream):
    """Scale out (a new worker lane) and back in inside an open pane: the
    runner's w1 grows, refresh_membership launches nothing, every sync
    sits at a pane boundary or inside the declared event feeds, and the
    call sequence is the reference auditor's."""
    keys, values = stream

    def run(T, C, Auditor, **kw):
        op = T.WindowOp(agg="sum", value="payload", size=1_000,
                        backend="array")
        sess = _open(T, scheme, op, **kw)
        sess.advance([
            T.ScopedEvent("agg", C.MembershipEvent(
                at=2_500, workers=tuple(range(9)))),
            T.ScopedEvent("agg", C.MembershipEvent(
                at=3_700, workers=tuple(range(7)))),
            T.ScopedEvent("agg", C.CapacityEvent(
                at=4_600, capacities={0: 8e-4}))])
        src = T.Source(keys, arrival_rate=RATE, values=values)
        feeds = list(src.iter_batches(batch_size=1_000))
        sess.feed(feeds[0])
        runner = sess._st["source->agg"].state.device
        with Auditor(runner, pane_stride=1_000) as aud:
            for i, b in enumerate(feeds[1:], start=1):
                if i in (2, 3, 4):  # the feeds holding the events
                    with aud.expect("event"):
                        sess.feed(b)
                else:
                    sess.feed(b)
            with aud.expect("close"):
                rep = sess.close()
        aud.assert_sync_budget(closed=True)
        return aud, rep

    import repro.core as RC
    import repro_torch.core as PC

    aud, rep = run(PT, PC, EdgeAuditor, device=CPU)
    aud.assert_launch_budget()
    lanes = [e.w1 for e in aud.events if e.kind == "begin_feed"]
    assert lanes[0] == 9 and lanes[-1] == 10  # 8 workers + 1 phantom, +1
    assert aud.count("refresh_membership") >= 2
    assert all(not e.calls for e in aud.events
               if e.kind == "refresh_membership")
    assert aud.dispatches > len(range(0, 6_000, 1_000)) - 1  # event cuts
    raud, rrep = run(RT, RC, RAuditor)
    assert _trail(aud) == _trail(raud)
    assert rep.state["agg"]["merged"] == rrep.state["agg"]["merged"]
    assert len(rep.edges[0].remap_events) == 2


# ---------------------------------------------------------------------------
# the sanitizer (tests/test_sanitize.py)
# ---------------------------------------------------------------------------


def test_diff_identical_nested():
    v = {"a": [1.0, 2, "x"], "b": {"c": (3.5, float("nan"))}}
    assert diff_values(v, dict(v)) == []


def test_diff_floats_bitwise():
    assert diff_values(0.0, -0.0) != []
    assert diff_values(float("nan"), float("nan")) == []
    assert diff_values(1.0, 1.0 + 1e-16) == []
    d = diff_values(1.0, 1.0 + 2 ** -52)
    assert len(d) == 1 and "bitwise" in d[0]


def test_diff_reports_key_and_length_mismatches():
    d = diff_values({"a": 1, "b": 2}, {"a": 1, "c": 3})
    assert sorted(d) == ["report.b: only in first run",
                         "report.c: only in second run"]
    assert diff_values([1, 2], [1, 2, 3]) == ["report: length 2 != 3"]
    assert diff_values({"x": [1, 9]}, {"x": [1, 8]}) == \
        ["report.x[1]: 9 != 8"]


def test_diff_arrays_exact():
    a = np.array([1.0, float("nan")])
    assert diff_values(a, a.copy()) == []
    assert diff_values(a, a.astype(np.float32)) == \
        ["report: dtype float64 != float32"]
    assert diff_values(np.arange(3), np.arange(4)) == \
        ["report: shape (3,) != (4,)"]
    assert diff_values(np.array([1, 2, 3]), np.array([1, 5, 3])) == \
        ["report: arrays differ at 1 element(s)"]


def test_diff_normalizes_numpy_scalars_and_types():
    assert diff_values(np.int64(3), 3) == []
    assert diff_values(np.float64(2.5), 2.5) == []
    assert diff_values(np.int64(3), 4) != []
    assert diff_values(1, 1.0) == ["report: type int != float"]


def test_diff_reports_uses_to_dict():
    class R:
        def __init__(self, x):
            self.x = x

        def to_dict(self):
            return {"x": self.x}

    assert diff_reports(R(1), R(1)) == []
    assert diff_reports(R(1), R(2)) == ["report.x: 1 != 2"]


def test_sanitized_raises_on_numpy_faults_and_restores():
    before = np.geterr()
    with sanitized():
        assert ff.FINITE_CHECK["depth"] == 1
        with pytest.raises(FloatingPointError):
            np.float64(1.0) / np.float64(0.0)
    assert np.geterr() == before
    assert ff.FINITE_CHECK["depth"] == 0
    assert math.isinf(np.float64(1.0) / np.float64(0.0))
    with pytest.raises(RuntimeError):
        with sanitized():
            raise RuntimeError("boom")
    assert np.geterr() == before and ff.FINITE_CHECK["depth"] == 0


def test_sanitized_checks_the_runner_readbacks(stream, monkeypatch):
    """A NaN finish time coming back from the device raises under
    ``sanitized()`` where run_segment reads it back; without the context
    the same run goes through unchecked."""
    keys, _ = stream
    real = ff.fifo_workers

    def poisoned(*a, **k):
        workers, fin = real(*a, **k)
        return workers, fin * float("nan")

    monkeypatch.setattr(ff, "fifo_workers", poisoned)

    def run():
        return PT.SimulatorEngine(mode="fused", device=CPU).run(
            _topo(PT, "sg"), PT.Source(keys[:2_000], arrival_rate=RATE))

    with sanitized():
        with pytest.raises(FloatingPointError, match="run_segment"):
            run()
    assert run().edges[0].n_tuples == 2_000


@pytest.mark.parametrize("scheme", ["pkg", "fish"])
def test_double_run_fused_bit_identical(scheme, stream):
    keys, values = stream
    events = [PT.ScopedEvent("agg", MembershipEvent(
        at=3_000, workers=tuple(range(6))))]

    def fused():
        op = PT.WindowOp(agg="sum", value="payload", size=1_500,
                         backend="device")
        return PT.SimulatorEngine(mode="fused", seed=3, device=CPU).run(
            _topo(PT, scheme, op),
            PT.Source(keys, arrival_rate=RATE, values=values), events)

    r1, r2, divergences = double_run(fused)
    assert divergences == []
    assert r1 is not r2


def test_double_run_serving_bit_identical(stream):
    keys, _ = stream

    def serving():
        return PT.ServingTopologyEngine(max_requests=16).run(
            _topo(PT, "pkg"), PT.Source(keys, arrival_rate=RATE))

    assert double_run(serving)[2] == []


def test_double_run_surfaces_nondeterminism():
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        return {"latency_p99": 1.0 + state["n"] * 2 ** -52}

    divergences = double_run(flaky)[2]
    assert len(divergences) == 1
    assert divergences[0].startswith("report.latency_p99:")


# ---------------------------------------------------------------------------
# chrome trace export, the streaming writer and the CLI (tests/test_obs.py)
# ---------------------------------------------------------------------------


def _traced(stream, scheme, label, mode="fused"):
    keys, _ = stream
    tel = Telemetry(enabled=True, label=label)
    kw = {"device": CPU} if mode == "fused" else {}
    sess = PT.SimulatorEngine(mode=mode, **kw).open(
        _topo(PT, scheme), arrival_rate=RATE, telemetry=tel)
    for b in PT.Source(keys, arrival_rate=RATE).iter_batches(
            batch_size=2_000):
        sess.feed(b)
    sess.close()
    return tel


def test_chrome_trace_schema_valid(stream):
    tel = _traced(stream, "fish", "schema")
    trace = tel.chrome_trace()
    assert validate_chrome_trace(trace) == []
    assert {"M", "X"} <= {ev["ph"] for ev in trace["traceEvents"]}
    spans = summarize_trace(trace)["spans"]
    for name in ("session.feed", "fused.segment", "fused.segment.launch"):
        s = spans[name]
        assert s["count"] >= 1 and 0.0 <= s["p50_ms"] <= s["max_ms"]
    bad = {"traceEvents": [{"name": "x", "ph": "Z", "pid": 1}]}
    assert validate_chrome_trace(bad)


def test_trace_summary_matches_reference(stream):
    """A telemetry-on batched session in both packages: the reference's
    spans by name and count, counter tracks, instants and metrics.  The
    port adds spans around the open and inside the close that the
    reference has not."""
    from repro.obs.cli import summarize_trace as ref_summarize
    from repro.obs.telemetry import Telemetry as RefTelemetry

    keys, _ = stream

    def run(T, Tel):
        tel = Tel(enabled=True, label="parity")
        sess = T.SimulatorEngine(mode="batched").open(
            _topo(T, "fish"), arrival_rate=RATE, telemetry=tel)
        for b in T.Source(keys, arrival_rate=RATE).iter_batches(
                batch_size=2_000):
            sess.feed(b)
        sess.close()
        return tel.chrome_trace()

    got, want = summarize_trace(run(PT, Telemetry)), \
        ref_summarize(run(RT, RefTelemetry))
    got_n = {k: v["count"] for k, v in got["spans"].items()}
    want_n = {k: v["count"] for k, v in want["spans"].items()}
    assert {k: got_n.get(k) for k in want_n} == want_n
    assert set(got_n) - set(want_n) == {"session.open",
                                        "session.edge_metrics",
                                        "session.percentiles"}
    assert sorted(got["counters"]) == sorted(want["counters"])
    assert got["instants"] == want["instants"]
    assert got["metrics"] == want["metrics"]


def test_trace_writer_abort_seals_valid_json(tmp_path):
    path = tmp_path / "run.trace.json"
    w = TraceWriter(str(path))
    w.write_event({"name": "a", "ph": "i", "ts": 0.0, "pid": 1, "s": "p"})
    w.abort("died mid-run")
    obj = json.loads(path.read_text())
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"]["aborted"] is True
    assert obj["otherData"]["abort_reason"] == "died mid-run"
    assert w.abort() is None
    path2 = tmp_path / "boom.trace.json"
    with pytest.raises(RuntimeError):
        with TraceWriter(str(path2)) as w2:
            w2.write_event({"name": "b", "ph": "i", "ts": 0.0, "pid": 1})
            raise RuntimeError("boom")
    obj2 = json.loads(path2.read_text())
    assert validate_chrome_trace(obj2) == []
    assert obj2["otherData"]["aborted"] is True


def test_trace_writer_failure_flushes_partial_trace(tmp_path, stream):
    tel = _traced(stream, "pkg", "partial")
    path = tmp_path / "failing.trace.json"
    w = TraceWriter(str(path))
    w.write_telemetry(tel)
    w.abort("synthetic")
    obj = json.loads(path.read_text())
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"]["aborted"] is True
    assert any(ev.get("name") == "fused.segment" for ev in obj["traceEvents"])
    assert not (tmp_path / "failing.trace.json.tmp").exists()


def test_cli_summarize_diff_validate(tmp_path, capsys, stream):
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _traced(stream, "fish", "a").save(pa)
    _traced(stream, "pkg", "b", mode="batched").save(pb)
    assert obs_main(["validate", pa]) == 0
    capsys.readouterr()
    assert obs_main(["summarize", pa, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["label"] == "a" and summary["spans"]["session.feed"]
    assert obs_main(["summarize", pa]) == 0
    assert "p50 ms" in capsys.readouterr().out
    assert obs_main(["diff", pa, pb, "--json"]) == 0
    diff = json.loads(capsys.readouterr().out)
    assert diff["a"] == "a" and diff["b"] == "b"
    assert "session.feeds" in diff["metrics"]
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "Q", "pid": 1}]}')
    assert obs_main(["validate", str(bad)]) == 1
