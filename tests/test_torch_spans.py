"""The port's spans on the CPU: their clock against ``torch.profiler``'s,
the spans of a fused session (its open, the edge driver, runner waits,
the state layer's flush, the close), and the disabled path.

The fused runner runs on ``device="cpu"`` (the kernels' plain versions).
"""

import collections
import types

import numpy as np
import pytest
import torch

import repro_torch.topology as PT
from repro_torch.kernels import feed_fused as ff
from repro_torch.obs import NULL_TRACER, Telemetry, Tracer

from torch_helpers import CPU, one_stage, zf_stream

RATE = 2e4
FEED = 1_000


@pytest.fixture(scope="module")
def stream():
    return zf_stream(3_000, num_keys=400)


def _session(stream, scheme, tel):
    keys, values = stream
    op = PT.WindowOp(agg="sum", value="payload", size=700, backend="device")
    sess = PT.SimulatorEngine(mode="fused", device=CPU).open(
        one_stage(PT, scheme, op), arrival_rate=RATE, telemetry=tel)
    ts = np.arange(keys.shape[0]) / RATE
    for lo in range(0, keys.shape[0], FEED):
        sess.feed(PT.RecordBatch(keys[lo:lo + FEED], ts[lo:lo + FEED],
                                 values[lo:lo + FEED]))
    return sess.close().to_dict()


def test_port_spans_enclose_profiler_ranges():
    """A span of the port's tracer around a ``record_function`` range
    holds the range's kineto start and end, within 1 ms each side: both
    stamp the Unix-epoch axis."""
    tr = Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            with tr.span("outer"):
                with torch.profiler.record_function("inner"):
                    torch.ones(256).cumsum(0)
    ranges = sorted((ev.start_ns() * 1e-9,
                     (ev.start_ns() + ev.duration_ns()) * 1e-9)
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "inner")
    assert len(ranges) == len(tr.spans) == 8
    for (r0, r1), sp in zip(ranges, tr.spans):
        assert sp.t0 - 1e-3 <= r0 <= r1 <= sp.t1 + 1e-3
        assert r0 - sp.t0 < 0.05  # the same instant, not merely ordered


@pytest.mark.parametrize("scheme", ["fish", "fg"])
def test_fused_session_emits_the_new_spans(stream, scheme):
    tel = Telemetry(enabled=True)
    _session(stream, scheme, tel)
    spans = tel.tracer.spans
    n = collections.Counter(s.name for s in spans)
    assert n["session.feed"] == 3 and n["edge.fused"] == 3
    assert n["fused.segment"] >= 3
    assert n["fused.segment.wait"] == n["fused.segment"]
    assert n["fused.pane_flush"] >= 3
    assert n["state.feed_aggregated"] == n["fused.pane_flush"]
    assert n["fused.pane_flush.wait"] == n["fused.pane_flush"]
    assert n["state.merge_many"] == n["state.merge_many.upload"] >= 1
    assert n["state.flush_windows"] >= 1
    for name in ("session.open", "session.close", "state.finalize",
                 "state.report", "session.edge_metrics",
                 "session.percentiles"):
        assert n[name] == 1, name
    opened = next(s for s in spans if s.name == "session.open")
    assert opened.t1 <= min(s.t0 for s in spans if s.name != "session.open")

    def inside(child, parent):
        outer = [s for s in spans if s.name == parent]
        for c in (s for s in spans if s.name == child):
            assert any(p.t0 <= c.t0 <= c.t1 <= p.t1 for p in outer), child

    inside("edge.fused", "session.feed")
    inside("fused.segment.wait", "fused.segment")
    inside("fused.pane_flush.wait", "fused.pane_flush")
    inside("state.merge_many.upload", "state.merge_many")
    for child in ("state.finalize", "state.report", "session.edge_metrics",
                  "session.percentiles"):
        inside(child, "session.close")
    # each pane is synced once, into stores that are all fresh: every sync
    # puts all its stores on one slab, and every window flush reads its
    # one pane's slab back in one copy
    merges = [s.args for s in spans if s.name == "state.merge_many"]
    assert all(m["slab"] == m["stores"] > 0 for m in merges)
    flushes = [s.args for s in spans if s.name == "state.flush_windows"]
    assert all(f["readbacks"] == 1 and f["stores"] > 0 for f in flushes)


def test_disabled_session_emits_nothing_and_reports_the_same(stream):
    on = Telemetry(enabled=True)
    off = Telemetry(enabled=False)
    rep_on = _session(stream, "fish", on)
    rep_off = _session(stream, "fish", off)
    rep_default = _session(stream, "fish", None)
    assert off.tracer is NULL_TRACER and NULL_TRACER.spans == []
    assert rep_on.pop("timeline") is not None
    assert rep_off == rep_on == rep_default


@pytest.mark.parametrize("enabled", [False, True])
def test_device_wait_synchronizes_only_when_traced(monkeypatch, enabled):
    """The runner's wait spans: a synchronize of the current stream under
    an enabled tracer, and neither span nor synchronize without one."""
    syncs = []
    fake_stream = types.SimpleNamespace(
        synchronize=lambda: syncs.append(1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: fake_stream)
    tel = Telemetry(enabled=enabled)
    runner = types.SimpleNamespace(tel=tel, device=torch.device("cuda"))
    ff.FusedEdgeRunner._wait(runner, "fused.segment.wait")
    assert len(syncs) == int(enabled)
    assert [s.name for s in tel.tracer.spans] == \
        ["fused.segment.wait"] * int(enabled)


def _feed_spans(spans):
    return sorted((s for s in spans if s.name == "session.feed"),
                  key=lambda s: s.t0)


@pytest.mark.parametrize("scheme,dmax", [("fish", 8), ("fg", 1)])
def test_ring_table_span_and_counter_at_each_first_feed(stream, scheme, dmax,
                                                        monkeypatch):
    """Two sessions on one bundle: one ``fused.ring_table`` span each,
    inside ``fused.refresh_membership`` of the session's first feed, and
    ``fused.ring_table.entries`` the rows x ``dmax`` of the tables built."""
    built = []
    real = ff._build_ring_table

    def spy(ring, d):
        pts, cands = real(ring, d)
        built.append((pts.shape[0], d))
        return pts, cands

    monkeypatch.setattr(ff, "_build_ring_table", spy)
    tel = Telemetry(enabled=True)
    for _ in range(2):
        _session(stream, scheme, tel)
    spans = tel.tracer.spans
    tables = [s for s in spans if s.name == "fused.ring_table"]
    refresh = [s for s in spans if s.name == "fused.refresh_membership"]
    feeds = _feed_spans(spans)
    assert len(tables) == len(refresh) == len(built) == 2
    assert [d for _, d in built] == [dmax, dmax] and built[0][0] > 0
    for t, first in zip(tables, (feeds[0], feeds[3])):
        assert first.t0 <= t.t0 <= t.t1 <= first.t1
        assert any(p.t0 <= t.t0 <= t.t1 <= p.t1 for p in refresh)
    entries = tel.metrics.snapshot()["fused.ring_table.entries"]["value"]
    assert entries == sum(r * d for r, d in built)


def _bench_reader(name):
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "streambench"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    import spec

    return spec.load_reader(name)


#: one feed as the runner spans it: the membership refresh inside the
#: first ``fused.begin_feed``, a segment with its wait, a pane flush
_ONE_FEED = [("session.feed", 0.0, 10.0), ("edge.fused", 1.0, 9.0),
             ("fused.begin_feed", 1.5, 3.5),
             ("fused.refresh_membership", 1.6, 3.2),
             ("fused.segment", 4.0, 6.0), ("fused.segment.prep", 4.0, 4.5),
             ("fused.segment.launch", 4.5, 5.0),
             ("fused.segment.wait", 5.0, 6.0),
             ("fused.pane_flush", 7.0, 8.0)]


@pytest.mark.parametrize("name", ["session_self_ms_per_feed",
                                  "runner_host_ms_per_feed",
                                  "edge_self_ms_per_feed"])
def test_readers_of_fused_children_ignore_the_ring_table_span(stream, name):
    """The new span nests inside ``fused.refresh_membership``: readers that
    sum ``fused.begin_feed`` or subtract ``fused.*`` children read the
    same with and without it, on hand-built spans and a session's."""
    reader = _bench_reader(name)

    def read(spans):
        return reader.read(dict(trace=dict(spans=spans), rec={}))

    child = ("fused.ring_table", 1.7, 3.0)
    assert read(_ONE_FEED) == read(_ONE_FEED + [child])
    tel = Telemetry(enabled=True)
    _session(stream, "fish", tel)
    spans = [(s.name, s.t0, s.t1) for s in tel.tracer.spans]
    assert any(s[0] == "fused.ring_table" for s in spans)
    # a stamp shared by two span starts may reorder the sum's terms
    assert read(spans) == pytest.approx(
        read([s for s in spans if s[0] != "fused.ring_table"]),
        rel=1e-12, abs=1e-12)
