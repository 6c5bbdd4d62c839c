"""The benchmark's readers of the port's spans (``streambench/metrics/``),
on hand-built traced-run contexts with known answers.  Each reader is
loaded by its path, as a run loads it."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "streambench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import spec  # noqa: E402

NEW = ("close_ms", "edge_self_ms_per_feed", "device_wait_ms_per_feed",
       "state_host_ms_per_feed", "idle_outside_spans_pct")
#: the profiler's Unix-epoch axis, where a run's window lies
EPOCH = 1.79e9


def _read(name, spans, device=(), window=(0.0, 40.0)):
    trace = dict(spans=list(spans), device=list(device), ranges=[],
                 window=window)
    return spec.load_reader(name).read(dict(trace=trace, rec={}))


#: two feeds and a close: in each feed the edge driver's span around the
#: runner's (a segment with its nested wait, a pane flush with the state
#: layer's sync inside)
SPANS = [
    ("session.feed", 0.0, 10.0), ("edge.fused", 1.0, 9.0),
    ("fused.segment", 2.0, 4.0), ("fused.segment.wait", 3.0, 4.0),
    ("fused.pane_flush", 5.0, 6.0), ("fused.pane_flush.wait", 5.0, 5.5),
    ("state.feed_aggregated", 5.6, 5.9),
    ("session.feed", 20.0, 30.0), ("edge.fused", 21.0, 29.0),
    ("fused.segment", 22.0, 25.0), ("fused.segment.wait", 24.0, 25.0),
    ("session.close", 31.0, 33.0), ("state.finalize", 31.0, 31.5),
    ("session.close", 34.0, 37.0),
]


@pytest.mark.parametrize("name,want", [
    ("close_ms", 2500.0),               # (2 + 3) s over 2 closes
    ("edge_self_ms_per_feed", 5000.0),  # (8 - 2 - 1) + (8 - 3) s, 2 feeds
    ("device_wait_ms_per_feed", 1250.0),  # (1 + 0.5 + 1) s over 2 feeds
    ("state_host_ms_per_feed", 150.0),  # 0.3 s over 2 feeds
])
def test_span_readers_by_hand(name, want):
    assert _read(name, SPANS) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_a_program_without_the_spans(name):
    """A program with only the older spans (no ``edge.fused``, waits,
    state spans or close children), or none at all: nothing to read,
    never NaN."""
    old = [s for s in SPANS if s[0] in ("session.feed", "fused.segment",
                                        "fused.pane_flush")]
    if name == "idle_outside_spans_pct":
        assert _read(name, []) is None
    else:
        assert _read(name, old) is None
        assert _read(name, []) is None


def _idle_case(shift):
    """A 10 s window with the card busy 2 s of it (8 s idle), and spans
    over 3 s of the idle time, moved by ``shift``."""
    window = (EPOCH, EPOCH + 10.0)
    device = [("k", EPOCH + 0.0, EPOCH + 1.0), ("k", EPOCH + 5.0,
                                                EPOCH + 6.0)]
    spans = [("session.feed", EPOCH + 0.5 + shift, EPOCH + 3.0 + shift),
             ("fused.segment", EPOCH + 2.0 + shift, EPOCH + 2.5 + shift),
             ("session.close", EPOCH + 7.0 + shift, EPOCH + 8.0 + shift)]
    return _read("idle_outside_spans_pct", spans, device, window)


def test_idle_outside_spans_reads_the_exact_share_on_one_clock():
    # idle (1, 5) and (6, 10); spans cover (1, 3) and (7, 8): 3 of 8 s
    assert _idle_case(0.0) == pytest.approx(62.5, abs=1e-5)


def test_idle_outside_spans_reads_100_on_another_clock():
    assert _idle_case(-1.8e9) == 100.0


def test_idle_outside_spans_reads_0_when_spans_cover_all_idle_time():
    window = (EPOCH, EPOCH + 4.0)
    device = [("k", EPOCH + 1.0, EPOCH + 2.0)]
    spans = [("session.feed", EPOCH - 1.0, EPOCH + 5.0)]
    assert _read("idle_outside_spans_pct", spans, device, window) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_new_readers_match_their_benchmark_entries(name):
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    reader = spec.load_reader(name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
        (entry["unit"], entry["layer"], entry["moves"])
    assert {"zf128.fish.closed", "amazon128.fish.flush",
            "zf128.fg.closed"} <= set(entry["workloads"])
    value = _read(name, SPANS, [("k", 0.0, 1.0)])
    assert value is not None and math.isfinite(value)



def test_ring_table_ms_reads_the_mean_build():
    """Two builds of the ring's candidate table, 0.2 and 0.4 s, each inside
    the membership refresh of a session's first feed: 300 ms a build;
    nothing where the program has no such span."""
    builds = [("fused.begin_feed", 1.5, 2.0),
              ("fused.refresh_membership", 1.55, 1.9),
              ("fused.ring_table", 1.6, 1.8),
              ("fused.begin_feed", 21.0, 21.6),
              ("fused.refresh_membership", 21.05, 21.5),
              ("fused.ring_table", 21.05, 21.45)]
    assert _read("ring_table_ms", SPANS + builds) == \
        pytest.approx(300.0, rel=1e-12)
    assert _read("ring_table_ms", SPANS) is None
    assert _read("ring_table_ms", []) is None


def test_ring_table_ms_matches_its_benchmark_entry():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["ring_table_ms"]
    reader = spec.load_reader("ring_table_ms")
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
        (entry["unit"], entry["layer"], entry["moves"])
    assert (entry["source"], entry["better"]) == ("program_span", "lower")
    assert set(entry["workloads"]) == {w["name"] for w in bench["workloads"]}


@pytest.mark.parametrize("mode", ["off", "port", "full"])
def test_tracecost_rehearses_each_mode_on_the_cpu(mode):
    """``tracecost.py`` on a cut stream: every mode correct, with the
    cell's throughput and p99, and the span table of the traced modes
    (the port's own spans in ``port``, no device metric read there).
    Each run has a process of its own, as on the card: a run refuses a
    process that holds the JAX package, and a traced window leaves the
    wrapped methods of the port behind it."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1])\n"
            "import spec, tracecost\n"
            "cell = spec.load_cell('zf128.fish.closed')\n"
            "out = tracecost.measure(cell, 2 ** 31 + 29, 0.2, sys.argv[2], "
            "'cpu', tuples=4 * 16_384)\n"
            "print(json.dumps(out, allow_nan=False))\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH.parent / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(BENCH), mode],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mode"] == mode and out["correct"] is True
    assert {"tuples_per_s", "feed_p99_ms"} <= set(out["metrics"])
    if mode == "off":
        assert out["spans"] == {}
        return
    n = {k: v[0] for k, v in out["spans"].items()}
    assert n["session.open"] == n["session.close"] >= 1
    assert n["edge.fused"] == n["session.feed"] >= 4
    assert n["state.feed_aggregated"] >= 1
    assert "close_ms" in out["metrics"]
    assert ("device_idle_pct" in out["metrics"]) == (mode == "full")
