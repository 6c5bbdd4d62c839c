"""Tests of the benchmark under ``streambench/``, on the CPU (the port's
kernels' plain versions, ``device="cpu"``) at a few feeds of each stream.

    python -m pytest -q streambench/test_streambench.py

The one ``cuda``-marked test runs a short cell on the card and skips
elsewhere (decided inside the test).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import check  # noqa: E402
import driver  # noqa: E402
import reference as R  # noqa: E402
import roofline  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402
import streams  # noqa: E402

FEED = 16_384
CELLS = ("zf128.fish.closed", "amazon128.fish.flush", "zf128.fg.closed")
#: the open-loop cell and its metrics, kept out of ``BENCHMARK.json`` while
#: its tail swings more than a bound can hold (PERF.md §7); its traffic
#: file and readers stay, and are held working here
OPEN = {
    "workload": {"name": "zf128.fish.open", "config": "zf128",
                 "traffic": "fish.open", "chips": 1,
                 "why": "FISH over the ZF stream, open loop"},
    "end_to_end": [{"name": "latency_p99_ms", "unit": "ms",
                    "better": "lower", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["zf128.fish.open"]}],
    "per_layer": [
        {"name": "device_idle_pct.open", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "latency_p99_ms", "workloads": ["zf128.fish.open"]},
        {"name": "feed_start_late_p99_ms.open", "unit": "ms",
         "better": "lower", "source": "host_clock", "layer": "load driver",
         "moves": "latency_p99_ms", "workloads": ["zf128.fish.open"]}]}


def _cell(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if name == OPEN["workload"]["name"]:
        bench["workloads"].append(OPEN["workload"])
        bench["end_to_end"] += OPEN["end_to_end"]
        bench["per_layer"] += OPEN["per_layer"]
    return spec.Cell(bench, name)


def _run(cell, seed, feeds=4, seconds=0.2, trace=False, control=False):
    return run.run_cell(_cell(cell), seed, seconds, trace, "cpu",
                        tuples=feeds * FEED, control=control)


def _over(table):
    return {k: v["value"] for k, v in table.items()
            if v["value"] > v["limit"]}


# -- the reference against the port ------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_on_every_feed(cell, monkeypatch):
    """Every feed of two cycles compared, from the port's state before it:
    routing, finish times, state after, windows and the close report."""
    monkeypatch.setattr(driver.SamplePlan, "want", lambda *a: True)
    res = _run(cell, 20261017, feeds=5, seconds=0.01)
    assert res["correct"], _over(res["checks"])
    assert res["attempted"] >= 5


def test_reference_from_fresh_state_follows_a_whole_stream():
    """The reference alone, from a fresh state, through six feeds of the
    port: the state it carries from feed to feed is the port's."""
    import repro_torch.topology as T

    cell = spec.load_cell("zf128.fish.closed")
    stream = streams.make_stream(cell.config, 5, 6 * FEED)
    dep = driver.Deployment(cell.config, cell.traffic, stream, "cpu")
    sess = dep.open()
    model = check.edge_model(cell.config, "fish", stream,
                             R.Ring(128, 64), FEED)
    model.from_state(model.fresh())
    for b in dep.batches:
        assert isinstance(b, T.RecordBatch)
        rec = sess.feed(b)
        workers, fin = model.feed(b.keys, b.timestamps)
        prog = dep.snapshot(sess)
        assert np.array_equal(prog["counts"], model.state["counts"])
        assert np.array_equal(prog["trk"], model.state["trk"])
        assert np.array_equal(prog["mk"], model.state["mk"])
        assert np.array_equal(prog["busy"], model.state["busy"])
        np.testing.assert_allclose(rec.latencies, fin - b.timestamps,
                                   rtol=0, atol=1e-12)
    sess.close()


# -- the whole run, its last line ---------------------------------------------


@pytest.mark.parametrize("cell,trace", [("zf128.fish.open", False),
                                        ("zf128.fish.open", True),
                                        ("zf128.fish.closed", True)])
def test_cpu_rehearsal_prints_the_contract_line(cell, trace):
    res = _run(cell, 2 ** 31 + 12345, trace=trace)
    line = json.loads(json.dumps(res, allow_nan=False))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert ("breakdown" in line) == trace
    names = {m["name"] for m in _cell(cell).metrics(trace)}
    assert set(line["metrics"]) <= names and line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


# -- the control and the faults ---------------------------------------------


@pytest.mark.parametrize("cell,fails", [
    ("zf128.fish.closed", ("route_mismatch", "finish_gap_s")),
    ("zf128.fg.closed", ("finish_gap_s",))])
def test_control_in_the_programs_place_is_not_correct(cell, fails):
    """One precision below the configuration's (float32 clocks, a bfloat16
    tracker) fails the numbers that the sound run passes."""
    res = _run(cell, 77, feeds=5, control=True)
    assert res["correct"], _over(res["checks"])
    over = _over(res["control"])
    assert set(fails) <= set(over), over


def _fault_state_unchanged(monkeypatch, ff, T):
    real = ff.fifo_workers

    def fifo(scheme, m, **kw):
        busy0 = kw["busy"].clone()
        out = real(scheme, m, **kw)
        kw["busy"].copy_(busy0)  # the workers' clocks never advance
        return out

    monkeypatch.setattr(ff, "fifo_workers", fifo)


def _fault_half_batch(monkeypatch, ff, T):
    real = T.SimulatorSession.feed

    def feed(self, batch):
        n = len(batch) // 2
        return real(self, T.RecordBatch(batch.keys[:n], batch.timestamps[:n],
                                        batch.values[:n]))

    monkeypatch.setattr(T.SimulatorSession, "feed", feed)


def _fault_answer_altered(monkeypatch, ff, T):
    real = ff.fifo_workers

    def fifo(scheme, m, **kw):
        workers, fin = real(scheme, m, **kw)
        workers[0] = (workers[0] + 1) % 128  # one tuple's worker changed
        return workers, fin

    monkeypatch.setattr(ff, "fifo_workers", fifo)


@pytest.mark.parametrize("cell", ["zf128.fish.closed", "zf128.fg.closed"])
@pytest.mark.parametrize("fault", [_fault_state_unchanged, _fault_half_batch,
                                   _fault_answer_altered])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import repro_torch.topology as T
    from repro_torch.kernels import feed_fused as ff

    fault(monkeypatch, ff, T)
    res = _run(cell, 31, feeds=5)
    assert not res["correct"]


# -- imports -----------------------------------------------------------------


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import run, spec\n"
        "res = run.run_cell(spec.load_cell('zf128.fish.closed'), 3, 0.1, "
        "False, 'cpu', tuples=32768)\n"
        "print(json.dumps([res is not None, run.forbidden_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(HERE),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=600, check=True)
    ran, found, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert ran and found == []
    assert "repro_torch" in tops and not {"jax", "jaxlib", "flax",
                                          "repro"} & set(tops)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1])\n"
            "import reference, check, streams, roofline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(HERE)],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax", "torch"} & tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


# -- the yardstick's pieces --------------------------------------------------


def test_route_scan_counts_by_hand():
    d = np.array([2, 5, 1])
    # read: keys + values 8*3, candidates 4*8, 2 epochs 8*2, M of 2 keys
    # 4*2, 5 lanes 16*5; written: workers 4*3, M of 1 key 4, lanes 12*5
    assert roofline.route_scan_bytes(3, d, 4, 2, 2, 1) == \
        24 + 32 + 16 + 8 + 80 + 12 + 4 + 60
    assert roofline.route_scan_ops(3, d) == 13 * 3 + 3 * 8
    assert roofline.least_seconds(236, 63) == 236 / 3.35e12


def test_streams_follow_the_seed():
    cfg = spec.load_cell("zf128.fish.closed").config
    a = streams.make_stream(cfg, 2 ** 31 + 7, 50_000)
    b = streams.make_stream(cfg, 2 ** 31 + 7, 50_000)
    c = streams.make_stream(cfg, -3, 50_000)
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.values, b.values)
    assert not np.array_equal(a.keys, c.keys)
    # the ZF flip: the hottest key before 0.8 of the stream is key 0,
    # after it key flip_head - 1
    n1 = int(0.8 * 50_000)
    assert np.bincount(a.keys[:n1]).argmax() == 0
    assert np.bincount(a.keys[n1:]).argmax() == 9_999
    amazon = spec.load_cell("amazon128.fish.flush").config
    s = streams.make_stream(amazon, 1, 60_000)
    heads = [np.bincount(s.keys[lo:lo + 10_000]).argmax()
             for lo in range(0, 60_000, 10_000)]
    assert len(set(heads)) == 6  # a new hot key in each phase


def test_the_sample_plan_keeps_the_first_cycles_ends():
    plan = driver.SamplePlan(streams.seed_sequence(1, 2), 10.0, 3, 8)
    assert plan.want(0, 0, 0.0) and plan.want(0, 7, 0.0)
    assert not plan.want(1, 0, 0.0)
    hits = sum(plan.want(1, k, 10.0 * k / 8) for k in range(1, 9))
    assert 1 <= hits <= 3


def test_benchmark_json_meets_its_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        reader = spec.load_reader(m["name"])
        assert reader.UNIT == m["unit"]
    for m in bench["per_layer"] + OPEN["per_layer"]:
        reader = spec.load_reader(m["name"])
        assert reader.UNIT == m["unit"]
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert cell.chips == 1
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert {m["moves"] for m in cell.per_layer} <= reported
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "zf128.fish.closed", "--seed", "11", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
