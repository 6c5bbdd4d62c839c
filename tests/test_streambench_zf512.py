"""The 512-worker ZF cell, ``zf512.fish.closed``, on the CPU: its files
load, its edge takes ``route_scan``'s shared-memory walk, and a cut
rehearsal with every feed checked against the plain reference is correct.
The harness's modules are loaded from ``streambench/``, as a run loads
them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "streambench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import spec  # noqa: E402

from repro_torch.kernels import feed_fused as ff  # noqa: E402

CELL = "zf512.fish.closed"
FEED = 16_384


def test_zf512_cell_loads_whole():
    cell = spec.load_cell(CELL)
    assert cell.config["name"] == "zf512" and cell.chips == 1
    assert cell.config["workers"] == 512 and cell.config["reduced"] == []
    assert "workers" in cell.config["assumed"]
    assert cell.traffic["scheme"] == "fish"
    assert int(cell.traffic["feed"]) == FEED
    zf128 = spec.load_cell("zf128.fish.closed").config
    for key in ("stream", "groupings", "window", "engine", "guarantees"):
        assert cell.config[key] == zf128[key], key
    assert {m["name"] for m in cell.end_to_end} == {
        "tuples_per_s", "feed_p99_ms", "peak_device_mib", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert {"route_scan_roofline", "ring_table_ms"} <= layer
    assert layer == {m["name"] for m in
                     spec.load_cell("zf128.fish.closed").per_layer}


@pytest.mark.parametrize("pkg", [False, True])  # rows W wide; PKG's 2
@pytest.mark.parametrize("ne", [1, 18])  # epochs a 16k segment spans
def test_zf512_route_scan_takes_the_shared_memory_walk(pkg, ne):
    """The cell's edge (FISH's ``dmax`` is the worker count) is past the
    register chain: the walk, which fits the block."""
    workers = int(spec.load_cell(CELL).config["workers"])
    width = 2 if pkg else workers
    plan = ff._route_scan_plan(workers + 1, ne, width)
    assert plan.path == "smem" and plan.k == 0
    assert plan.smem == ff._route_scan_smem(workers + 1, ne, width)
    assert plan.smem <= ff._SMEM_LIMIT


def test_zf512_rehearsal_is_correct_on_every_feed():
    """Four feeds of the stream through the cell's whole run on the
    kernels' plain versions, every feed held against the reference from
    the port's state before it: every compared number at its limit.  The
    run has a process of its own, as on the card: a run refuses a process
    that holds the JAX package, which other tests load."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1])\n"
            "import driver, run, spec\n"
            "driver.SamplePlan.want = lambda *a: True\n"
            f"res = run.run_cell(spec.load_cell({CELL!r}), 2 ** 31 + 512, "
            f"0.01, False, 'cpu', tuples=4 * {FEED})\n"
            "print(json.dumps(res, allow_nan=False))\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH.parent / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(BENCH)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 4
    over = {k: v["value"] for k, v in res["checks"].items()
            if v["value"] > v["limit"]}
    assert not over, over
    assert {"tuples_per_s", "feed_p99_ms", "setup_s"} <= set(res["metrics"])
