"""What tracing costs, and where the port's spans put the host's time.

    python3 streambench/tracecost.py --workload <name> --seed <n> \\
        --seconds <s> --mode off|port|full

Runs one cell's window as ``run.py`` does, in one of three modes:
``off`` untraced (``run.py --trace 0``); ``port`` under the port's own
tracer alone, with neither ``torch.profiler`` nor the benchmark's wrapper
ranges; ``full`` traced as ``run.py --trace 1`` runs it.  Comparing the
modes' ``tuples_per_s`` on one seed gives the cost of the port's tracer
(``port`` against ``off``) and of the profiler and ranges besides
(``full`` against ``port``).

The last line of standard output is one JSON object: ``mode``,
``correct``, ``metrics`` (the cell's end-to-end metrics in every mode;
with ``port`` also the per-layer metrics that read the port's spans and
counters alone, with ``full`` all of them) and ``spans``, per span name
its count and summed seconds.  A child span's share of its parent is read
from ``spans``: e.g. ``state.flush_windows`` over
``state.feed_aggregated``, or ``state.report`` over ``session.close``.
Without a card the run exits 2, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import driver  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402
import tracing  # noqa: E402

MODES = ("off", "port", "full")
#: the sources a ``port`` run can read: no device trace is taken
PORT_SOURCES = ("program_span", "program_counter")


class PortOnly:
    """The port's tracer for the window, without the profiler or the
    benchmark's ranges: ``tracing.Tracing``'s interface, whose trace holds
    the spans alone and spans the window with them."""

    def __init__(self, torch):
        from repro_torch.obs import Telemetry

        self.telemetry = Telemetry(enabled=True, label="streambench")

    def mark(self, name: str):
        return contextlib.nullcontext()

    def window(self):
        return contextlib.nullcontext()

    def read(self) -> dict:
        spans = [(s.name, s.t0, s.t1) for s in self.telemetry.tracer.spans]
        window = ((min(s[1] for s in spans), max(s[2] for s in spans))
                  if spans else (0.0, 0.0))
        return dict(device=[], ranges=[], window=window, spans=spans)


def span_table(spans) -> dict:
    """Per span name: [count, summed seconds], largest sum first."""
    out = {}
    for name, t0, t1 in spans:
        row = out.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += t1 - t0
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def measure(cell, seed: int, seconds: float, mode: str, device: str,
            tuples: int = 0, t_start: float = T_START) -> dict:
    """One window of ``cell`` in ``mode`` (see the module's docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    recs, traces = [], []
    real_window, real_tracing = driver.run_window, tracing.Tracing

    def keep_window(*a, **k):
        recs.append(real_window(*a, **k))
        return recs[-1]

    class Kept(PortOnly if mode == "port" else real_tracing):
        def read(self):
            traces.append(super().read())
            return traces[-1]

    driver.run_window, tracing.Tracing = keep_window, Kept
    try:
        res = run.run_cell(cell, seed, seconds, mode != "off", device,
                           tuples=tuples, t_start=t_start)
    finally:
        driver.run_window, tracing.Tracing = real_window, real_tracing
    if res is None:
        return None
    metrics = res["metrics"]
    if mode != "off":
        ctx = dict(rec=recs[-1])
        for m in cell.end_to_end:
            if m["name"] in ("tuples_per_s", "feed_p99_ms"):
                value = spec.load_reader(m["name"]).read(ctx)
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    if mode == "port":
        keep = {m["name"] for m in cell.per_layer
                if m["source"] in PORT_SOURCES} | \
            {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in keep}
    return {"mode": mode, "correct": res["correct"], "metrics": metrics,
            "spans": span_table(traces[-1]["spans"]) if traces else {}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(spec.ROOT / "build"
                                              / "repro_torch")
    import torch

    if not torch.cuda.is_available():
        run.log("streambench: no CUDA device; the benchmark runs on the "
                "card only")
        return 2
    if run.import_port() is None:
        return 2
    out = measure(cell, args.seed, args.seconds, args.mode, "cuda")
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
