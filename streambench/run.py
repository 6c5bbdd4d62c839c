"""Run one cell of the port's benchmark once, on the card.

    python3 streambench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic mix
and metrics are found by name from ``BENCHMARK.json`` and the files under
``streambench/`` (see ``spec.py``).  Set-up makes the stream from the seed,
builds the port's kernels (into ``build/repro_torch`` inside the checkout,
once per checkout) and warms every shape the window uses.  The window
feeds whole cycles of the stream for at least ``--seconds`` (``driver.py``);
then the check holds what it produced against the plain reference
(``check.py``).  With ``--trace 1`` the same window runs under the port's
tracer and ``torch.profiler`` and the per-layer metrics are reported.

The last lines of standard error give each compared number beside its
limit; the last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and, last, ``checks``.  Without a card, or
with fewer cards than the cell asks for, or without the port beside it,
the run exits non-zero and prints no result; so it does if JAX or the JAX
package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import spec  # noqa: E402
import streams  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: feeds the check samples at instants drawn over the window, besides the
#: first cycle's first and last feed
SAMPLES = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_port():
    """The port from ``src/`` of this checkout, or None."""
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        log(f"streambench: the port is not importable here ({e})")
        return None
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        log(f"streambench: repro_torch comes from {repro_torch.__file__}, "
            f"not from {src}")
        return None
    return repro_torch


def warm(dep, sync) -> None:
    """Every shape the window uses, once: full feeds through a pane flush
    and a close, on a session of its own."""
    n = int(dep.config["window"]["size"]) // int(dep.traffic["feed"]) + 1
    sess = dep.open()
    for b in dep.batches[:max(2, n)]:
        sess.feed(b)
        sync()
    sess.close()
    sync()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             tuples: int = 0, t_start: float = T_START,
             control: bool = False):
    """Set-up, the window and the check of one run.  Returns the result
    object, or None when a forbidden module was loaded.  ``tuples`` cuts
    the stream (CPU rehearsals only); ``control`` adds the control's
    numbers on the same feeds under ``"control"`` (``control.py``)."""
    import numpy as np
    import torch

    import check
    import driver
    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import store_probe as sp

    warnings.filterwarnings("error", message="simulate_edge falling back")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stream = streams.make_stream(cell.config, seed, tuples)
    dep = driver.Deployment(cell.config, cell.traffic, stream, device)
    capture = driver.Capture(ff)
    tr = None
    try:
        warm(dep, sync)
        if trace:
            import tracing
            tr = tracing.Tracing(torch)
        plan = driver.SamplePlan(streams.seed_sequence(seed, 2), seconds,
                                 SAMPLES, len(dep.batches))
        launches0 = dict(ff.LAUNCHES, **sp.LAUNCHES)
        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        with (tr.window() if tr else contextlib.nullcontext()):
            rec = driver.run_window(
                dep, seconds, plan, capture, sync,
                telemetry=tr.telemetry if tr else None,
                mark=tr.mark if tr else None,
                counter=lambda: ff.LAUNCHES["route_scan"])
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        capture.remove()
    rec["launches"] = {k: v - launches0[k]
                       for k, v in dict(ff.LAUNCHES, **sp.LAUNCHES).items()}
    rec["launch0_route_scan"] = launches0["route_scan"]
    found = forbidden_modules()
    if found:
        log(f"streambench: forbidden modules loaded: {', '.join(found)}")
        return None
    trace_data = tr.read() if tr else None
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = check.compare(cell.config, dep.scheme, stream, rec,
                            int(cell.traffic["feed"]))
    limits = dict(check.LIMITS, **cell.config.get("limits", {}))
    correct, table = check.check_lines(numbers, limits)
    lowered = (check.compare(cell.config, dep.scheme, stream, rec,
                             int(cell.traffic["feed"]),
                             precision=check.R.Precision().lower())
               if control else None)
    ctx = dict(rec=rec, setup_s=setup_s, peak_bytes=peak, trace=trace_data,
               config=cell.config, traffic=cell.traffic)
    metrics = {}
    for m in cell.metrics(trace):
        reader = spec.load_reader(m["name"])
        if reader.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: reader unit "
                             f"{reader.UNIT!r} != {m['unit']!r}")
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    walls = np.asarray([f[4] - f[3] for f in rec["feeds"]])
    log(f"card: {card_line() if cuda else 'none (cpu)'}")
    log(f"window: {rec['window_s']:.3f} s, {rec['cycles']} cycles, "
        f"{len(rec['feeds'])} feeds ({walls.size} samples for each feed "
        f"percentile), {rec['tuples']} tuples, {numbers['samples']} feeds "
        f"checked, set-up {setup_s:.3f} s")
    ends = [0.0] + rec["cycle_ends"]
    log("cycles: " + " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:]))
        + " s")
    result = {"correct": bool(correct), "attempted": len(rec["feeds"]),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_data is not None:
        import tracing
        w0, w1 = trace_data["window"]
        dev["busy_s"] = tracing.busy_seconds(trace_data)
        dev["window_s"] = w1 - w0
        result["breakdown"] = tracing.breakdown(trace_data)
    if lowered is not None:
        result["control"] = check.check_lines(lowered, limits)[1]
    result["checks"] = table
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    # the port's kernels build inside the checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    import torch

    if not torch.cuda.is_available():
        log("streambench: no CUDA device; the benchmark runs on the card "
            "only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"streambench: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    if import_port() is None:
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    if result is None:
        return 3
    for name, row in result["checks"].items():
        log(f"check {name}: {row['value']!r} (limit {row['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
