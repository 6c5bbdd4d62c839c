"""Find the open-loop rate a deployment sustains: run an open-loop mix at
fixed rates and print how the backlog moves, in one process on the card.

    python3 streambench/sweep.py --config <name> --traffic <open mix> \\
        --seconds <s> --seed <n> --rates <tuples/s> [<tuples/s> ...]

For each rate it makes one run of the configuration under the mix
(``configs`` entry of ``BENCHMARK.json``, ``traffic/<mix>.json``) with
the mix's ``rate`` replaced, and prints one JSON line: the feeds' latency
p50 / p99 (from the due time), the generator's lateness p99, and the
lateness of the first feed of each cycle after the first and of the
window's last feed.  At a rate the system sustains those stay bounded
from cycle to cycle; above it they grow with the run.  The mix then
takes 4/5 of the highest sustained rate.  The benchmark's own runs never
run it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import driver
import run
import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(run.ROOT / "build"
                                              / "repro_torch")
    import torch

    if not torch.cuda.is_available() or run.import_port() is None:
        run.log("sweep: needs the card and the port")
        return 2
    real = driver.run_window
    kept = {}

    def keep(*a, **k):
        kept["rec"] = rec = real(*a, **k)
        return rec

    driver.run_window = keep
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    name = f"{args.config}.{args.traffic}"
    bench["workloads"].append({"name": name, "config": args.config,
                               "traffic": args.traffic, "chips": 1,
                               "why": "rate sweep"})
    for rate in args.rates:
        cell = spec.Cell(bench, name)
        if cell.traffic["loop"] != "open":
            raise SystemExit(f"{args.traffic} is not an open-loop mix")
        cell.traffic["rate"] = rate
        res = run.run_cell(cell, args.seed, args.seconds, False, "cuda",
                           t_start=time.perf_counter())
        feeds = kept["rec"]["feeds"]
        lat = np.asarray([end - due for _, _, due, _, end in feeds])
        late = np.asarray([start - due for _, _, due, start, _ in feeds])
        firsts = [start - due for c, k, due, start, _ in feeds
                  if k == 0 and c > 0]
        print(json.dumps({
            "rate": rate, "correct": res["correct"], "feeds": len(feeds),
            "cycles": kept["rec"]["cycles"],
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "late_p99_ms": float(np.percentile(late, 99)) * 1e3,
            "cycle_start_late_ms": [x * 1e3 for x in firsts],
            "last_late_ms": float(late[-1]) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
