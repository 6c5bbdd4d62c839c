"""Read the compared numbers of sound runs and of the control, seed by
seed, in one process on the card.

    python3 streambench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed it makes one run of the cell (set-up, a window of at least
``--seconds``, the check) and prints the numbers the check compares twice:
for the program's run (the lower readings the limits are set from) and for
the control, the reference in the program's place computed one precision
below the configuration's (float32 clocks for float64, a bfloat16 tracker
for float32) on the same sampled feeds (the upper readings).  The last
line is a JSON summary: per number the largest sound reading and the
smallest control reading.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

import run
import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(run.ROOT / "build"
                                              / "repro_torch")
    import torch

    if not torch.cuda.is_available() or run.import_port() is None:
        run.log("control: needs the card and the port")
        return 2
    sound, control = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda",
                           t_start=t0, control=True)
        if res is None:
            return 3
        for name in res["checks"]:
            s = res["checks"][name]["value"]
            c = res["control"][name]["value"]
            sound.setdefault(name, []).append(s)
            control.setdefault(name, []).append(c)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "sound": {k: v["value"]
                                    for k, v in res["checks"].items()},
                          "control": {k: v["value"]
                                      for k, v in res["control"].items()}}),
              flush=True)
    print(json.dumps({"workload": cell.name, "seeds": args.seeds,
                      "sound_max": {k: max(v) for k, v in sound.items()},
                      "control_min": {k: min(v)
                                      for k, v in control.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
