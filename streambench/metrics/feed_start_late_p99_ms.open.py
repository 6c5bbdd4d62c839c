"""Load driver (the benchmark's own generator): the 99th percentile over
the window's feeds of the instant the feed was handed in less its due
time — how late the generator ran."""

import numpy as np

UNIT = "ms"
LAYER = "load driver"
MOVES = "latency_p99_ms"


def read(ctx):
    late = [start - due for _, _, due, start, _ in ctx["rec"]["feeds"]
            if due is not None]
    return float(np.percentile(late, 99)) * 1e3 if late else None
