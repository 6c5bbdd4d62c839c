"""Device: the share of the traced window in which the profiler shows no
kernel, copy or memset on the card (closed loops)."""

import tracing

UNIT = "%"
LAYER = "device"
MOVES = "tuples_per_s"


def read(ctx):
    return tracing.idle_pct(ctx["trace"])
