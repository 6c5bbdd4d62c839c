"""Device: the share of the traced window in which the profiler shows no
kernel, copy or memset on the card (open loop)."""

import tracing

UNIT = "%"
LAYER = "device"
MOVES = "latency_p99_ms"


def read(ctx):
    return tracing.idle_pct(ctx["trace"])
