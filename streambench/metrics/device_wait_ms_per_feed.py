"""Runner layer (``kernels/feed_fused.py::FusedEdgeRunner``): the host's
wait for the card, the port's spans ``fused.segment.wait`` and
``fused.pane_flush.wait`` (a synchronize of the stream, traced runs
only), per feed."""

import portspans

UNIT = "ms"
LAYER = "runner"
MOVES = "tuples_per_s"


def read(ctx):
    spans = ctx["trace"]["spans"]
    n = portspans.feeds(spans)
    s = portspans.seconds(spans, ("fused.segment.wait",
                                  "fused.pane_flush.wait"))
    return s / n * 1e3 if n and s is not None else None
