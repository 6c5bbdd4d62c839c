"""Edge driver (``core/stream.py::_edge_fused``): the port's ``edge.fused``
spans less the time their ``fused.*`` children (the runner) cover, per
feed: segment cuts, capacity samples and the edge's own set-up."""

import portspans

UNIT = "ms"
LAYER = "edge driver"
MOVES = "tuples_per_s"


def read(ctx):
    spans = ctx["trace"]["spans"]
    n = portspans.feeds(spans)
    own = portspans.self_seconds(spans, "edge.fused", "fused.")
    return own / n * 1e3 if n and own is not None else None
