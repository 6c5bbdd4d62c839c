"""Runner layer (``kernels/feed_fused.py::FusedEdgeRunner``): host time of
the port's spans ``fused.begin_feed``, ``fused.segment.prep`` and
``fused.segment.launch`` (the launches' enqueue), per feed."""

UNIT = "ms"
LAYER = "runner"
MOVES = "tuples_per_s"
_SPANS = ("fused.begin_feed", "fused.segment.prep", "fused.segment.launch")


def read(ctx):
    spans = ctx["trace"]["spans"]
    feeds = sum(1 for s in spans if s[0] == "session.feed")
    if not feeds:
        return None
    return sum(t1 - t0 for n, t0, t1 in spans if n in _SPANS) / feeds * 1e3
