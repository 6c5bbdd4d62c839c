"""Runner layer (``kernels/feed_fused.py::FusedEdgeRunner.
refresh_membership``): the port's ``fused.ring_table`` span, mean a
build: the ring's candidate table made on the host (``_build_ring_table``,
rows x ``dmax``) and its points and candidates uploaded, once at each
session's first feed."""

UNIT = "ms"
LAYER = "runner"
MOVES = "tuples_per_s"


def read(ctx):
    d = [t1 - t0 for n, t0, t1 in ctx["trace"]["spans"]
         if n == "fused.ring_table"]
    return sum(d) / len(d) * 1e3 if d else None
