"""Session layer (``topology/engine.py``): the port's ``session.close``
span, mean a close: the last pane's drain, the state layer's finalize
and report (``merge_partials``), the replica sync, the edge metrics and
the latency percentiles over every tuple of the cycle."""

UNIT = "ms"
LAYER = "session"
MOVES = "tuples_per_s"


def read(ctx):
    d = [t1 - t0 for n, t0, t1 in ctx["trace"]["spans"]
         if n == "session.close"]
    return sum(d) / len(d) * 1e3 if d else None
