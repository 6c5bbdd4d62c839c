"""Device: the share of the card's idle time in the traced window that no
span of the port covers (the window less the union of kernels, copies and
memsets, against the union of the port's spans).  A check of the clocks
and of the spans' coverage: where the spans are on another clock than
the profiler's it reads 100; on a shared clock, with ``session.open``,
``session.feed`` and ``session.close`` around every call into the port,
what is left is the harness's own time between those calls (snapshots
of sampled feeds, synchronizes).  A port whose calls get shorter leaves
that time a larger share, so a rise is no regression of the port."""

import portspans
import tracing

UNIT = "%"
LAYER = "device"
MOVES = "tuples_per_s"


def read(ctx):
    tr = ctx["trace"]
    if not tr["spans"] or tr["window"] is None:
        return None
    w0, w1 = tr["window"]
    edges = [w0] + [x for iv in tracing._busy(tr) for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0:
        return None
    cover = portspans.union(((t0, t1) for _, t0, t1 in tr["spans"]), w0, w1)
    return 100.0 * (idle_s - portspans.overlap(idle, cover)) / idle_s
