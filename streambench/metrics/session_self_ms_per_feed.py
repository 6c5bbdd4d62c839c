"""Session layer (``topology/engine.py``): the port's ``session.feed``
spans less the time their ``fused.*`` children cover, per feed."""

import bisect

UNIT = "ms"
LAYER = "session"
MOVES = "tuples_per_s"


def read(ctx):
    spans = ctx["trace"]["spans"]
    feeds = [s for s in spans if s[0] == "session.feed"]
    kids = sorted((s for s in spans if s[0].startswith("fused.")),
                  key=lambda s: s[1])
    if not feeds:
        return None
    starts = [k[1] for k in kids]
    own = 0.0
    for _, t0, t1 in feeds:
        covered, hi = 0.0, t0
        for _, k0, k1 in kids[bisect.bisect_left(starts, t0):
                              bisect.bisect_right(starts, t1)]:
            k0, k1 = max(k0, hi), min(k1, t1)
            if k1 > k0:
                covered += k1 - k0
                hi = k1
        own += (t1 - t0) - covered
    return own / len(feeds) * 1e3
