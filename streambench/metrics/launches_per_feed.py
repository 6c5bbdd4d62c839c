"""Runner layer: the port's kernel launch counters
(``feed_fused.LAUNCHES``, ``store_probe.LAUNCHES``) over the window, per
feed."""

UNIT = "launches/feed"
LAYER = "runner"
MOVES = "tuples_per_s"


def read(ctx):
    rec = ctx["rec"]
    return sum(rec["launches"].values()) / len(rec["feeds"])
