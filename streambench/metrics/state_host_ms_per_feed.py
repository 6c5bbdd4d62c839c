"""Keyed window state (``state/window.py::KeyedStateManager``): the port's
``state.feed_aggregated`` spans, the pane sync's host side (window
composition, ``merge_many``'s bookkeeping, upload and launch), per feed."""

import portspans

UNIT = "ms"
LAYER = "keyed window state"
MOVES = "tuples_per_s"


def read(ctx):
    spans = ctx["trace"]["spans"]
    n = portspans.feeds(spans)
    s = portspans.seconds(spans, ("state.feed_aggregated",))
    return s / n * 1e3 if n and s is not None else None
