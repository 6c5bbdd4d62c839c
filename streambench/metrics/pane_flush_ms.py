"""Keyed window state (``flush_pane`` -> ``state/window.py`` ->
``state/store.py`` -> ``csrc/store_probe.cu``): the port's
``fused.pane_flush`` span, mean per flush."""

UNIT = "ms"
LAYER = "keyed window state"
MOVES = "tuples_per_s"


def read(ctx):
    d = [t1 - t0 for n, t0, t1 in ctx["trace"]["spans"]
         if n == "fused.pane_flush"]
    return sum(d) / len(d) * 1e3 if d else None
