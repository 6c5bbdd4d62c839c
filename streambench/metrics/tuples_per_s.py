"""Tuples fed in the window over the window's seconds; the window ends
with a cycle's close and a synchronize, so every tuple was served."""

UNIT = "tuples/s"


def read(ctx):
    rec = ctx["rec"]
    return rec["tuples"] / rec["window_s"]
