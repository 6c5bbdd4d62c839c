"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start."""

UNIT = "MiB"


def read(ctx):
    return ctx["peak_bytes"] / 2.0 ** 20
