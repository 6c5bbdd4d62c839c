"""Process start to the first timed feed: imports, the CUDA context, the
stream made from the seed, the kernels' build (first run of a checkout)
and the warm-up."""

UNIT = "s"


def read(ctx):
    return ctx["setup_s"]
