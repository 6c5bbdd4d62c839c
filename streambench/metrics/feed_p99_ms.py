"""The 99th percentile over the window's feeds of one ``session.feed``'s
wall time, ending in ``torch.cuda.synchronize()``."""

import numpy as np

UNIT = "ms"


def read(ctx):
    walls = [end - start for _, _, _, start, end in ctx["rec"]["feeds"]]
    return float(np.percentile(walls, 99)) * 1e3
