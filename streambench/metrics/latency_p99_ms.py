"""Open loop: the 99th percentile over the window's feeds of completion
less due time, the instant the feed's last tuple was created at the
traffic's rate.  Queue wait plus service; the batch's fill time is left
out."""

import numpy as np

UNIT = "ms"


def read(ctx):
    lat = [end - due for _, _, due, _, end in ctx["rec"]["feeds"]
           if due is not None]
    return float(np.percentile(lat, 99)) * 1e3 if lat else None
