"""Segment kernels (``csrc/feed_fused.cu``): the profiler's device time of
``ring_rows``, ``tracker_segment``, ``route_scan``, ``fifo_workers`` and
``pane_update`` over the window, per feed."""

UNIT = "ms"
LAYER = "segment kernels"
MOVES = "tuples_per_s"
KERNELS = ("ring_rows_kernel", "tracker_segment_kernel", "route_scan_kernel",
           "fifo_workers_kernel", "pane_update_kernel")


def read(ctx):
    tr = ctx["trace"]
    w0, w1 = tr["window"]
    dev = sum(t1 - t0 for n, t0, t1 in tr["device"]
              if any(k in n for k in KERNELS) and w0 <= t0 and t1 <= w1)
    return dev / len(ctx["rec"]["feeds"]) * 1e3 if dev > 0 else None
