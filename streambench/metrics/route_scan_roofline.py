"""Segment kernels: ``route_scan``'s share of its roofline over the
feeds the check sampled — the least time their data needs (the larger of
bytes at the card's memory rate and operations at its float32 rate,
``roofline.py``, from the reference's candidate counts of those very
feeds) over the profiler's time of their ``route_scan`` launches."""

import roofline

UNIT = "%"
LAYER = "segment kernels"
MOVES = "tuples_per_s"


def read(ctx):
    tr, rec = ctx["trace"], ctx["rec"]
    launches = [t1 - t0 for n, t0, t1 in tr["device"]
                if "route_scan_kernel" in n]
    base = rec["launch0_route_scan"]
    workers = int(ctx["config"]["workers"])
    least = measured = 0.0
    for s in rec["samples"]:
        a, b = s["launches"]
        segs = s.get("ref_segments") or []
        if b - a != len(segs) or b - base > len(launches):
            continue
        measured += sum(launches[a - base:b - base])
        for g in segs:
            least += roofline.least_seconds(
                roofline.route_scan_bytes(g["m"], g["d"], workers,
                                          g["epochs"], g["keys_read"],
                                          g["keys_written"]),
                roofline.route_scan_ops(g["m"], g["d"]))
    return 100.0 * least / measured if measured > 0 else None
