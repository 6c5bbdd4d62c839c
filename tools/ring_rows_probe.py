#!/usr/bin/env python3
"""``ring_rows``' device time at every candidate width, on the card.

Runs the ``repro_torch`` package found on ``sys.path`` (so two trees can
be compared in one call by setting ``PYTHONPATH``) on one segment at the
main path's shapes: 16,384 tuples routed through the per-key hash cache
of 100,000 keys, a ring of 128 workers x 64 virtual nodes (R = 8,192),
candidate widths 1 (FG), 2 (PKG), 8 and 16 (DC/WC/FISH edges of 8 and 16
workers), 31 and 128 (DC/WC/FISH at 128 workers).  Each width's rows are
held against ``ring_rows_plain`` (exact), then timed: the mean device
duration of the kernel's events in a ``torch.profiler`` trace of 200
calls (CUDA events around single calls where it shows none), beside its
bytes bound at 3.35 TB/s.  Prints one JSON line per width, labelled
``--label``.

Usage, from the root of a checkout on a machine with the card and nvcc:
``PYTHONPATH=src python3 tools/ring_rows_probe.py --label change``.
"""

from __future__ import annotations

import argparse
import json
import sys

HBM_BPS = 3.35e12
WIDTHS = (1, 2, 8, 16, 31, 128)
M = N_PAD = 16_384
KEYS = 100_000
REPS = 200


def device_ms(fn, torch):
    """(ms of one call, how): profiler kernel durations, else events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    # per kernel event seen: a trace that drops events cannot shrink it
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "ring_rows" in e.name]
    if sum(us) > 0:
        return sum(us) / 1e3 / len(us), f"profiler ({len(us)} of {REPS})"
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[REPS // 2], "events"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ring_rows_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.chash import ConsistentHashRing, hash32
    from repro_torch.kernels import feed_fused as ff

    dev = torch.device("cuda")
    ring = ConsistentHashRing(range(128), virtual_nodes=64)
    pts, cands = ff._build_ring_table(ring, 128)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, KEYS, M).astype(np.int32)
    hashes = np.array([hash32(int(k)) for k in range(KEYS)], np.uint32)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pts_d, cands_d = up(ff._u32_bits(pts)), up(cands)
    h_d, k_d = up(ff._u32_bits(hashes)), up(keys)
    for width in WIDTHS:
        def call(w=width):
            return ff.ring_rows(pts_d, cands_d, h_d, k_d, M, w, N_PAD)
        want = ff.ring_rows_plain(pts_d.cpu(), cands_d.cpu(), h_d.cpu(),
                                  k_d.cpu(), M, width, N_PAD)
        if not torch.equal(call().cpu(), want):
            print(f"ring_rows_probe: width {width} differs from the plain "
                  "version", file=sys.stderr)
            return 1
        ms, how = device_ms(call, torch)
        r = pts.shape[0]
        bytes_ = (4 * r + 4 * min(r, M) * width + 8 * M
                  + 4 * N_PAD * width)
        print(json.dumps({"label": args.label, "width": width, "m": M,
                          "R": r, "device_ms": ms, "device_by": how,
                          "bound_ms": bytes_ / HBM_BPS * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
