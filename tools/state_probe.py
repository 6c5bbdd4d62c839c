#!/usr/bin/env python3
"""The host side of the keyed window state's pane sync and window flush.

Feeds a ``KeyedStateManager`` (a tumbling ``sum`` window on the device
store) one all-fresh pane sync of G workers' entries, as the fused
runner's ``flush_pane`` hands it over, then flushes the window, and
prints per shape the wall time of each (median and least of ``--reps``
fresh managers; the sync ends in a synchronize of the device) and the
device-to-host copies the flush made (``Tensor.cpu`` calls, counted).
Shapes: 128 stores x 5,000 entries (an ``amazon128`` pane) and 512 x
30,000 (a ``zf512`` pane: ~8,300 keys, the hot ones spread over many
workers).

The probe uses only what every version of the state layer has, so the
same file times another checkout's: from the root of a checkout,
``PYTHONPATH=src python3 tools/state_probe.py [--device cpu]
[--no-probe]``, or
``PYTHONPATH=<other>/src python3 tools/state_probe.py`` for another tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

SHAPES = ((128, 5_000), (512, 30_000))
WINDOW = 65_536


def pane_columns(workers: int, entries: int, seed: int):
    """(workers, starts, keys, values, counts, last): ``entries`` distinct
    (worker, key) pairs over every worker, sorted by (worker, key)."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, workers, 3 * entries) * 2 ** 32
                      + rng.integers(0, 250_000, 3 * entries))
    pairs = rng.permutation(pairs)[:entries]
    pairs.sort()
    ws, ks = pairs >> 32, pairs & 0xFFFFFFFF
    cut = np.flatnonzero(ws[1:] != ws[:-1]) + 1
    starts = np.concatenate(([0], cut, [entries]))
    counts = rng.integers(1, 40, entries)
    values = counts * rng.integers(1, 98, entries)
    w = ws[starts[:-1]]
    last = rng.integers(0, WINDOW, w.shape[0])
    return w, starts, ks, values, counts, last


def entries_of(cols):
    """The sync as this checkout's runner hands it over: the columns
    where the state layer takes them, else a list a worker."""
    from repro_torch.state import window

    w, starts, ks, vs, cs, last = cols
    if hasattr(window, "PaneEntries"):
        return window.PaneEntries(w, starts, ks, vs, cs, last)
    return [(int(w[g]), ks[starts[g]:starts[g + 1]],
             vs[starts[g]:starts[g + 1]], cs[starts[g]:starts[g + 1]],
             int(last[g])) for g in range(w.shape[0])]


def run_once(cols, device, sync, probe=True):
    from repro_torch.state import KeyedStateManager, WindowOp

    mgr = KeyedStateManager(WindowOp(agg="sum", size=WINDOW,
                                     backend="device"), device=device)
    entries = entries_of(cols)
    sync()
    t0 = time.perf_counter()
    mgr.feed_aggregated(WINDOW, entries)
    sync()
    t1 = time.perf_counter()
    copies = [0]
    real_cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies[0] += 1
        return real_cpu(self, *a, **k)

    torch.Tensor.cpu = counted
    try:
        t2 = time.perf_counter()
        mgr._flush_ready()
        t3 = time.perf_counter()
    finally:
        torch.Tensor.cpu = real_cpu
    parts = mgr.partials
    assert len(parts) == cols[0].shape[0]
    assert sum(p.keys.shape[0] for p in parts) == cols[2].shape[0]
    if probe:
        assert sum(int(p.values.sum()) for p in parts) == int(cols[3].sum())
    return (t1 - t0) * 1e3, (t3 - t2) * 1e3, copies[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--no-probe", action="store_true",
                    help="stub the probe launch out: the bookkeeping alone "
                         "(on the CPU the plain probe's compare matrices "
                         "dwarf it)")
    args = ap.parse_args()
    if args.no_probe:
        from repro_torch.kernels import store_probe

        store_probe.store_probe_grouped = lambda *a, **k: None
    device = torch.device(args.device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    if device.type == "cuda":
        card = torch.cuda.get_device_name(device)
    else:
        card = "cpu"
    for workers, entries in SHAPES:
        cols = pane_columns(workers, entries, seed=workers)
        probe = not args.no_probe
        run_once(cols, device, sync, probe)  # warm: the build, allocator
        rows = [run_once(cols, device, sync, probe)
                for _ in range(args.reps)]
        sync_ms, flush_ms, copies = zip(*rows)
        print(json.dumps({
            "device": card, "stores": workers, "entries": entries,
            "sync_ms_median": statistics.median(sync_ms),
            "sync_ms_min": min(sync_ms),
            "flush_ms_median": statistics.median(flush_ms),
            "flush_ms_min": min(flush_ms),
            "flush_readbacks": sorted(set(copies)),
            "probe": probe, "reps": args.reps}), flush=True)


if __name__ == "__main__":
    main()
