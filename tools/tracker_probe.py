#!/usr/bin/env python3
"""``tracker_segment``'s device time on the card, and its alternatives'.

Runs the ``repro_torch`` package found on ``sys.path`` on one segment of
16,384 tuples of a z = 1.2 ZF stream, in four configurations: FISH (17
epochs of 1,000 starting on a boundary, alpha 0.2: the walk and the dense
decay pass) and DC/WC (one ordinal, alpha = 1: no decay pass), each over
a key capacity of 131,073 (path A's) and 2^21 + 1 (``KEY_CAP_LIMIT``'s).
The kernel is held against ``tracker_update_plain`` (bit for bit), then
timed: the mean device duration of its kernel in a ``torch.profiler``
trace of 100 calls, each on the tracker as the segment found it (CUDA
events around single calls where the trace shows none), beside the bytes
bound at 3.35 TB/s.  Prints one JSON line per (configuration, variant),
labelled ``--label``, with the cluster and table place the card chose.
Against an older checkout, whose tracker was two kernels over a dense
(epochs, key capacity) count table (``tracker_count`` + ``tracker_fold``),
it times that pair the same way instead (variant ``count+fold``).

``--variants`` also times copies of the library built (into
``build/tracker_probe/``) with the layout forced where the card would
choose it: an 8-block cluster, the tables in global scratch, one block of
1,024 threads (its tables in global scratch), and blocks of 512 or 256
threads.
``--phases`` times instead copies built to return after each of the
kernel's phases, at the main path's FISH and DC/WC segments over 131,073
keys: the device ms up to each phase's end, whose differences are the
phases' costs (a phase the configuration does not run reads as the whole
kernel).  ``--stress N`` runs instead N segments of random shapes (1 to
70,000 tuples, 1,000 to 2^21 + 1 keys, epochs of 8 to 5,000 or none,
values near 2^24), each synchronized and held against the plain version
on the card, and prints how many launched, failed or differed.

Usage, from the root of a checkout on a machine with the card and nvcc:
``PYTHONPATH=src python3 tools/tracker_probe.py --label change
[--variants | --phases | --stress N]``.
"""

from __future__ import annotations

import argparse
import json
import sys

HBM_BPS = 3.35e12
M = 16_384
REPS = 100
CONFIGS = {  # name: (g0, epoch, alpha)
    "fish": (17_000, 1_000, 0.2),
    "dcwc": (0, 0, 1.0),
}
# (key capacity + 1, the stream's key universe)
KCAPS = ((131_073, 100_000), ((1 << 21) + 1, 1 << 21))


def device_ms(fn, setup, torch, names=("tracker_segment",)):
    """(ms of one call, how): profiler kernel durations, else events."""
    from torch.profiler import ProfilerActivity, profile

    setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            setup()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    if sum(us) > 0:
        return (sum(us) / 1e3 / REPS,
                f"profiler ({len(us)} kernels in {REPS} calls)")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        setup()
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[REPS // 2], "events"


# where a phases copy returns: each marker's line in tracker_segment_kernel
PHASES = (("launch", "  // -- phase 0: clear"),
          ("count", "  // each local pair's count added to the cluster's"),
          ("add", "    int bmax = 0;  // >= 0"),
          ("push", "  // -- phase 2: the key table; the walks"),
          ("list", "  // a warp's 32 listed keys walked through"),
          ("walk", "  cluster_arrive();\n  cluster_wait();\n"
                   "  // each local pair's end-of-ordinal"),
          ("fetch", "  // -- phase 3: fv; the carry"))
# the layouts a variant copy forces in tracker_plan: (name, text, forced)
VARIANTS = (("cluster 8", "for (int lc = 4; lc >= 3; --lc)",
             "for (int lc = 3; lc >= 3; --lc)"),
            ("global tables", "for (int g = 0; g < 2; ++g)",
             "for (int g = 1; g < 2; ++g)"),
            ("one block", "for (int lc = 4; lc >= 3; --lc)",
             "for (int lc = 0; lc >= 0; --lc)"),
            ("512 threads", "constexpr int kTrkThreads = 1024;",
             "constexpr int kTrkThreads = 512;"),
            ("256 threads", "constexpr int kTrkThreads = 1024;",
             "constexpr int kTrkThreads = 256;"))


def build_copies(ff, sources):
    """{name: the feed_fused library built from the source text}."""
    import ctypes
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    out = Path(_build.CSRC).parents[2] / "build" / "tracker_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, text) in enumerate(sources.items()):
        cu = out / f"copy{n}.cu"
        cu.write_text(text)
        procs[name] = (cu, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cu, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        for fn, argtypes in ff._SIGS.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def source():
    from repro_torch.kernels import _build
    return (_build.CSRC / "feed_fused.cu").read_text()


def phase_libs(ff):
    """{phase: the feed_fused library built to return after it}."""
    src = source()
    start = src.index("tracker_segment_kernel(TrackerArgs a) {")
    texts = {}
    for name, marker in PHASES:
        at = src.index(marker, start)
        # every block waits for the others before it leaves: none may go
        # while another still reads its shared memory
        texts[name] = (src[:at] + "  if (a.m >= 0) {\n    cluster.sync();\n"
                       "    return;\n  }\n" + src[at:])
    return build_copies(ff, texts)


_OWN = {}  # the package's own library getter


def use_lib(ff, lib):
    """Route ff's wrappers to ``lib`` (None: the package's own), and plan
    the layout anew."""
    _OWN.setdefault("lib", ff._lib)
    ff._TRK_PLANS.clear()
    ff._lib = _OWN["lib"] if lib is None else (lambda: lib)


def phases(ff, torch, np, label) -> int:
    """The device ms up to each phase's end, FISH and DC/WC."""
    from repro_torch.data.synthetic import zipf_time_evolving

    dev = torch.device("cuda")
    kcap1, num_keys = KCAPS[0]
    keys = torch.from_numpy(zipf_time_evolving(
        M, num_keys=num_keys, z=1.2, seed=1).astype(np.int32)).to(dev)
    rng = np.random.default_rng(0)
    trk0 = torch.from_numpy((rng.integers(0, 40, kcap1) * (
        rng.random(kcap1) < 0.2)).astype(np.float32)).to(dev)
    carry0 = torch.tensor([float(trk0.sum()), float(trk0.max())],
                          device=dev)
    libs = phase_libs(ff)
    for name, (g0, epoch, alpha) in CONFIGS.items():
        ne = (g0 + M - 1) // epoch - g0 // epoch + 1 if epoch else 1
        pre = 1 if (epoch and g0 % epoch == 0 and g0) else 0
        kw = dict(g0=g0, epoch=epoch, pre=pre, ne=ne, alpha=alpha)
        trk, carry = trk0.clone(), carry0.clone()

        def restore():
            trk.copy_(trk0)
            carry.copy_(carry0)
        row = {}
        for phase, lib in list(libs.items()) + [("whole", None)]:
            use_lib(ff, lib)
            row[phase] = device_ms(
                lambda: ff.tracker_update(trk, carry, keys, M, **kw),
                restore, torch)[0]
        use_lib(ff, None)
        log2c, glob = ff._tracker_plan(dev, *ff._tracker_tables(
            M, kcap1))
        print(json.dumps({"label": label, "config": name, "kcap1": kcap1,
                          "cluster": 1 << log2c,
                          "tables": "global" if glob else "shared",
                          "device_ms_up_to": row}), flush=True)
    return 0


def stress(ff, torch, np, label, n) -> int:
    """n random segments, each held against the plain version."""
    from repro_torch.data.synthetic import zipf_time_evolving

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    done = failed = differed = 0
    for it in range(n):
        m = int(rng.choice([1, 33, 1_000, 16_384, 30_000, 70_000]))
        kcap = int(rng.choice([1_000, 100_000, 1 << 21]))
        keys = zipf_time_evolving(m, num_keys=kcap, z=float(
            rng.choice([0.8, 1.2, 1.6])), seed=int(it)).astype(np.int32)
        trk0 = np.zeros(kcap + 1, np.float32)
        trk0[:kcap] = rng.integers(0, 40, kcap) * (rng.random(kcap) < 0.2)
        if rng.random() < 0.2:
            trk0[:kcap:11] = 2.0 ** 24 - 4
        if rng.random() < 0.4:
            kw = dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
        else:
            epoch = int(rng.choice([8, 200, 1_000, 5_000]))
            m = min(m, 64 * epoch)  # at most 64 epochs: the plain loop
            g0 = int(rng.integers(0, 4 * epoch))
            if rng.random() < 0.3:
                g0 -= g0 % epoch
            kw = dict(g0=g0, epoch=epoch, alpha=0.2,
                      pre=1 if (g0 and g0 % epoch == 0) else 0,
                      ne=(g0 + m - 1) // epoch - g0 // epoch + 1)
        carry0 = torch.tensor([trk0.sum(dtype=np.float32), trk0.max()],
                              device=dev)
        keys_d = torch.from_numpy(keys).to(dev)
        trk, carry = torch.from_numpy(trk0).to(dev), carry0.clone()
        want = ff.tracker_update_plain(trk, carry, keys_d, m, kw["g0"],
                                       kw["epoch"], kw["pre"], kw["ne"],
                                       kw["alpha"]) + (trk, carry)
        trk, carry = torch.from_numpy(trk0).to(dev), carry0.clone()
        try:
            got = ff.tracker_update(trk, carry, keys_d, m, **kw) + (trk,
                                                                     carry)
            torch.cuda.synchronize()
        except RuntimeError as e:
            failed += 1
            print(json.dumps({"label": label, "segment": it, "m": m,
                              "kcap1": kcap + 1, **kw, "error": str(e)}),
                  flush=True)
            break  # a CUDA error leaves the context unusable
        done += 1
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            differed += 1
            print(json.dumps({"label": label, "segment": it, "m": m,
                              "kcap1": kcap + 1, **kw, "differs": True}),
                  flush=True)
    print(json.dumps({"label": label, "stress_segments": n, "ran": done,
                      "failed": failed, "differed": differed}), flush=True)
    return 1 if failed or differed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--phases", action="store_true",
                    help="time copies cut after each phase instead")
    ap.add_argument("--variants", action="store_true",
                    help="also time copies with the layout forced")
    ap.add_argument("--stress", type=int, default=0,
                    help="hold N random segments against the plain version")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tracker_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import zipf_time_evolving
    from repro_torch.kernels import feed_fused as ff

    if args.phases:
        return phases(ff, torch, np, args.label)
    if args.stress:
        return stress(ff, torch, np, args.label, args.stress)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    libs = {}
    if args.variants and "tracker_fold" not in ff.LAUNCHES:
        src = source()
        libs = build_copies(ff, {name: src.replace(text, forced)
                                 for name, text, forced in VARIANTS})
    for kcap1, num_keys in KCAPS:
        keys = zipf_time_evolving(M, num_keys=num_keys, z=1.2,
                                  seed=1).astype(np.int32)
        trk0 = (rng.integers(0, 40, kcap1) * (rng.random(kcap1) < 0.2)
                ).astype(np.float32)
        trk0_d = torch.from_numpy(trk0).to(dev)
        carry0 = torch.tensor([trk0.sum(dtype=np.float32), trk0.max()],
                              device=dev)
        keys_d = torch.from_numpy(keys).to(dev)
        for name, (g0, epoch, alpha) in CONFIGS.items():
            ne = (g0 + M - 1) // epoch - g0 // epoch + 1 if epoch else 1
            pre = 1 if (epoch and g0 % epoch == 0 and g0) else 0
            kw = dict(g0=g0, epoch=epoch, pre=pre, ne=ne, alpha=alpha)
            nbytes = 8 * M + 8 * ne + 16 + (8 * kcap1 if alpha != 1.0
                                            else 8 * int(torch.unique(
                                                keys_d).shape[0]))
            if "tracker_fold" in ff.LAUNCHES:  # the two-kernel tracker
                cnt = torch.zeros((ne, kcap1), dtype=torch.int32,
                                  device=dev)
                snap = (torch.empty((ne, kcap1), device=dev) if ne > 1
                        else None)
                trk = trk0_d.clone()
                ms, how = device_ms(
                    lambda: ff.tracker_update(trk, cnt, keys_d, M,
                                              snap=snap, **kw),
                    lambda: trk.copy_(trk0_d), torch,
                    ("tracker_count", "tracker_fold"))
                print(json.dumps({
                    "label": args.label, "config": name, "kcap1": kcap1,
                    "ne": ne, "m": M, "variant": "count+fold",
                    "device_ms": ms, "by": how,
                    "bound_ms": nbytes / HBM_BPS * 1e3}), flush=True)
                continue
            trk, carry = trk0_d.clone(), carry0.clone()
            want = ff.tracker_update_plain(trk, carry, keys_d, M, g0, epoch,
                                           pre, ne, alpha) + (trk, carry)
            for variant, lib in [("kept", None)] + list(libs.items()):
                use_lib(ff, lib)
                log2c, glob = ff._tracker_plan(dev, *ff._tracker_tables(
                    M, kcap1))
                trk, carry = trk0_d.clone(), carry0.clone()

                def call():
                    return ff.tracker_update(trk, carry, keys_d, M, **kw)

                def restore():
                    trk.copy_(trk0_d)
                    carry.copy_(carry0)
                got = call() + (trk, carry)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                ms, how = device_ms(call, restore, torch)
                print(json.dumps({
                    "label": args.label, "config": name, "kcap1": kcap1,
                    "ne": ne, "m": M, "variant": variant,
                    "cluster": 1 << log2c,
                    "tables": "global" if glob else "shared",
                    "equal_to_plain": same, "device_ms": ms, "by": how,
                    "bound_ms": nbytes / HBM_BPS * 1e3}), flush=True)
                if not same:
                    print("tracker_probe: the kernel differs from the plain "
                          "version", file=sys.stderr)
                    return 1
            use_lib(ff, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
