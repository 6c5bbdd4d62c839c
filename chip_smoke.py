#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Drives the port's three device paths, each with the launch counters of
its kernels set to 0 just before it and read just after, and checks each:

A. **The keyed stream** — the paper's ZF stream routed onto 128 workers by
   each of the six grouping schemes, through the session API on the fused
   engine, with the device window store.  Each fused run is held against
   the port's batched host engine on the same stream (SG/FG/PKG exact;
   DC/WC/FISH within the DESIGN.md §6 bands), every merged window against
   ``direct_aggregate``, and FISH and WC re-run with the same seed must
   give bit-identical reports.
B. **The device FISH tracker** — the same stream, one ``epoch_update`` per
   epoch at the paper's ``FishParams()``, once through ``fish_epoch_count``
   (``fused_fn``), once through ``fish_count`` (``match_fn``) and once
   under each tie rule through ``fish_epoch_update`` (``epoch_fn``, the
   whole epoch in one launch), then ``classify_hot_keys`` at 128 workers.
   Each path equals the kernels' plain versions on the CPU over the whole
   stream, each ``epoch_fn`` run equals the run with its tie rule
   (``fused_fn`` or ``match_fn``), and each top-20 hot set meets the
   sequential ``EpochFrequencyTracker``'s with Jaccard >= 0.6.  The ms per
   epoch of all four runs is printed; the FISH kernels' rows also carry a
   device-only time (``torch.profiler``, else CUDA events around single
   launches) beside an empty launch's.
C. **mamba2-780m at full width** (48 layers, d_model 1536, bf16, random
   weights from a seed): a prefill of 4 prompts of 4,096 tokens (the
   ``prefill_32k`` shape, 32 x 32,768, cut for time), 32 decode steps, the
   prefill-then-decode consistency check, and ``ServingEngine`` over two
   ``ModelReplica``s with ``launch/serve.py``'s defaults.

Every kernel is built from ``src/repro_torch/csrc`` first (one ``nvcc``
per source, started together; ptxas's registers and spills per kernel and
the tensor-core instructions in the SSD library's SASS are printed), and
at the end each kernel's wrapper is called on the inputs its path gave
it, held against its plain PyTorch version and timed beside it (the
stream's and the FISH tracker's kernels last, after path C, with a
device-only time from ``torch.profiler`` beside the CUDA-event time of
back-to-back calls); path C also prints where one prefill layer's time
goes.

Usage: ``python3 chip_smoke.py [--tuples N] [--seed S]`` from the root of
a checkout (``--tuples`` cuts the stream of paths A and B).  Needs one
card; exits non-zero with no result without one or outside a checkout.
The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it names the card and its power limit, and a ``{"kernels": [...]}`` line
before that carries each kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

N_TUPLES = 524_288   # per scheme
FEED = 16_384        # tuples per session.feed
WORKERS = 128        # the paper's largest cluster
NUM_KEYS = 100_000   # ZF key universe (paper §6.1)
WINDOW = 65_536      # tumbling window (= pane) of the device store
RATE = 10_000.0      # tuples/s
SCHEMES = ("sg", "fg", "pkg", "dc", "wc", "fish")
EXACT = ("sg", "fg", "pkg")
F32_REL = 1e-4       # fused f32 clock vs the f64 host FIFO
FLOAT_TOL = 1e-6     # kernel vs plain, relative, float outputs (expect 0)
HBM_BPS = 3.35e12    # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS = 67e12      # H100 SXM float32 / int32-class ops outside tensor cores
TF32_OPS = 495e12    # H100 SXM dense TF32 on the tensor cores
SSD_OPS = TF32_OPS / 3   # the SSD kernels: 3 TF32 products (3xTF32) each
# dependency-chain bounds, in SM cycles per dependent step on one warp, as
# tools/chain_probe.py measures them on the H100: a shared-memory
# read-compare-write (two loads, a select, a store: route_scan's least
# step) 43.9; an f64 max + add (fifo_workers' step) 33.2
SMEM_STEP_CYCLES = 44
F64_STEP_CYCLES = 33
FISH_WORKERS = 128   # classify_hot_keys
FISH_TOP = 20        # hot-set size held against the sequential tracker
FISH_JACCARD = 0.6   # tests/test_batched_engine.py:273
FISH_CAPTURE = 100   # epoch whose kernel inputs are kept (a full table)
PROMPTS, PROMPT_LEN = 4, 4_096   # prefill_32k (32 x 32,768), cut for time
DECODE_STEPS = 32
CONSIST = dict(rtol=0.08, atol=0.35)   # tests/test_models_smoke.py:98-102
SSD_TOL = dict(rtol=3e-4, atol=3e-4)   # tests/test_kernels.py:84-87

REPO = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


# ---------------------------------------------------------------------------
# capture: the first main-path call of each kernel wrapper, per scheme
# ---------------------------------------------------------------------------


class Capture:
    """Wraps the kernel wrappers the fused path calls and keeps a clone of
    the inputs of one representative call each (cloned *before* the call,
    since the kernels update their state in place).  The wrapped function
    is the real wrapper, so launch counting is untouched."""

    def __init__(self):
        self.calls = {}
        self.scheme = None

    def _clone(self, x):
        import torch

        if isinstance(x, (list, tuple)):
            return type(x)(self._clone(v) for v in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(self, name, fn, want):
        def call(*args, **kwargs):
            key = (name, self.scheme)
            if key not in self.calls and want(args, kwargs):
                self.calls[key] = (tuple(self._clone(a) for a in args),
                                   {k: self._clone(v)
                                    for k, v in kwargs.items()})
            return fn(*args, **kwargs)
        return call


def install_capture(cap: Capture):
    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import store_probe as sp

    ff.ring_rows = cap.wrap("ring_rows", ff.ring_rows,
                            lambda a, k: a[4] == FEED)
    ff.tracker_update = cap.wrap("tracker_update", ff.tracker_update,
                                 lambda a, k: a[3] == FEED)
    ff.route_scan = cap.wrap("route_scan", ff.route_scan,
                             lambda a, k: a[1] == FEED)
    ff.fifo_workers = cap.wrap("fifo_workers", ff.fifo_workers,
                               lambda a, k: a[1] == FEED)
    # pane_update: a steady call and the first segment of a pane (reset)
    ff.pane_update = cap.wrap(
        "pane_update reset",
        cap.wrap("pane_update", ff.pane_update,
                 lambda a, k: a[2] == FEED and not k["reset"]),
        lambda a, k: a[2] == FEED and k["reset"])
    # a pane table's growth mid-pane (its slots re-inserted)
    ff.pane_grow = cap.wrap("pane_grow", ff.pane_grow, lambda a, k: True)
    # the pane flush: the runner's open pane as the first flush finds it
    real_flush = ff.FusedEdgeRunner.flush_pane

    def flush(runner, sink):
        key = ("flush", cap.scheme)
        if key not in cap.calls and runner.pane_fed:
            cap.calls[key] = ((runner.pane_keys.clone(),
                               runner.pane_vc.clone(),
                               runner.pane_last.clone()), {})
        return real_flush(runner, sink)
    ff.FusedEdgeRunner.flush_pane = flush
    # the store's grouped probe: keep the first whole pane sync (one
    # chunk per worker store of a window)
    sp.store_probe_grouped = cap.wrap("store_probe", sp.store_probe_grouped,
                                      lambda a, k: len(a[0]) >= WORKERS // 2)


class SyncCounter:
    """Counts pane syncs (``KeyedStateManager.feed_aggregated`` calls with
    tuples), so a feed can be told apart as a steady or a flush feed."""

    def __init__(self):
        from repro_torch.state.window import KeyedStateManager

        self.n = 0
        real = KeyedStateManager.feed_aggregated

        def counted(mgr, n_tuples, entries):
            if n_tuples:
                self.n += 1
            return real(mgr, n_tuples, entries)
        KeyedStateManager.feed_aggregated = counted


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def topology(scheme, T):
    op = T.WindowOp(agg="sum", value="payload", size=WINDOW,
                    backend="device")
    return T.Topology(
        name=f"zf-{scheme}",
        stages=(T.Stage("agg", WORKERS, operator=op),),
        edges=(T.Edge("source", "agg", T.config_for(scheme)),))


def batches(keys, values, T):
    ts = __import__("numpy").arange(keys.shape[0], dtype="float64") / RATE
    return [T.RecordBatch(keys[lo:lo + FEED], ts[lo:lo + FEED],
                          values[lo:lo + FEED])
            for lo in range(0, keys.shape[0], FEED)]


def run_session(mode, scheme, feeds, device, T, torch, syncs=None):
    """Feed the stream; returns the report, the wall time, and each feed's
    (wall, whether it synced a pane) — a flush feed or a steady one."""
    eng = T.SimulatorEngine(mode=mode, device=device)
    sess = eng.open(topology(scheme, T), arrival_rate=RATE)
    walls = []
    t0 = time.perf_counter()
    for b in feeds:
        n0 = syncs.n if syncs else 0
        f0 = time.perf_counter()
        sess.feed(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - f0,
                      bool(syncs and syncs.n > n0)))
    rep = sess.close()
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0, walls


def check_exact_or_banded(scheme, rf, rb):
    ef, eb = rf.edges[0], rb.edges[0]
    if ef.n_tuples != eb.n_tuples:
        return f"n_tuples {ef.n_tuples} != {eb.n_tuples}"
    if scheme in EXACT:
        if ef.memory_overhead != eb.memory_overhead:
            return f"memory_overhead {ef.memory_overhead} != {eb.memory_overhead}"
        if ef.imbalance != eb.imbalance:
            return f"imbalance {ef.imbalance} != {eb.imbalance}"
        for k in ("latency_avg", "latency_p99", "execution_time"):
            a, b = getattr(ef, k), getattr(eb, k)
            if abs(a - b) > F32_REL * abs(b):
                return f"{k} {a} vs {b} beyond rel {F32_REL}"
        if rf.state["agg"]["merged"] != rb.state["agg"]["merged"]:
            return "merged windows differ from the batched engine"
    else:  # DESIGN.md §6 bands (tests/test_fused_engine.py:114-119)
        if abs(ef.execution_time - eb.execution_time) > 0.05 * eb.execution_time:
            return f"execution_time {ef.execution_time} vs {eb.execution_time}"
        if abs(ef.throughput - eb.throughput) > 0.05 * eb.throughput:
            return f"throughput {ef.throughput} vs {eb.throughput}"
        if abs(ef.memory_overhead - eb.memory_overhead) > 0.25 * eb.memory_overhead:
            return f"memory_overhead {ef.memory_overhead} vs {eb.memory_overhead}"
        if ef.imbalance > eb.imbalance + 0.05:
            return f"imbalance {ef.imbalance} vs {eb.imbalance}"
        if ef.latency_p99 > max(eb.latency_p99 * 10.0, 0.05):
            return f"latency_p99 {ef.latency_p99} vs {eb.latency_p99}"
    return None


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def clone_call(call):
    import torch

    args, kwargs = call
    c = (lambda x: x.clone() if isinstance(x, torch.Tensor) else x)
    return tuple(c(a) for a in args), {k: c(v) for k, v in kwargs.items()}


def compare(outs_k, outs_p, names):
    """Max |kernel - plain| over every output; ints must be exact."""
    import torch

    worst = 0.0
    for name, a, b in zip(names, outs_k, outs_p):
        if a is None:
            continue
        a = a.to("cpu")
        b = b.to(a.device)
        if a.shape != b.shape:
            fail(f"{name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.dtype.is_floating_point:
            d = (a.double() - b.double()).abs()
            err = float(d.max()) if d.numel() else 0.0
            tol = FLOAT_TOL * max(float(b.double().abs().max()), 1.0) \
                if b.numel() else 0.0
            if err > tol:
                fail(f"{name}: max |err| {err} beyond {tol}")
        else:
            err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
            if err != 0.0:
                fail(f"{name}: integer outputs differ (max |err| {err})")
        worst = max(worst, err)
    return worst


def time_cuda(fn, reps, torch):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_host(fn, reps, torch):
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, bytes_,
               ops, library_ms=None, ops_rate=F32_OPS):
    """One entry of the ``kernels`` line; the bound is the larger of the
    bytes over the memory rate and the operations over ``ops_rate``: the
    float32 rate of the CUDA cores, or for the SSD kernels, whose products
    run on the tensor cores in three TF32 passes, a third of the TF32 rate
    (those rows also keep the CUDA-core bound, ``bound_f32_ms``)."""
    bound_b = bytes_ / HBM_BPS * 1e3
    bound_o = ops / ops_rate * 1e3
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches[name],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations",
           "library_ms": library_ms}
    if ops_rate != F32_OPS:
        row["bound_f32_ms"] = max(bound_b, ops / F32_OPS * 1e3)
    return row


def kernel_checks(cap, torch, np, launches):
    """Kernel vs plain on the captured main-path inputs, plus times and
    bounds.  Returns the ``kernels`` JSON rows."""
    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import store_probe as sp

    rows = []
    src_ff = "src/repro_torch/csrc/feed_fused.cu"

    def row(name, source, replaces, err, ms, plain_ms, bytes_, ops,
            library_ms=None, chain_bound_ms=None, device=None, **extra):
        r = kernel_row(name, source, replaces, launches, err, ms, plain_ms,
                       bytes_, ops, library_ms)
        if device is not None:
            r.update(device_ms=device[0], device_by=device[1])
        if chain_bound_ms is not None:
            r["chain_bound_ms"] = chain_bound_ms
        r.update(extra)
        rows.append(r)

    def dtime(name, fn, reps=50, **kw):
        return device_time(name, fn, reps, torch, **kw)

    # -- store_probe: the first pane sync, grouped; and G = 1 ----------------
    call = next(v for (n, _), v in cap.calls.items() if n == "store_probe")
    (tables, keys, vals, cnts, offsets, _, _), _ = call
    dev = keys.device
    for t in tables:  # the kernel's precondition, checked once
        if t.shape[0] > 1 and not bool((t[1:] > t[:-1]).all()):
            fail("store_probe: a pane store's table is not ascending")

    def zeros():
        return ([torch.zeros_like(t) for t in tables],
                [torch.zeros_like(t) for t in tables])
    vo, co = zeros()
    sp.store_probe_grouped(tables, keys, vals, cnts, offsets, vo, co)
    vp, cp = sp.store_probe_grouped_plain(tables, keys, vals, cnts, offsets)
    err = compare(vo + co, vp + cp, [f"vsum[{g}]" for g in range(len(vo))]
                  + [f"csum[{g}]" for g in range(len(co))])
    lo, hi = offsets[0], offsets[1]  # G = 1, with hit flags: ops.store_probe
    err = max(err, compare(
        sp.store_probe(tables[0], keys[lo:hi], vals[lo:hi], validate=True),
        sp.store_probe_plain(tables[0], keys[lo:hi], vals[lo:hi]),
        ("vsum[G=1]", "csum[G=1]", "matched[G=1]")))
    vo, co = zeros()
    meta = torch.from_numpy(sp.grouped_meta(tables, offsets, vo, co)).to(dev)
    ms = time_cuda(lambda: sp.store_probe_grouped(
        tables, keys, vals, cnts, offsets, vo, co, meta=meta), 50, torch)
    dev_sp = dtime("store_probe", lambda: sp.store_probe_grouped(
        tables, keys, vals, cnts, offsets, vo, co, meta=meta))
    pms = time_host(lambda: sp.store_probe_grouped_plain(
        tables, keys, vals, cnts, offsets), 3, torch)
    g_, n_ = len(tables), keys.shape[0]
    k_ = sum(t.shape[0] for t in tables)
    row("store_probe", "src/repro_torch/csrc/store_probe.cu",
        "src/repro/kernels/store_probe.py:56", err, ms, pms,
        12 * n_ + 4 * k_ + 8 * k_ + 8 * (5 * g_ + 1),
        n_ * (max(g_, 2).bit_length() + max(k_ // g_, 2).bit_length()),
        device=dev_sp)
    log(f"store_probe   grouped G={g_} (one pane sync) K={k_} N={n_}: "
        f"kernel {ms:.4f} ms, device {dev_sp[0]:.5f} ms, plain {pms:.4f} "
        f"ms, max|err| {err}")

    # -- the segment kernels, every scheme's captured segment ----------------
    seg = {}
    for (name, scheme), call in sorted(cap.calls.items(),
                                       key=lambda kv: str(kv[0])):
        if name == "store_probe":
            continue
        seg.setdefault(name, {})[scheme] = call
    for scheme in SCHEMES:
        if scheme not in seg.get("fifo_workers", {}) or (
                scheme not in ("sg", "fg")
                and scheme not in seg.get("route_scan", {})):
            fail(f"no captured route_scan/fifo_workers call for {scheme}")

    # ring_rows (FISH: the widest rows)
    args, kw = seg["ring_rows"]["fish"]
    pts, cands, hashes, keys, m, width, n_pad = args
    rk = ff.ring_rows(*args)
    rp = ff.ring_rows_plain(*args)
    err = compare((rk,), (rp,), ("rows",))
    for s in ("fg", "pkg", "dc", "wc"):
        a2, _ = seg["ring_rows"][s]
        err = max(err, compare((ff.ring_rows(*a2),), (ff.ring_rows_plain(*a2),),
                               (f"rows[{s}]",)))
    ms = time_cuda(lambda: ff.ring_rows(*args), 50, torch)
    dev_rr = dtime("ring_rows", lambda: ff.ring_rows(*args))
    pms = time_host(lambda: ff.ring_rows_plain(*args), 5, torch)
    rows_touched = min(pts.shape[0], m)
    row("ring_rows", src_ff, "src/repro/kernels/feed_fused.py:217", err, ms,
        pms, 4 * pts.shape[0] + 4 * rows_touched * width + 8 * m
        + 4 * n_pad * width, m * 2 * pts.shape[0].bit_length(),
        device=dev_rr)
    log(f"ring_rows     n_pad={n_pad} width={width} R={pts.shape[0]}: "
        f"kernel {ms:.4f} ms, device {dev_rr[0]:.5f} ms, plain {pms:.4f} "
        f"ms, max|err| {err}")

    # tracker (count + fold), FISH; DC and WC checked too
    def run_tracker(fn, call):
        (trk, cnt, keys, m), kw = clone_call(call)
        psum, pmax = fn(trk, cnt, keys, m, **kw)
        return psum, pmax, trk, cnt, kw["snap"]
    err = 0.0
    for s in ("dc", "wc", "fish"):
        call = seg["tracker_update"][s]
        err = max(err, compare(
            run_tracker(ff.tracker_update, call),
            run_tracker(lambda *a, **k: ff.tracker_update_plain(
                *a, k["g0"], k["epoch"], k["pre"], k["ne"], k["alpha"],
                k["snap"]), call),
            (f"psum[{s}]", f"pmax[{s}]", f"trk[{s}]", f"cnt[{s}]",
             f"snap[{s}]")))
    (trk, cnt, keys, m), kw = clone_call(seg["tracker_update"]["fish"])
    cnt_k = cnt.clone()
    ms_both = time_cuda(lambda: ff.tracker_update(trk, cnt_k, keys, m, **kw),
                        50, torch)
    pms = time_host(lambda: ff.tracker_update_plain(
        trk, cnt, keys, m, kw["g0"], kw["epoch"], kw["pre"], kw["ne"],
        kw["alpha"], kw["snap"]), 3, torch)
    kcap1 = trk.shape[0]
    ne = kw["ne"]
    # the count pass alone, through its C entry; the fold is the rest
    lib = ff._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def count_only():
        lib.tracker_count(keys.data_ptr(), m, kcap1, kw["g0"], kw["epoch"],
                          cnt_k.data_ptr(), stream)
    ms_count = time_cuda(count_only, 50, torch)
    cnt_k.zero_()
    ms_fold = max(ms_both - ms_count, 0.0)
    # device-only: the two kernels of one tracker_update, by name
    dev_tc, dev_tf = (dtime(f"tracker_update ({k_})",
                            lambda: ff.tracker_update(trk, cnt_k, keys, m,
                                                      **kw), keep=k_)
                      for k_ in ("tracker_count", "tracker_fold"))
    uniq = int(torch.unique(keys[:m]).shape[0])
    # library yardstick: the same int scatter as one index_add_ (one epoch)
    ones = torch.ones(m, dtype=torch.int32, device=keys.device)
    lib_ms = time_cuda(lambda: cnt_k[0].index_add_(0, keys[:m].long(), ones),
                       50, torch)
    cnt_k.zero_()
    nb = -(-kcap1 // 256)
    row("tracker_count", src_ff, "src/repro/kernels/feed_fused.py:251", err,
        ms_count, pms, 4 * m + 8 * uniq, m, lib_ms, device=dev_tc)
    row("tracker_fold", src_ff, "src/repro/kernels/feed_fused.py:251", err,
        ms_fold, pms, 8 * kcap1 + 8 * uniq + 4 * ne * kcap1 + 8 * ne * nb,
        kcap1 * 2 * ne + 2 * ne * kcap1, device=dev_tf)
    log(f"tracker       kcap1={kcap1} epochs={ne} m={m}: count {ms_count:.4f}"
        f" ms + fold {ms_fold:.4f} ms, device count {dev_tc[0]:.5f} + fold "
        f"{dev_tf[0]:.5f} ms, plain (both) {pms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, max|err| {err}")

    # route_scan (PKG/DC/WC/FISH) and fifo_workers (every scheme)
    def run_scan(fn, call):
        args, kw = clone_call(call)
        workers = fn(*args, **kw)
        return [workers[:args[1]], kw["counts"], kw.get("m_k"),
                kw.get("ebl"), kw.get("eas")]

    def run_fifo(fn, call):
        args, kw = clone_call(call)
        workers, fin = fn(*args, **kw)
        m = args[1]
        return [workers[:m], fin[:m], kw["busy"], kw["counts"]]
    err_r = err_f = 0.0
    route_ms, fifo_ms = {}, {}
    for s in SCHEMES:
        if s in seg["route_scan"]:
            call = seg["route_scan"][s]
            err_r = max(err_r, compare(
                run_scan(ff.route_scan, call),
                run_scan(ff.route_scan_plain, call),
                (f"workers[{s}]", f"counts[{s}]", f"m_k[{s}]", f"ebl[{s}]",
                 f"eas[{s}]")))
            args, kw = clone_call(call)
            route_ms[s] = time_cuda(lambda: ff.route_scan(*args, **kw), 10,
                                    torch)
        call = seg["fifo_workers"][s]
        err_f = max(err_f, compare(
            run_fifo(ff.fifo_workers, call),
            run_fifo(ff.fifo_workers_plain, call),
            (f"workers[{s}]", f"fin[{s}]", f"busy[{s}]", f"counts[{s}]")))
        args, kw = clone_call(call)
        fifo_ms[s] = time_cuda(lambda: ff.fifo_workers(*args, **kw), 20,
                               torch)
        log(f"segment       {s:4s} m={args[1]}: route_scan "
            f"{route_ms.get(s, 0.0):.4f} ms + fifo_workers {fifo_ms[s]:.4f} "
            f"ms = {route_ms.get(s, 0.0) + fifo_ms[s]:.4f} ms per segment")
    clock = sm_clock_mhz()

    # the rows: FISH's segment, the widest chain
    args, kw = clone_call(seg["route_scan"]["fish"])
    m = args[1]
    dev_rs = dtime("route_scan", lambda: ff.route_scan(*args, **kw), 10)
    args, kw = clone_call(seg["route_scan"]["fish"])
    pms = time_host(lambda: ff.route_scan_plain(*args, **kw), 1, torch)
    width = kw["rows"].shape[1]
    w1 = kw["counts"].shape[0]
    # candidates this segment's data makes the chain read: Σ min(d, width)
    args, kw = clone_call(seg["route_scan"]["fish"])
    _, d = ff.route_prologue(
        "fish", m, kw["keys"], kw["rows"], None, 0, 0, kw["trk"], kw["snap"],
        kw["psum"], kw["pmax"], kw["g0"], kw["epoch"], kw["theta"],
        kw["wnum"], kw["m_k"], kw["d_min"])
    d_sum = int(np.minimum(d, width).sum())
    wide = int((np.minimum(d, width) > 2).sum())
    chain = m * SMEM_STEP_CYCLES / (clock * 1e3)
    row("route_scan", src_ff, "src/repro/kernels/feed_fused.py:237,276,307",
        err_r, route_ms["fish"], pms, 4 * d_sum + 20 * m + 4 * 8 * w1,
        3 * d_sum + 2 * m, chain_bound_ms=chain, device=dev_rs)
    log(f"route_scan    fish: device {dev_rs[0]:.4f} ms; {wide} of {m} "
        f"tuples take the wide argmin, "
        f"Σ min(d, width) = {d_sum}; chain bound {chain:.4f} ms ({m} x "
        f"{SMEM_STEP_CYCLES} cycles at {clock:.0f} MHz); plain {pms:.1f} ms "
        f"(host loop)")
    # fifo_workers' row: FG's segment, whose hottest worker holds the
    # longest per-worker run of the six schemes
    args, kw = clone_call(seg["fifo_workers"]["fg"])
    dev_fw = dtime("fifo_workers", lambda: ff.fifo_workers(*args, **kw), 20)
    args, kw = clone_call(seg["fifo_workers"]["fg"])
    pms = time_host(lambda: ff.fifo_workers_plain(*args, **kw), 1, torch)
    runs = torch.bincount(kw["rows"][:m, 0].long(), minlength=w1)
    longest = int(runs.max())
    chain = longest * F64_STEP_CYCLES / (clock * 1e3)
    row("fifo_workers", src_ff, "src/repro/kernels/feed_fused.py:175",
        err_f, fifo_ms["fg"], pms, 20 * m + 3 * 8 * w1, 2 * m,
        chain_bound_ms=chain, device=dev_fw)
    log(f"fifo_workers  fg: device {dev_fw[0]:.4f} ms; longest per-worker "
        f"run {longest} of {m}; chain "
        f"bound {chain:.4f} ms ({longest} x {F64_STEP_CYCLES} cycles); plain "
        f"{pms:.1f} ms (host loop)")

    # pane_update: every scheme's steady segment, FISH's first segment of
    # a pane (reset) and a growth, in canonical form (slot places are free)
    def run_pane(fn, call):
        (keys, workers, m), kw = clone_call(call)
        fn(keys, workers, m, **kw)
        pairs, vc = ff.pane_canonical(kw["pane_keys"], kw["pane_vc"])
        return [pairs, vc, kw["pane_last"], kw["repl"]]

    def plain_pane(k, w, m, **kw):
        ff.pane_update_plain(True, kw["reset"], k, w, kw["vals"], m,
                             kw["seg_base"], kw["pane_keys"], kw["pane_vc"],
                             kw["pane_last"], kw["repl"])
    err = 0.0
    for s, name in [(s, "pane_update") for s in SCHEMES] + [
            ("fish", "pane_update reset")]:
        call = seg[name][s]
        tag = s if name == "pane_update" else "reset"
        err = max(err, compare(
            run_pane(ff.pane_update, call), run_pane(plain_pane, call),
            (f"pairs[{tag}]", f"sums[{tag}]", f"pane_last[{tag}]",
             f"repl[{tag}]")))
    (gk, gvc, gcap), _ = seg["pane_grow"]["fish"]
    grown = ff.pane_canonical(*ff.pane_grow(gk, gvc, gcap))
    err = max(err, compare(
        grown, ff.pane_canonical(*ff.pane_grow(gk.cpu(), gvc.cpu(), gcap)),
        ("pairs[grow]", "sums[grow]")))
    old = ff.pane_canonical(gk, gvc)
    if not (torch.equal(grown[0], old[0]) and torch.equal(grown[1], old[1])):
        fail("pane_grow: the grown table differs from the one it grew from")
    (keys, workers, m), kw = clone_call(seg["pane_update"]["fish"])
    # card ms: back-to-back calls into one table, so after the first every
    # pair finds its slot; device ms: each call into the table as the
    # segment found it (new pairs claim slots), the restore left out
    tk0, tvc0 = kw["pane_keys"].clone(), kw["pane_vc"].clone()
    ms = time_cuda(lambda: ff.pane_update(keys, workers, m, **kw), 50, torch)
    dev_pu = dtime("pane_update", lambda: ff.pane_update(keys, workers, m,
                                                         **kw),
                   setup=lambda: (kw["pane_keys"].copy_(tk0),
                                  kw["pane_vc"].copy_(tvc0)),
                   keep="pane_update")
    (rk, rw, rm), rkw = clone_call(seg["pane_update reset"]["fish"])
    ms_reset = time_cuda(lambda: ff.pane_update(rk, rw, rm, **rkw), 50,
                         torch)
    dev_reset = dtime("pane_update reset",
                      lambda: ff.pane_update(rk, rw, rm, **rkw))
    ms_grow = time_cuda(lambda: ff.pane_grow(gk, gvc, gcap), 50, torch)
    dev_grow = dtime("pane_grow", lambda: ff.pane_grow(gk, gvc, gcap))
    pms = time_host(lambda: plain_pane(keys, workers, m, **kw), 5, torch)
    seg_pairs = torch.unique(ff.pane_pairs(workers[:m], keys[:m]))
    pairs = int(seg_pairs.shape[0])
    new_pairs = int((~torch.isin(seg_pairs, tk0)).sum())
    # the pane state of the edge: its tables as FISH's first flush found
    # them (a whole pane's)
    pane = list(cap.calls[("flush", "fish")][0])
    pane_bytes = sum(t.numel() * t.element_size() for t in pane)
    # bytes: the tuples' (key, worker, value) read; per pair its slot key
    # and sums read and written, its replica byte; pane_last read, written
    row("pane_update", src_ff, "src/repro/kernels/feed_fused.py:414", err,
        ms, pms, 12 * m + pairs * (2 * 16 + 1) + 8 * w1, 4 * m,
        device=dev_pu, ms_reset=ms_reset, device_ms_reset=dev_reset[0],
        ms_grow=ms_grow, device_ms_grow=dev_grow[0], pane_bytes=pane_bytes,
        pane_slots=pane[0].shape[0], new_pairs=new_pairs)
    log(f"pane_update   m={m} pairs={pairs} ({new_pairs} new to the table):"
        f" kernel {ms:.4f} ms (lookup only), device "
        f"{dev_pu[0]:.5f} ms; reset call {ms_reset:.4f} ms, device "
        f"{dev_reset[0]:.5f} ms; growth to {gcap} slots {ms_grow:.4f} ms, "
        f"device {dev_grow[0]:.5f} ms; plain {pms:.4f} ms, max|err| {err}")
    log(f"pane bytes per edge: {pane_bytes:,} (pane_keys "
        f"{tuple(pane[0].shape)}, pane_vc {tuple(pane[1].shape)}, "
        f"pane_last {tuple(pane[2].shape)})")

    # the pane flush's device part, on the pane FISH's first flush found
    fk, fvc = pane[:2]
    dev_fl = dtime("flush", lambda: ff.pane_canonical(fk, fvc), 20)
    log(f"pane flush (device part: the occupied slots compacted and sorted "
        f"by pair key): device {dev_fl[0]:.5f} ms over "
        f"{fk.numel() * 8 + fvc.numel() * 4:,} bytes scanned, "
        f"{int(ff.pane_canonical(fk, fvc)[0].shape[0])} entries")
    return rows


# ---------------------------------------------------------------------------
# path B: the device FISH tracker
# ---------------------------------------------------------------------------


def top_keys(counts_by_key, k):
    return set(sorted(counts_by_key, key=counts_by_key.get,
                      reverse=True)[:k])


def fish_path(keys, dev, torch, np):
    """One ``epoch_update`` per epoch over the stream, on each of four
    paths — ``fused_fn`` (K1b), ``match_fn`` (K1a) and ``epoch_fn``
    (``fish_epoch_update``, the whole epoch in one launch) under each tie
    rule — on the card and on the CPU's plain versions; CHK at 128
    workers.  Returns the captured kernel inputs and the launch counts."""
    import functools

    from repro_torch.core import fish as F
    from repro_torch.kernels import fish_count as fc
    from repro_torch.kernels import ops

    p = F.FishParams()
    n_epochs = -(-keys.shape[0] // p.epoch)
    seq = F.EpochFrequencyTracker(p)
    seq.update_many(keys)
    top_seq = top_keys(seq.counts, FISH_TOP)
    captured = {}
    cap_epoch = min(FISH_CAPTURE, n_epochs - 1)  # a cut stream has fewer

    def capturing(name, fn, epoch_box):
        def call(*args, **kwargs):
            if epoch_box[0] == cap_epoch and name not in captured:
                captured[name] = (tuple(a.clone() for a in args),
                                  dict(kwargs))
            return fn(*args, **kwargs)
        return call

    # path: (epoch_update keyword, capture name, function); "epoch_fn
    # first" must end where "fused_fn" does, "epoch_fn key" where
    # "match_fn" does (the same tie rules)
    paths = {
        "fused_fn": ("fused_fn", "fish_epoch_count", ops.fish_epoch_count),
        "match_fn": ("match_fn", "fish_count", ops.fish_count),
        "epoch_fn first": ("epoch_fn", "fish_epoch_update first",
                           functools.partial(ops.fish_epoch_update,
                                             ties="first")),
        "epoch_fn key": ("epoch_fn", "fish_epoch_update key",
                         functools.partial(ops.fish_epoch_update,
                                           ties="key"))}
    same_as = {"epoch_fn first": "fused_fn", "epoch_fn key": "match_fn"}
    fc.LAUNCHES.update(dict.fromkeys(fc.LAUNCHES, 0))
    states, epoch_ms = {}, {}
    keys_dev = torch.from_numpy(keys).to(dev)
    for path, (kw_name, cap_name, fn) in paths.items():
        box = [0]
        kw = {kw_name: capturing(cap_name, fn, box)}
        st = F.init_fish_state(p.k_max, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(n_epochs):
            box[0] = e
            st = F.epoch_update(st, keys_dev[e * p.epoch:(e + 1) * p.epoch],
                                alpha=p.alpha, **kw)
        torch.cuda.synchronize()
        epoch_ms[path] = (time.perf_counter() - t0) * 1e3 / n_epochs
        states[path] = st
    launches = dict(fc.LAUNCHES)
    log(f"fish tracker: {n_epochs} epochs of {p.epoch}, k_max {p.k_max}, "
        f"alpha {p.alpha}, ms/epoch (host wall, synchronized, one run): "
        + ", ".join(f"{k} {v:.4f}" for k, v in epoch_ms.items())
        + f"; launches {json.dumps(launches)}")
    log(f"fish tracker ms/epoch: {json.dumps(epoch_ms)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the FISH tracker path: {missing}")
    if launches["fish_epoch_update"] != 2 * n_epochs:
        fail(f"fish_epoch_update launched {launches['fish_epoch_update']} "
             f"times, not 2 x {n_epochs}")

    # the same epochs through the plain versions on the CPU
    keys_cpu = torch.from_numpy(keys)
    for path, (kw_name, _, fn) in paths.items():
        st = F.init_fish_state(p.k_max, device="cpu")
        for e in range(n_epochs):
            st = F.epoch_update(st, keys_cpu[e * p.epoch:(e + 1) * p.epoch],
                                alpha=p.alpha, **{kw_name: fn})
        got = states[path]
        if not (torch.equal(got["keys"].cpu(), st["keys"])
                and torch.equal(got["counts"].cpu(), st["counts"])):
            fail(f"fish tracker ({path}): card != plain versions on the CPU")
        twin = states.get(same_as.get(path))
        if twin is not None and not (
                torch.equal(got["keys"], twin["keys"])
                and torch.equal(got["counts"], twin["counts"])):
            fail(f"fish tracker ({path}): table != the {same_as[path]} "
                 "path's (same tie rule)")
        order = torch.sort(got["counts"], descending=True,
                           stable=True).indices[:FISH_TOP]
        top_dev = set(got["keys"][order].tolist())
        jac = len(top_dev & top_seq) / len(top_dev | top_seq)
        if jac < FISH_JACCARD:
            fail(f"fish tracker ({path}): top-{FISH_TOP} Jaccard {jac} vs "
                 f"the sequential tracker, below {FISH_JACCARD}")
        d, hot, m_k = F.classify_hot_keys(
            got, num_workers=FISH_WORKERS, theta=p.theta(FISH_WORKERS),
            d_min=p.d_min)
        d_cpu, hot_cpu, _ = F.classify_hot_keys(
            st, num_workers=FISH_WORKERS, theta=p.theta(FISH_WORKERS),
            d_min=p.d_min)
        if not (torch.equal(d.cpu(), d_cpu) and torch.equal(hot.cpu(),
                                                            hot_cpu)):
            fail(f"fish tracker ({path}): CHK differs from the CPU's")
        n_hot = int(hot.sum())
        if n_hot == 0 or int(d[hot].max()) > FISH_WORKERS:
            fail(f"fish tracker ({path}): CHK gave {n_hot} hot keys")
        log(f"check fish tracker {path}: ok (card == plain over the whole "
            f"stream{'' if twin is None else ' == ' + same_as[path]}; "
            f"top-{FISH_TOP} Jaccard {jac:.2f} vs sequential; "
            f"{n_hot} hot keys at {FISH_WORKERS} workers, d up to "
            f"{int(d[hot].max())})")
    return captured, launches


def device_time(name, fn, reps, torch, setup=None, keep=""):
    """Device-only ms of one call of ``fn``, and how it was taken: the
    summed durations of the device operations (kernels, memsets, copies)
    whose name holds ``keep``, from ``torch.profiler``'s trace over
    ``reps`` calls, each after ``setup`` (whose operations ``keep`` leaves
    out); where the trace shows no device time, the median of CUDA events
    around single calls, each after ``setup`` and a sync.  Every device
    operation's count and ms per call is logged."""
    from torch.profiler import ProfilerActivity, profile

    def once():
        if setup is not None:
            setup()
        fn()
    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            once()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = ops.get(e.name[:40], (0, 0.0))
            ops[e.name[:40]] = (n + 1, us + e.time_range.elapsed_us())
    ops = {k: (n / reps, us / 1e3 / reps) for k, (n, us) in ops.items()
           if us > 0}
    if ops:
        log(f"  {name}: device ops per call (count, ms) {json.dumps(ops)}")
        kept = [ms for k, (_, ms) in ops.items() if keep in k]
        if not kept:
            fail(f"{name}: no device operation named {keep!r} in the trace")
        return sum(kept), "profiler"
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[reps // 2], "events"


def bitonic_stages(n):
    """Barrier-separated stages of a bitonic sort of n entries padded to a
    power of two n': log2 n' (log2 n' + 1) / 2."""
    lg = max(n - 1, 0).bit_length()
    return lg * (lg + 1) // 2


def fish_kernel_checks(captured, launches, torch):
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import fish_count as fc

    rows = []
    src = "src/repro_torch/csrc/fish_count.cu"
    lib = _build.library("fish_count", fc._SIGS)
    stream = _build.stream_ptr(torch.device("cuda"))

    def noop():
        _build.check(lib.fish_noop(stream), "fish_noop")

    floor_ms, floor_how = device_time("fish_noop", noop, 200, torch)
    log(f"empty launch: device {floor_ms:.5f} ms ({floor_how}), issue "
        f"{time_cuda(noop, 200, torch):.5f} ms")

    def timed(name, call, reps=200):
        ms = time_cuda(call, reps, torch)
        return (ms,) + device_time(name, call, reps, torch)

    (tbl, ks), _ = captured["fish_count"]
    outs_k = fc.fish_count(tbl, ks)
    err = compare(outs_k, fc.fish_count_plain(tbl, ks),
                  ("counts", "matched"))
    ms, dms, how = timed("fish_count", lambda: fc.fish_count(tbl, ks))
    pms = time_host(lambda: fc.fish_count_plain(tbl, ks), 5, torch)
    k_, n_ = tbl.shape[0], ks.shape[0]
    rows.append(kernel_row(
        "fish_count", src, "src/repro/kernels/fish_count.py:50", launches,
        err, ms, pms, 4 * k_ + 4 * n_ + 4 * k_ + n_, n_ * k_))
    rows[-1].update(device_ms=dms, device_by=how, empty_launch_ms=floor_ms)
    log(f"fish_count    K={k_} N={n_}: kernel {ms:.4f} ms (issue-bound "
        f"loop), device {dms:.5f} ms ({how}), plain {pms:.4f} ms, "
        f"max|err| {err}")

    (tbl, cnt, ks), kw = captured["fish_epoch_count"]
    outs_k = fc.fish_epoch_count(tbl, cnt, ks, **kw)
    err = compare(outs_k, fc.fish_epoch_count_plain(tbl, cnt, ks, **kw),
                  ("counts", "matched", "cand", "first"))
    ms, dms, how = timed("fish_epoch_count",
                         lambda: fc.fish_epoch_count(tbl, cnt, ks, **kw))
    pms = time_host(lambda: fc.fish_epoch_count_plain(tbl, cnt, ks, **kw),
                    5, torch)
    rows.append(kernel_row(
        "fish_epoch_count", src, "src/repro/kernels/fish_count.py:133",
        launches, err, ms, pms, 8 * k_ + 4 * n_ + 4 * k_ + 6 * n_,
        n_ * k_ + n_ * n_ + 2 * k_))
    rows[-1].update(device_ms=dms, device_by=how, empty_launch_ms=floor_ms)
    log(f"fish_epoch_count K={k_} N={n_}: kernel {ms:.4f} ms (issue-bound "
        f"loop), device {dms:.5f} ms ({how}), plain {pms:.4f} ms, "
        f"max|err| {err}")

    # fish_epoch_update: its chain of sort stages, each a measured barrier
    # round trip of a block of its width
    probe = torch.zeros(2, dtype=torch.int64, device="cuda")
    mhz = sm_clock_mhz()

    for ties in fc.TIES:
        (tbl, cnt, ks), kw = captured[f"fish_epoch_update {ties}"]
        k_, n_ = tbl.shape[0], ks.shape[0]
        call = (lambda t=ties: fc.fish_epoch_update(tbl, cnt, ks, ties=t,
                                                    **kw))
        err = compare(call(), fc.fish_epoch_update_plain(
            tbl, cnt, ks, ties=ties, **kw), ("keys", "counts"))
        ms, dms, how = timed(f"fish_epoch_update {ties}", call)
        pms = time_host(lambda t=ties: fc.fish_epoch_update_plain(
            tbl, cnt, ks, ties=t, **kw), 5, torch)
        kp = 1 << max(k_ - 1, 0).bit_length()
        np_ = 1 << max(n_ - 1, 0).bit_length()
        stages = (bitonic_stages(kp) + bitonic_stages(np_)
                  + bitonic_stages(max(kp, np_)))
        threads = min(1024, max(32, max(kp, np_) // 2))
        reps = 10_000
        _build.check(lib.fish_barrier_probe(threads, reps, probe.data_ptr(),
                                            stream), "fish_barrier_probe")
        torch.cuda.synchronize()
        stage_cycles = int(probe[0]) / reps
        chain = stages * stage_cycles / (mhz * 1e3)
        compares = (kp // 2) * 2 * bitonic_stages(kp) \
            + (np_ // 2) * 2 * bitonic_stages(np_) \
            + n_ * max(kp - 1, 1).bit_length() + n_
        rows.append(kernel_row(
            "fish_epoch_update", src, "src/repro/kernels/fish_count.py:133",
            launches, err, ms, pms, 16 * k_ + 4 * n_, compares))
        rows[-1].update(also_replaces=[
            "src/repro/kernels/fish_count.py:50",
            "src/repro/core/fish.py:319 (epoch_update after the kernel)"],
            ties=ties, device_ms=dms, device_by=how,
            empty_launch_ms=floor_ms, chain_bound_ms=chain,
            sort_stages=stages, barrier_round_trip_cycles=stage_cycles)
        log(f"fish_epoch_update ties={ties} K={k_} N={n_} max_new="
            f"{kw['max_new']}: kernel {ms:.4f} ms (issue-bound loop), "
            f"device {dms:.5f} ms ({how}), empty launch {floor_ms:.5f} ms, "
            f"plain {pms:.4f} ms, max|err| {err}; chain bound {stages} "
            f"stages x {stage_cycles:.1f} cycles (a barrier round trip of "
            f"{threads} threads) at {mhz:.0f} MHz = {chain:.5f} ms; "
            f"launches {launches['fish_epoch_update']}")
    return rows


# ---------------------------------------------------------------------------
# path C: mamba2-780m at full width
# ---------------------------------------------------------------------------


def mamba_path(seed, dev, torch, np):
    """Prefill, decode, prefill-then-decode consistency and the serving
    engine, with the SSD kernels' counters from 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as MT

    cfg = get_config("mamba2-780m")
    prompts, prompt_len, decode_steps = PROMPTS, PROMPT_LEN, DECODE_STEPS
    t0 = time.perf_counter()
    params = MT.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"mamba2-780m: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, d_state "
        f"{cfg.ssm.d_state}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{MT.num_params(params):,} parameters, random init (seed {seed}) "
        f"in {time.perf_counter() - t0:.2f} s")

    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    captured = {}
    real_state, real_output = ssd.ssd_chunk_state, ssd.ssd_chunk_output
    real_block, real_scan = ssm.mamba2_block, ops.ssd_scan

    def cap(name, fn):
        def call(*args, **kwargs):
            if name not in captured:  # layer 0 of the first prefill
                captured[name] = (
                    tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args), kwargs)
            return fn(*args, **kwargs)
        return call

    ssd.ssd_chunk_state = cap("ssd_chunk_state", real_state)
    ssd.ssd_chunk_output = cap("ssd_chunk_output", real_output)
    ssm.mamba2_block = cap("mamba2_block", real_block)
    ops.ssd_scan = cap("ssd_scan", real_scan)
    ssd.LAUNCHES.update(dict.fromkeys(ssd.LAUNCHES, 0))
    vocab = cfg.vocab_size
    gen = np.random.default_rng(seed)
    toks = torch.from_numpy(gen.integers(0, vocab, (prompts, prompt_len + 1)
                                         ).astype(np.int32)).to(dev)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = MT.prefill(params, {"tokens": toks[:, :prompt_len]},
                                   cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if logits.shape != (prompts, MT.padded_vocab(cfg)) or not bool(
                torch.isfinite(logits[:, :vocab]).all()):
            fail(f"mamba prefill: logits {tuple(logits.shape)} not finite")
        log(f"mamba prefill {prompts} x {prompt_len} (prefill_32k's 32 x "
            f"32,768 cut for time): {prefill_s:.3f} s, "
            f"{prompts * prompt_len / prefill_s:,.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # prefill-then-decode: decode token S after a prefill of S-1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c2, _ = MT.prefill(params, {"tokens": toks[:, :prompt_len - 1]}, cfg)
        torch.cuda.synchronize()
        captured["prefill2_s"] = time.perf_counter() - t0
        step, _ = MT.decode_step(params, c2, toks[:, prompt_len - 1:
                                                  prompt_len], cfg)
        del c2
        a_, b_ = step[:, :vocab].float(), logits[:, :vocab].float()
        gap = (a_ - b_).abs()
        bad = gap > CONSIST["atol"] + CONSIST["rtol"] * b_.abs()
        if bool(bad.any()):
            fail(f"mamba prefill-then-decode: {int(bad.sum())} logits beyond "
                 f"rtol {CONSIST['rtol']} atol {CONSIST['atol']} (max gap "
                 f"{float(gap.max())})")
        log(f"check mamba prefill-then-decode: ok (max |gap| "
            f"{float(gap.max()):.4f}, rtol {CONSIST['rtol']} atol "
            f"{CONSIST['atol']})")

        # decode from the full prefill
        tok = torch.argmax(logits[:, :vocab], -1)[:, None].to(torch.int32)
        walls = []
        for _ in range(decode_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = MT.decode_step(params, cache, tok, cfg)
            tok = torch.argmax(lg[:, :vocab], -1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(lg[:, :vocab]).all()):
                fail("mamba decode: non-finite logits")
        if cache["pos"] != prompt_len - 1 + decode_steps:
            fail(f"mamba decode: position {cache['pos']}")
        w = np.asarray(walls[1:]) * 1e3
        log(f"mamba decode {decode_steps} steps, batch {prompts}: p50 "
            f"{np.percentile(w, 50):.2f} ms p99 {np.percentile(w, 99):.2f} "
            f"ms per step (host wall)")
        del cache

        # the serving engine over two replicas (launch/serve.py defaults)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, reps = serve.serve(cfg, params, device=dev)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        m = eng.metrics()
        steps = sum(r.tokens_generated for r in reps) // reps[0].tokens.shape[0]
        if len(eng.done) != 64 or m.shed or not all(
                bool(torch.isfinite(r.cache["layers"]["ssm"]).all())
                for r in reps):
            fail(f"mamba serving: {len(eng.done)} of 64 requests done")
        log(f"check mamba serving: ok, 64 requests over 2 replicas x 4 "
            f"slots in {eng.now:.0f} ticks, p50 {m.latency_p50:.1f} p99 "
            f"{m.latency_p99:.1f} ticks, {m.throughput_tokens:.2f} tok/tick,"
            f" session replication {m.session_replicas_norm:.2f}x; "
            f"{steps} decode steps in {serve_s:.2f} s "
            f"({serve_s / max(steps, 1) * 1e3:.2f} ms per step)")
    finally:
        ssd.ssd_chunk_state, ssd.ssd_chunk_output = real_state, real_output
        ssm.mamba2_block, ops.ssd_scan = real_block, real_scan
    launches = dict(ssd.LAUNCHES)
    log(f"launches on the mamba path: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the mamba path: {missing}")
    captured["prefill_s"] = prefill_s
    captured["layers"] = cfg.num_layers
    return captured, launches


def ssd_compare(name, got, want):
    """|kernel - plain| within atol + rtol·|plain|, elementwise."""
    g, w = got.double(), want.double()
    gap = (g - w).abs()
    if not bool(g.isfinite().all()) or bool(
            (gap > SSD_TOL["atol"] + SSD_TOL["rtol"] * w.abs()).any()):
        fail(f"{name}: beyond rtol {SSD_TOL['rtol']} atol {SSD_TOL['atol']}"
             f" (max |err| {float(gap.max())})")
    return float(gap.max())


def ssd_kernel_checks(captured, launches, torch):
    from repro_torch.kernels import ssd

    rows = []
    src = "src/repro_torch/csrc/ssd.cu"
    (x, b, a_cum), _ = captured["ssd_chunk_state"]
    bc, q, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    st_k, at_k = ssd.ssd_chunk_state(x, b, a_cum)
    st_p, at_p = ssd.ssd_chunk_state_plain(x, b, a_cum)
    err = max(ssd_compare("ssd_chunk_state states", st_k, st_p),
              ssd_compare("ssd_chunk_state a_tot", at_k, at_p))
    ms = time_cuda(lambda: ssd.ssd_chunk_state(x, b, a_cum), 20, torch)
    pms = time_host(lambda: ssd.ssd_chunk_state_plain(x, b, a_cum), 5, torch)
    nb = 4 * (x.numel() + b.numel() + a_cum.numel() + st_k.numel()
              + at_k.numel())
    rows.append(kernel_row(
        "ssd_chunk_state", src, "src/repro/kernels/ssd.py:51", launches, err,
        ms, pms, nb, bc * h * (2 * q * n * p + q * n + q),
        ops_rate=SSD_OPS))
    log(f"ssd_chunk_state BC={bc} Q={q} H={h} P={p} G={g} N={n}: kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, max|err| {err:.3e}")

    (x, b, c, a_cum, prev), _ = captured["ssd_chunk_output"]
    y_k = ssd.ssd_chunk_output(x, b, c, a_cum, prev)
    y_p = ssd.ssd_chunk_output_plain(x, b, c, a_cum, prev)
    err = ssd_compare("ssd_chunk_output", y_k, y_p)
    ms = time_cuda(lambda: ssd.ssd_chunk_output(x, b, c, a_cum, prev), 20,
                   torch)
    pms = time_host(lambda: ssd.ssd_chunk_output_plain(x, b, c, a_cum, prev),
                    3, torch)
    pairs = q * (q + 1) // 2
    nb = 4 * (x.numel() + b.numel() + c.numel() + a_cum.numel()
              + prev.numel() + y_k.numel())
    # the scores C.B^T depend on the (chunk, group) only: counted once each
    ops = (bc * h * (pairs * (2 * p + 2) + 2 * q * n * p + q * n + q)
           + bc * g * pairs * 2 * n)
    rows.append(kernel_row(
        "ssd_chunk_output", src, "src/repro/kernels/ssd.py:108", launches,
        err, ms, pms, nb, ops, ops_rate=SSD_OPS))
    log(f"ssd_chunk_output BC={bc} Q={q} H={h} P={p}: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, max|err| {err:.3e}")
    return rows


def prefill_split(captured, rows, torch):
    """Where one prefill layer's time goes, with CUDA events on the inputs
    layer 0 of the prefill gave each piece: ``mamba2_block`` whole, its
    ``ssd_scan``, K4 and K5 (their rows), and the scan once more with K4
    and K5 answered from a cache: the rest of the scan (the cross-chunk
    combine loop of ``kernels/ops.py::ssd_scan``, the padding, casts and
    cumsum).  The rest of the block is the projections, the causal conv,
    the float32 elementwise passes and the norm."""
    from repro_torch.kernels import ops, ssd
    from repro_torch.models import ssm

    (p, x_in, cfg_ssm), _ = captured["mamba2_block"]
    args, kw = captured["ssd_scan"]
    block = time_cuda(lambda: ssm.mamba2_block(p, x_in, cfg_ssm), 10, torch)
    scan = time_cuda(lambda: ops.ssd_scan(*args, **kw), 10, torch)
    k4 = next(r["ms"] for r in rows if r["name"] == "ssd_chunk_state")
    k5 = next(r["ms"] for r in rows if r["name"] == "ssd_chunk_output")
    real = ssd.ssd_chunk_state, ssd.ssd_chunk_output
    states = real[0](*captured["ssd_chunk_state"][0])
    y = real[1](*captured["ssd_chunk_output"][0])
    ssd.ssd_chunk_state = lambda *a: states
    ssd.ssd_chunk_output = lambda *a: y
    try:
        rest = time_cuda(lambda: ops.ssd_scan(*args, **kw), 10, torch)
    finally:
        ssd.ssd_chunk_state, ssd.ssd_chunk_output = real
    split = {"layer_ms": block, "ssd_scan_ms": scan,
             "ssd_chunk_state_ms": k4, "ssd_chunk_output_ms": k5,
             "scan_without_k4_k5_ms": rest, "block_rest_ms": block - scan,
             "chunks": -(-args[0].shape[1] // kw["chunk"]),
             "prefill_ms_per_layer": captured["prefill_s"] * 1e3
             / captured["layers"],
             "second_prefill_ms_per_layer": captured["prefill2_s"] * 1e3
             / captured["layers"]}
    log(f"prefill per layer (CUDA events, layer 0's inputs, "
        f"{split['chunks']} chunks): mamba2_block {block:.3f} ms = ssd_scan "
        f"{scan:.3f} (K4 {k4:.3f}, K5 {k5:.3f}; without them {rest:.3f}: "
        f"the combine loop, casts, cumsum) + the rest of the block "
        f"{split['block_rest_ms']:.3f} (projections, conv, elementwise, "
        f"norm); the prefill's wall per layer "
        f"{split['prefill_ms_per_layer']:.3f} ms cold, the second "
        f"prefill's {split['second_prefill_ms_per_layer']:.3f}")
    log(f"prefill split: {json.dumps(split)}")
    return split


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuples", type=int, default=N_TUPLES,
                    help="stream length per scheme (the only allowed cut)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        import numpy as np

        import repro_torch.topology as T
        from repro_torch.data.synthetic import zipf_time_evolving
        from repro_torch.kernels import _build
        from repro_torch.kernels import feed_fused as ff
        from repro_torch.kernels import store_probe as sp
        from repro_torch.state import direct_aggregate
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    # the card's path may never drop to the host engine unseen
    warnings.filterwarnings("error", message="simulate_edge falling back")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"card: {card_line()}")

    # -- build -----------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, one nvcc per source "
        f"in parallel (built: {', '.join(built) or 'none, cached'})")
    for name in _build.BUILD_LOG:
        for kern, r in _build.ptxas_report(name).items():
            log(f"  ptxas[{name}] {kern}: {r['registers']} registers, spill "
                f"stores {r['spill_stores']} B, spill loads "
                f"{r['spill_loads']} B")
    sass = _build.sass_counts("ssd", ("HMMA", "HGMMA"))
    if sass is None:
        log("  sass[ssd]: tensor-core instruction counts not available (no "
            "cuobjdump)")
    else:
        for kern, counts in sass.items():
            log(f"  sass[ssd] {kern}: HMMA {counts['HMMA']}, HGMMA "
                f"{counts['HGMMA']}")
        bare = [k for k, c in sass.items() if not c["HMMA"]]
        if bare or not sass:
            fail(f"SSD kernels without tensor-core instructions: {bare}")

    dev = torch.device("cuda")
    n = args.tuples - args.tuples % FEED if args.tuples >= FEED else args.tuples
    log(f"stream: ZF num_keys={NUM_KEYS} z=1.2 flip_at=0.8 flip_head=10000, "
        f"{n} tuples per scheme, feeds of {FEED}, {WORKERS} workers, "
        f"window {WINDOW} (device store), seed {args.seed}")
    keys = zipf_time_evolving(n, num_keys=NUM_KEYS, z=1.2, flip_at=0.8,
                              flip_head=10_000, seed=args.seed)
    values = np.random.default_rng(args.seed).integers(
        1, 10, n).astype(np.float64)
    feeds = batches(keys, values, T)

    # warm-up (not timed, not counted): CUDA context, library loads and the
    # caching allocator's first growth would otherwise land on SG's feeds
    run_session("fused", "fish", feeds[:2], dev, T, torch)

    # -- the main path, counters from 0 ------------------------------------------
    cap = Capture()
    install_capture(cap)
    syncs = SyncCounter()
    for d in (ff.LAUNCHES, sp.LAUNCHES):
        d.update(dict.fromkeys(d, 0))
    fused, path_a = {}, {}
    for scheme in SCHEMES:
        cap.scheme = scheme
        l0, s0 = dict(ff.LAUNCHES, **sp.LAUNCHES), syncs.n
        rep, wall, walls = run_session("fused", scheme, feeds, dev, T, torch,
                                       syncs)
        fused[scheme] = rep
        w = np.asarray([x for x, _ in walls]) * 1e3
        steady = np.asarray([x for x, f in walls if not f]) * 1e3
        flush = np.asarray([x for x, f in walls if f]) * 1e3
        n_sync = syncs.n - s0
        dl = {k: v - l0[k] for k, v in dict(ff.LAUNCHES,
                                            **sp.LAUNCHES).items()}
        path_a[scheme] = {
            "tuples_per_s": n / wall, "feed_p50_ms": np.percentile(w, 50),
            "feed_p99_ms": np.percentile(w, 99),
            "steady_p50_ms": np.percentile(steady, 50) if steady.size else None,
            "flush_p50_ms": np.percentile(flush, 50) if flush.size else None,
            "steady_feeds": int(steady.size), "flush_feeds": int(flush.size),
            "pane_syncs": n_sync, "launches": dl}
        log(f"fused {scheme:4s}: {n / wall:,.0f} tuples/s, per-feed wall p50 "
            f"{np.percentile(w, 50):.2f} ms p99 {np.percentile(w, 99):.2f} "
            f"ms; steady feeds ({steady.size}) p50 "
            f"{np.percentile(steady, 50) if steady.size else 0:.2f} ms, "
            f"flush feeds ({flush.size}) p50 "
            f"{np.percentile(flush, 50) if flush.size else 0:.2f} ms; "
            f"dispatches {rep.edges[0].dispatches}; {n_sync} pane syncs, "
            f"store_probe launches {dl['store_probe']} "
            f"({dl['store_probe'] / max(n_sync, 1):g} per sync)")
    cap.scheme = None
    log(f"path A per scheme: {json.dumps(path_a)}")
    launches = dict(ff.LAUNCHES)
    launches.update(sp.LAUNCHES)
    log(f"launches on the main path: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # -- fused (card) vs batched (host) + the oracle -------------------------------
    segments = 0
    for b in feeds:  # pane cuts inside each feed (no events on this path)
        lo = int(b.timestamps[0] * RATE + 0.5)
        segments += 1 + sum(1 for c in range(lo + 1, lo + len(b))
                            if c % WINDOW == 0)
    ref = None
    for scheme in SCHEMES:
        rf = fused[scheme]
        rb, wall_b, _ = run_session("batched", scheme, feeds, dev, T, torch)
        if ref is None:
            op = topology(scheme, T).stages[0].operator
            ref = direct_aggregate(keys, op, values=values)
        why = check_exact_or_banded(scheme, rf, rb)
        if why:
            fail(f"{scheme}: fused vs batched: {why}")
        if rf.state["agg"]["merged"] != ref:
            fail(f"{scheme}: merged windows != direct_aggregate")
        if rf.edges[0].dispatches != segments:
            fail(f"{scheme}: dispatches {rf.edges[0].dispatches} != "
                 f"{segments} segments")
        ef, eb = rf.edges[0], rb.edges[0]
        log(f"check {scheme:4s}: ok (batched host {n / wall_b:,.0f} tuples/s)"
            f" exec {ef.execution_time:.6f}/{eb.execution_time:.6f} s, p99 "
            f"{ef.latency_p99:.6f}/{eb.latency_p99:.6f} s, imbalance "
            f"{ef.imbalance:.6f}/{eb.imbalance:.6f}, memory "
            f"{ef.memory_overhead}/{eb.memory_overhead}")

    # -- same-seed double runs ------------------------------------------------------
    for scheme in ("fish", "wc"):
        again, _, _ = run_session("fused", scheme, feeds, dev, T, torch)
        if again.to_dict() != fused[scheme].to_dict():
            fail(f"{scheme}: same-seed double run is not bit-identical")
        log(f"double run {scheme}: bit-identical")

    log(f"path A (stream) done at {time.perf_counter() - t_start:.1f} s")

    # -- path B: the device FISH tracker ------------------------------------------
    fish_cap, fish_launches = fish_path(keys, dev, torch, np)
    log(f"path B (FISH tracker) done at {time.perf_counter() - t_start:.1f} s")

    # -- path C: mamba2-780m at full width ------------------------------------------
    ssd_cap, ssd_launches = mamba_path(args.seed, dev, torch, np)
    ssd_rows = ssd_kernel_checks(ssd_cap, ssd_launches, torch)
    prefill_split(ssd_cap, ssd_rows, torch)
    log(f"path C (mamba2-780m) done at {time.perf_counter() - t_start:.1f} s")

    # path A's and B's kernels last: their device times come from
    # torch.profiler, whose tracing is kept away from the timed paths
    rows = kernel_checks(cap, torch, np, launches)
    log(f"path A kernel checks done at {time.perf_counter() - t_start:.1f} s")
    rows += fish_kernel_checks(fish_cap, fish_launches, torch) + ssd_rows
    log(f"FISH kernel checks done; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
