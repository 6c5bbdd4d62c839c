"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Every input is made with numpy from a seed and handed to both packages;
the JAX package runs on the CPU, the port with ``device="cpu"`` (its
kernels' plain PyTorch versions).  Torch is capped at one thread: the
suite runs under several xdist workers.
"""

import numpy as np
import torch

torch.set_num_threads(1)

CPU = "cpu"

# fused f32 device clock vs the f64 host FIFO (tests/test_fused_engine.py)
F32_REL = 1e-4

SCHEMES = ("sg", "fg", "pkg", "dc", "wc", "fish")
EXACT = ("sg", "fg", "pkg")
DRIFT = ("dc", "wc", "fish")

METRICS = ("execution_time", "latency_avg", "latency_p50", "latency_p95",
           "latency_p99", "throughput", "memory_overhead",
           "memory_overhead_norm", "imbalance")


def zf_stream(n=3_000, num_keys=400, z=1.3, seed=0):
    """A small ZF stream (keys) and integer payloads 1-9 (values)."""
    from repro_torch.data.synthetic import zipf_time_evolving

    keys = zipf_time_evolving(n, num_keys=num_keys, z=z, seed=seed)
    values = np.random.default_rng(seed + 5).integers(1, 10, n).astype(
        np.float64)
    return keys, values


def one_stage(T, scheme, op=None, workers=8):
    """source → agg topology in package ``T`` (repro or repro_torch)."""
    return T.Topology(
        name=f"one-{scheme}",
        stages=(T.Stage("agg", workers, operator=op),),
        edges=(T.Edge("source", "agg", T.config_for(scheme)),))


def run_session(T, mode, topo, keys, values=None, feeds=1, events=(),
                rate=2e4, **engine_kw):
    """Feed the stream in ``feeds`` equal record batches; close."""
    sess = T.SimulatorEngine(mode=mode, **engine_kw).open(
        topo, arrival_rate=rate)
    if events:
        sess.advance(events)
    n = keys.shape[0]
    step = -(-n // feeds)
    ts = np.arange(n, dtype=np.float64) / rate
    for lo in range(0, n, step):
        sess.feed(T.RecordBatch(
            keys[lo:lo + step], ts[lo:lo + step],
            None if values is None else values[lo:lo + step]))
    return sess.close()


def assert_within_bands(ep, er):
    """DESIGN.md §6 bands (tests/test_fused_engine.py:114-119)."""
    assert ep.n_tuples == er.n_tuples
    assert abs(ep.execution_time - er.execution_time) <= \
        0.05 * er.execution_time
    assert abs(ep.throughput - er.throughput) <= 0.05 * er.throughput
    assert abs(ep.memory_overhead - er.memory_overhead) <= \
        0.25 * er.memory_overhead
    assert ep.imbalance <= er.imbalance + 0.05
    assert ep.latency_p99 <= max(er.latency_p99 * 10.0, 0.05)


def overfull_pane(case, where):
    """Drive a 64-slot pane table past half load on ``where`` (the card's
    ``pane_update`` or its plain version): a reset call of 33 tuples
    (``reset``); 32 pairs, then 64 new ones (``steady``); 33 entries into a
    fresh table (``from_entries``).  Raises what the path raises, where it
    raises: the caller wraps the call in ``pytest.raises``."""
    from repro_torch.kernels import feed_fused as ff

    d = torch.device(where)
    cap, w1 = 64, 3
    keys_t = torch.full((cap,), -1, dtype=torch.int64, device=d)
    vc = torch.zeros((2, cap), dtype=torch.int32, device=d)
    last = torch.full((w1,), -1, dtype=torch.int32, device=d)
    repl = torch.zeros((200, w1), dtype=torch.bool, device=d)

    def seg(lo, n):  # n distinct (key, worker 1) pairs
        k = torch.arange(lo, lo + n, dtype=torch.int32, device=d)
        w = torch.ones(n, dtype=torch.int32, device=d)
        ff.pane_update(k, w, n, repl=repl, vals=k.clone(), pane_keys=keys_t,
                       pane_vc=vc, pane_last=last, reset=lo == 0)
    if case == "reset":
        seg(0, cap // 2 + 1)
    elif case == "steady":
        seg(0, cap // 2)
        seg(cap // 2, cap)
    else:
        pairs = torch.arange(cap // 2 + 1, dtype=torch.int64, device=d)
        ones = torch.ones(cap // 2 + 1, dtype=torch.int32, device=d)
        keys_t, vc = ff.pane_from_entries(pairs, ones, ones, cap)
    ff.pane_canonical(keys_t, vc)


def chunk_columns(chunks):
    """``ChunkColumns`` from a sequence of ``(keys, values, counts)``: one
    concatenation a column."""
    from repro_torch.state.store import ChunkColumns

    cols = [[np.asarray(c[j], dtype=np.int64) for c in chunks]
            for j in range(3)]
    starts = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.cumsum([k.shape[0] for k in cols[0]], out=starts[1:])
    return ChunkColumns(*(np.concatenate(c) if c else np.empty(0, np.int64)
                          for c in cols), starts)


def pane_entries(entries):
    """``PaneEntries`` from a sequence of ``(worker, keys, values, counts,
    last_index)``, the empty ones left out."""
    from repro_torch.state.window import PaneEntries

    entries = [e for e in entries if e[1].shape[0]]
    ch = chunk_columns([e[1:4] for e in entries])
    return PaneEntries(np.array([int(e[0]) for e in entries], dtype=np.int64),
                       ch.starts, ch.keys, ch.values, ch.counts,
                       np.array([int(e[4]) for e in entries], dtype=np.int64))


def mrope_positions(text0, grid_h, grid_w, s):
    """Qwen2-VL's (3, B, S) position ids (arXiv:2409.12191 §2.1), one row
    per entry of ``text0``: a text prefix of ``text0[r]`` tokens on equal
    streams, one image of grid_h x grid_w merged patches at one temporal
    index (height and width offsets from the prefix), then text from the
    largest position + 1 up to S."""
    rows = []
    for t0 in text0:
        hh, ww = np.meshgrid(np.arange(grid_h), np.arange(grid_w),
                             indexing="ij")
        img = np.stack([np.zeros(grid_h * grid_w, np.int64), hh.ravel(),
                        ww.ravel()]) + t0
        n1 = s - t0 - grid_h * grid_w
        rows.append(np.concatenate([
            np.broadcast_to(np.arange(t0), (3, t0)), img,
            np.broadcast_to(int(img.max()) + 1 + np.arange(n1), (3, n1))],
            axis=1))
    return np.stack(rows, axis=1).astype(np.int32)
