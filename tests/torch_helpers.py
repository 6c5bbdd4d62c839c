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
