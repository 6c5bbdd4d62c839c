#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Drives the port's nine device paths, each with the launch counters of
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
D. **The time-evolving control plane** on the fused engine, after path C:
   D1 the five RQ4 scenarios of ``default_scenarios`` (hot-key flip,
   straggler onset and recovery, scale-out, failure with elastic
   continue, a churn storm) at 128 workers and 100,000 keys, 262,144
   tuples a run in 16 feeds, a tumbling 65,536-tuple sum window on the
   device store, through ``run_dspe_scenario(engine="fused")`` for all
   six schemes, each held against the batched host engine (SG/FG/PKG
   exact, timing within ``F32_REL``; DC/WC/FISH within the bands; the
   windows exact; remap accounting equal); PKG and FISH sessions run
   under the ``EdgeAuditor`` (launch and sync budgets), and the churn
   storm under FISH twice through ``sanitize.double_run``.  D2 the two
   open-loop scenarios at 100,000 tuples/s from 32 workers, the
   ``P99Autoscaler`` armed up to 128: the admission identity, a scale-out
   in the flash crowd that grows the runner's worker lanes on the card,
   SG/FG/PKG equal to the host engine.  D3 one traced FISH session,
   written through ``TraceWriter``, validated and summarized by span.
E. **The dense decoder family**, after path D (it brings no kernel: its
   attention is plain tensor ops, as the reference's XLA scan; the path
   fails if it calls ``scaled_dot_product_attention`` or
   ``torch.compile``).  E1 qwen1.5-0.5b at its published widths (24
   layers, d_model 1024, 16 heads x 64, vocab 151,936, bf16, random
   weights from the seed): a prefill of 4 x 4,096 (``prefill_32k`` cut
   for time, as path C), the prefill-then-decode check (4,095 tokens, the
   cache placed in one of 4,096 + 32, token 4,096 against the full
   prefill), 32 decode steps at batch 4, and ``ServingEngine`` with
   ``launch/serve.py``'s defaults (``max_seq`` 128, so decodes past the
   cache's end take the reference's clamp).  E2 gemma2-2b at its
   published widths: a prefill of 2 x 8,192 (past the 4,096 window of
   the local layers), the same check at 8,191 -> 8,192, 8 decode steps,
   every real logit within the softcap 30.  E3 the four dense archs at
   ``reduced_config`` in float32, card against host on one set of
   weights, prefill and 4 decode steps within 1e-3.  Then one E1 layer's
   ``flash_attention`` (CUDA events) beside PyTorch's
   ``scaled_dot_product_attention`` on the same float32 q/k/v (a library
   time only).
F. **The MoE family with FISH expert routing**, after path E (no kernel
   either: MoE routing, dispatch, the expert FFN and MLA are plain tensor
   ops, as the reference runs them on XLA; the path fails if a launch
   counter of the repo's kernels moves, or on any
   ``scaled_dot_product_attention`` or ``torch.compile`` call).  F1
   deepseek-v2-lite-16b at its published widths (27 layers, d_model
   2048, MLA r 512 / dn 128 / dr 64 / dv 128, 64 experts top-6 + 2
   shared, one dense prefix layer, vocab 102,400; bf16, random weights
   from the seed): a prefill of 4 x 4,096 (16 dispatch groups of 1,024)
   with its drop fraction, 32 decode steps against 4,128 positions, the
   prefill-then-decode check at 4 x 255 -> 256 on a copy of the config
   with capacity factor 64 (no claim can overflow: drop fraction 0; at
   the published 1.25 a decode step's group of 4 tokens drops what the
   prefill keeps), and ``ServingEngine`` with ``launch/serve.py``'s
   defaults.  F4 one F1 MoE layer's ``moe_ffn`` on its prefill input
   under fish, pkg and fg, from a Zipf(1.2) hotness carried from call to
   call: ``new_hotness`` and the fish capacities equal to the host's
   arithmetic exactly.  F2 kimi-k2-1t-a32b at its published widths cut
   to 2 of 61 layers (its dense prefix layer and one GQA + 384-expert
   layer): a prefill of 4 x 4,096, 8 decode steps.  F3 both archs at
   ``reduced_config`` in float32, card against host: logits within 1e-3,
   every MoE routing's ids and keep equal.
G. **Training, where FISH expert hotness evolves**, after path F (no
   kernel either: the reference trains on XLA; the path fails as F
   does).  G1 qwen1.5-0.5b at its published widths and depth (bf16,
   random weights from the seed): ``TrainLoop`` over 4 FISH-grouped
   hosts, 8 steps of 8 x 2,048 tokens with ``launch/train.py``'s
   optimizer; after step 4 a checkpoint (the reference's format) that a
   fresh loop restores with parameters, m, v and step bit-equal, and
   whose next 2 losses match the uninterrupted run's within 1e-3.  G2
   deepseek-v2-lite-16b at its published widths cut to 4 of 27 layers
   (the dense prefix layer and 3 MoE layers; the whole model's training
   state is 188 GB): 8 steps of 4 x 4,096 (16 dispatch groups of 1,024)
   with the hotness carried; per step and MoE layer the drop fraction and
   load, the counts summing to T·k, the new hotness equal to
   ``alpha·h + counts`` bit for bit, the capacities the uniform split at
   step 1 and the host's CHK of the carried hotness after, the remat
   recompute routing as the forward, and the hotness sums on the float32
   recurrence ``H <- alpha·H + T·k`` within its rounding.  G3
   qwen1.5-0.5b, deepseek-v2-lite-16b and kimi-k2 (its bf16 factored
   state and 8 microbatches) at ``reduced_config`` in float32: one
   ``make_train_step`` on the card against the host, the loss within
   1e-4, routings and hotness equal, the optimizer state within 1e-4.
   Each step's wall, tokens/s, peak GiB and model-flops share, and one
   layer's attention and ``moe_ffn`` forward + backward times (CUDA
   events) are printed beside the card's name and power limit.
H. **The Griffin family** (RG-LRU + local MQA with a ring-buffer decode
   cache), after path G (no kernel either: the reference's RG-LRU scan
   and local attention are XLA; the path fails as G does).  H1
   recurrentgemma-9b at its published widths and depth (38 layers = 12
   x (rec, rec, attn) + 2 rec, d_model 4,096, MQA 16 x 256 over a window
   of 2,048, vocab 256,000, bf16, random weights from the seed;
   8,578,306,048 parameters, checked): a cold and a warm prefill of 4 x
   4,096 (two windows, so the ring continues exactly), the
   prefill-then-decode check against a prefill of 4 x 4,097, 32 decode
   steps within the softcap, ``ServingEngine`` with ``launch/serve.py``'s
   defaults (128-slot rings), then one rec layer's ``rglru_block`` and
   ``_lru_scan`` and one attention layer's ``flash_attention`` beside
   SDPA's (a window mask; a library time only).  H2 the same widths cut
   to 8 of 38 layers (2 groups + a tail of 2; 2,642,628,608 parameters):
   ``TrainLoop``, 4 steps of 4 x 2,048, finite losses, each step's wall,
   tokens/s and peak.  H3 the reduced model (5 layers, window 8) in
   float32 on the card against the host: a prefill of 11 (the ring's
   quirk on) and 8 decode steps (logits within 1e-4, caches 1e-5), one
   ``forward_train`` (loss 1e-5, gradients 1e-4 of each leaf's max).
I. **The frontend stubs**, after path H (no kernel either: the
   reference's encoder, cross attention and M-RoPE are XLA; the path
   fails as H does).  I1 whisper-large-v3 at its published widths and
   depth (32 encoder + 32 decoder layers, d_model 1,280, 20 heads x 64,
   vocab 51,866, no positional signal, bf16, random weights from the
   seed; 1,602,237,440 parameters, checked): the encoder over 4 x 1,500
   frame embeddings (the 30 s window after the stubbed conv), a cold and
   a warm prefill of 4 x 416 tokens, the check (415 + 1 -> 416), 32
   decode steps to the published 448 positions, then one encoder layer's
   non-causal ``flash_attention`` beside SDPA's (a library time only)
   and its forward + backward.  I2 qwen2-vl-2b at its published widths
   and depth (28 layers, d_model 1,536, GQA 12 / 2 x 128, M-RoPE (16,
   24, 24), vocab 151,936; 1,777,088,000 parameters, checked): a cold
   and a warm prefill of 4 x 4,096 embeddings with Qwen2-VL's positions
   (a 512-token prefix, one 56 x 56 image, text after), the check (one
   decode step at the reference's position (S, S, S) against a prefill of
   4,097 that ends there), 32 decode steps by token.  I3 both trained
   through ``make_train_step``: whisper 4 x (1,500 frames + 448 tokens),
   qwen2-vl 4 x 2,048 in 2 microbatches (the (3, B, S) positions cut on
   B), 4 steps each, finite losses, each step's wall, tokens/s and peak.
   I4 both reduced in float32 on the card against the host (qwen2-vl
   also with sections (4, 6, 6)): a prefill of 16, 8 decode steps, one
   ``forward_train``, within H3's bounds.

Every kernel is built from ``src/repro_torch/csrc`` first (one ``nvcc``
per source, started together; ptxas's registers and spills per kernel and
the tensor-core instructions in the SSD library's SASS are printed), and
at the end each kernel's wrapper is called on the inputs its path gave
it, held against its plain PyTorch version and timed beside it (the
stream's and the FISH tracker's kernels last, after paths C and D, with a
device-only time from ``torch.profiler`` beside the CUDA-event time of
back-to-back calls); path C also prints where one prefill layer's time
goes.

Usage: ``python3 chip_smoke.py [--tuples N] [--scenario-tuples M]
[--seed S]`` from the root of a checkout (``--tuples`` cuts the stream of
paths A and B, ``--scenario-tuples`` each scenario run of path D).  Needs one
card; exits non-zero with no result without one or outside a checkout.
The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it names the card and its power limit, and a ``{"kernels": [...]}`` line
before that carries each kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import contextlib
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
FLOAT_TOL = 1e-6     # kernel vs plain, relative, float outputs (expect 0)
HBM_BPS = 3.35e12    # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS = 67e12      # H100 SXM float32 / int32-class ops outside tensor cores
BF16_OPS = 989e12    # H100 SXM dense bf16 on the tensor cores
TF32_OPS = 495e12    # H100 SXM dense TF32 on the tensor cores
SSD_OPS = TF32_OPS / 3   # the SSD kernels: 3 TF32 products (3xTF32) each
# dependency-chain bounds, in SM cycles per dependent step on one warp, as
# tools/chain_probe.py measures them on the H100: route_scan's register
# chain (two dependent redux.sync minima and the owner's select) 112.8; an
# f64 max + add (fifo_workers' step) 33.2
REG_STEP_CYCLES = 113
F64_STEP_CYCLES = 33
FISH_WORKERS = 128   # classify_hot_keys
FISH_TOP = 20        # hot-set size held against the sequential tracker
FISH_JACCARD = 0.6   # tests/test_batched_engine.py:273
FISH_CAPTURE = 100   # epoch whose kernel inputs are kept (a full table)
PROMPTS, PROMPT_LEN = 4, 4_096   # prefill_32k (32 x 32,768), cut for time
DECODE_STEPS = 32
CONSIST = dict(rtol=0.08, atol=0.35)   # tests/test_models_smoke.py:98-102
SSD_TOL = dict(rtol=3e-4, atol=3e-4)   # tests/test_kernels.py:84-87
D_TUPLES = 262_144   # path D: tuples a scenario run (path A's, halved)
D_FEEDS = 16         # path D: feeds a scenario run
D_AUDITED = ("pkg", "fish")   # path D: schemes run under the EdgeAuditor
OL_WORKERS, OL_MAX_WORKERS = 32, 128   # D2: the autoscaler's rails
OL_RATE = 100_000.0  # D2: mean offered tuples/s (~5,000 a 0.05 s tick)
OL_HORIZON = 4.0     # D2: seconds of arrivals
OL_SLO_P99 = 0.05    # D2: the autoscaler's p99 target, s
E2_PROMPTS, E2_LEN = 2, 8_192   # E2: gemma2-2b, past its 4,096 window
E2_DECODE = 8        # E2: decode steps after the consistency step
E3_LEN = 40          # E3: prompt, past the reduced gemma2's window of 32
E3_TOL = 1e-3        # E3: card vs host, float32 (tests/test_torch_dense.py)
F1_CHECK_LEN = 256   # F1: the check's 4 x 255 -> 256 (groups divide 1,020)
F2_DECODE = 8        # F2: decode steps after kimi-k2's prefill
F3_LEN = 64          # F3: prompt, two dispatch groups of the reduced 64
G_STEPS = 8          # G1, G2: train steps
G1_BATCH, G1_SEQ = 8, 2_048     # G1: qwen1.5-0.5b, 16,384 tokens a step
G1_SAVE = 4          # G1: the step whose checkpoint a fresh loop restores
G1_RESUME_TOL = 1e-3  # G1: resumed losses vs the uninterrupted run's
G2_BATCH, G2_SEQ = 4, 4_096     # G2: deepseek-v2-lite, 16 groups of 1,024
G2_LAYERS = 4        # G2: the dense prefix layer + 3 MoE layers of 27
G3_BATCH, G3_SEQ = 8, 64        # G3: 8 microbatches of kimi-k2's accum 8
G3_TOL = 1e-4        # G3: card vs host, float32, relative
H1_PROMPTS, H1_LEN = 4, 4_096    # H1: 2 windows of 2,048; prefill_32k cut
H1_PARAMS = 8_578_306_048        # recurrentgemma-9b (a jax.eval_shape count)
H2_LAYERS, H2_PARAMS = 8, 2_642_628_608   # H2: 2 groups + a tail of 2
H2_BATCH, H2_SEQ, H2_STEPS = 4, 2_048, 4
H3_LEN = 11          # H3: prompt, not a multiple of the reduced window 8
H3_TOL = {"logits": 1e-4, "cache": 1e-5, "loss": 1e-5, "grad": 1e-4}
I1_PARAMS = 1_602_237_440        # whisper-large-v3 (a jax.eval_shape count)
I1_PROMPTS, I1_LEN = 4, 416      # I1: 32 decode steps short of 448
I2_PARAMS = 1_777_088_000        # qwen2-vl-2b (a jax.eval_shape count)
I2_PROMPTS, I2_LEN = 4, 4_096    # I2: prefill_32k cut for time
I2_TEXT0, I2_GRID = 512, 56      # I2: a text prefix, one 56 x 56 image
I3_STEPS = 4                     # I3: train steps of each arch
I3_WHISPER = (4, 448)            # I3: 4 x (1,500 frames + 448 tokens)
I3_QWEN = (4, 2_048, 2, 32)      # I3: 4 x 2,048, grad_accum 2, 32 x 32 image
I4_LEN, I4_DECODE = 16, 8        # I4: reduced, card vs host (H3_TOL)

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
            if (self.scheme is not None and key not in self.calls
                    and want(args, kwargs)):
                # the runner's registry counters stay with the runner
                self.calls[key] = (tuple(self._clone(a) for a in args),
                                   {k: self._clone(v)
                                    for k, v in kwargs.items()
                                    if k != "chains"})
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
        if cap.scheme is not None and key not in cap.calls and \
                runner.pane_fed:
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
    """The fused report against the batched one on the same stream: the
    contract of ``analysis.contracts`` (SG/FG/PKG exact, timing within
    ``F32_REL``; DC/WC/FISH within the DESIGN.md §6 bands), and for the
    exact schemes the merged windows."""
    from repro_torch.analysis.contracts import EXACT_SCHEMES, row_violations

    ef, eb = rf.edges[0], rb.edges[0]
    why = row_violations(scheme, dict(ef.row(), n_tuples=ef.n_tuples),
                         dict(eb.row(), n_tuples=eb.n_tuples))
    if scheme in EXACT_SCHEMES and \
            rf.state["agg"]["merged"] != rb.state["agg"]["merged"]:
        why.append("merged windows differ from the batched engine")
    return "; ".join(why) or None


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

    # tracker_segment: FISH's segment; DC and WC checked too, bit for bit
    def run_tracker(fn, call):
        (trk, carry, keys, m), kw = clone_call(call)
        fv, tot, top = fn(trk, carry, keys, m, **kw)
        return fv, tot, top, trk, carry

    def plain_tracker(trk, carry, keys, m, **k):
        return ff.tracker_update_plain(trk, carry, keys, m, k["g0"],
                                       k["epoch"], k["pre"], k["ne"],
                                       k["alpha"])
    err = 0.0
    for s in ("dc", "wc", "fish"):
        call = seg["tracker_update"][s]
        err = max(err, compare(
            run_tracker(ff.tracker_update, call),
            run_tracker(plain_tracker, call),
            (f"fv[{s}]", f"tot[{s}]", f"top[{s}]", f"trk[{s}]",
             f"carry[{s}]")))
    if err != 0.0:
        fail(f"tracker_segment: not bit for bit its plain version ({err})")
    trk_dev = {}
    for s in ("fish", "dc"):
        (trk, carry, keys, m), kw = clone_call(seg["tracker_update"][s])
        trk0, carry0 = trk.clone(), carry.clone()

        def restore(trk=trk, carry=carry, trk0=trk0, carry0=carry0):
            trk.copy_(trk0)
            carry.copy_(carry0)
        # device ms: each call on the tracker as the segment found it (the
        # restore left out); card ms: back-to-back calls
        trk_dev[s] = dtime(f"tracker_segment {s}", lambda: ff.tracker_update(
            trk, carry, keys, m, **kw), setup=restore, keep="tracker_segment")
    (trk, carry, keys, m), kw = clone_call(seg["tracker_update"]["fish"])
    trk0 = trk.clone()
    ms = time_cuda(lambda: ff.tracker_update(trk, carry, keys, m, **kw), 50,
                   torch)
    trk.copy_(trk0)
    pms = time_host(lambda: plain_tracker(trk.clone(), carry.clone(), keys,
                                          m, **kw), 3, torch)
    kcap1, ne = trk.shape[0], kw["ne"]
    # library yardstick: the segment's per-key tuple count as one index_add_
    cnt = torch.zeros(kcap1, dtype=torch.int32, device=keys.device)
    ones = torch.ones(m, dtype=torch.int32, device=keys.device)
    lib_ms = time_cuda(lambda: cnt.index_add_(0, keys[:m].long(), ones), 50,
                       torch)
    # operations this run's data needs: the dense pass's multiplications
    # (each key's stop at its fixed point, at most pre + ne - 1), and per
    # tuple a count, per (key, epoch) pair a decay and an add
    alpha = torch.tensor(kw["alpha"], dtype=torch.float32, device=trk.device)
    x, live, mults = trk0.clone(), torch.ones_like(trk0, dtype=torch.bool), 0
    for _ in range(kw["pre"] + ne - 1):
        mults += int(live.sum())
        y = x * alpha
        live &= y != x
        x = torch.where(live, y, x)
    j = torch.arange(m, device=keys.device)
    if kw["epoch"]:
        j = (kw["g0"] + j) // kw["epoch"] - kw["g0"] // kw["epoch"]
    pairs = int(torch.unique(j * kcap1 + keys[:m].long()).shape[0])
    uniq = int(torch.unique(keys[:m]).shape[0])
    log2k, log2p = ff._tracker_tables(m, kcap1)
    log2c, glob = ff._tracker_plan(trk.device, log2k, log2p)
    where = "global" if glob else "shared"
    # the key table, the pair table and the blocks' local tables
    table_bytes = ((ff._TRK_KEY_BYTES << log2k)
                   + 2 * (ff._TRK_PAIR_BYTES << log2p))
    # bytes: trk read and written once, each tuple's key in and value
    # out, tot/top out, the carry in and out
    row("tracker_segment", src_ff, "src/repro/kernels/feed_fused.py:251",
        err, ms, pms, 8 * kcap1 + 8 * m + 8 * ne + 16,
        mults + m + 2 * pairs, lib_ms, device=trk_dev["fish"],
        device_ms_dcwc=trk_dev["dc"][0], pairs=pairs, keys=uniq,
        cluster=1 << log2c, tables=where,
        was=["tracker_count", "tracker_fold"])
    log(f"tracker_segment kcap1={kcap1} epochs={ne} m={m} ({uniq} keys, "
        f"{pairs} (key, epoch) pairs), cluster of {1 << log2c}, "
        f"tables in {where} memory: kernel "
        f"{ms:.4f} ms, device FISH {trk_dev['fish'][0]:.5f} ms, DC "
        f"{trk_dev['dc'][0]:.5f} ms, plain {pms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, max|err| {err}")
    # the tracker's state per edge, from the tensors: trk and its carry;
    # per segment the outputs and the tables (in the cluster's shared
    # memory where they fit, not device memory)
    fv, tot, top = ff.tracker_update(trk, carry, keys, m, **kw)
    state = trk.numel() * 4 + carry.numel() * 4
    per_seg = fv.numel() * 4 + tot.numel() * 4 + top.numel() * 4
    log(f"tracker bytes per edge: {state:,} (trk {tuple(trk.shape)}, carry "
        f"{tuple(carry.shape)}), per FISH segment {per_seg:,} (fv "
        f"{tuple(fv.shape)}, tot and top {tuple(tot.shape)}) + tables "
        f"{table_bytes:,} in {where} memory")

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
        "fish", m, kw["keys"], kw["rows"], None, 0, 0, kw["fv"], kw["tot"],
        kw["top"], kw["g0"], kw["epoch"], kw["theta"], kw["wnum"],
        kw["m_k"], kw["d_min"])
    d_sum = int(np.minimum(d, width).sum())
    wide = int((np.minimum(d, width) > 2).sum())
    chain = m * REG_STEP_CYCLES / (clock * 1e3)
    row("route_scan", src_ff, "src/repro/kernels/feed_fused.py:237,276,307",
        err_r, route_ms["fish"], pms, 4 * d_sum + 20 * m + 4 * 8 * w1,
        3 * d_sum + 2 * m, chain_bound_ms=chain, device=dev_rs)
    log(f"route_scan    fish: device {dev_rs[0]:.4f} ms; {wide} of {m} "
        f"tuples take the wide argmin, "
        f"Σ min(d, width) = {d_sum}; chain bound {chain:.4f} ms ({m} x "
        f"{REG_STEP_CYCLES} cycles at {clock:.0f} MHz); plain {pms:.1f} ms "
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
    ops, kept_us = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = ops.get(e.name[:40], (0, 0.0))
            ops[e.name[:40]] = (n + 1, us + e.time_range.elapsed_us())
            if keep in e.name:  # the whole name: templates run long
                kept_us += e.time_range.elapsed_us()
    ops = {k: (n / reps, us / 1e3 / reps) for k, (n, us) in ops.items()
           if us > 0}
    if ops:
        log(f"  {name}: device ops per call (count, ms) {json.dumps(ops)}")
        if not kept_us:
            fail(f"{name}: no device operation named {keep!r} in the trace")
        return kept_us / 1e3 / reps, "profiler"
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
        consistency("mamba", step, logits, vocab)

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


def ssd_device_times(captured, rows, torch):
    """K4's and K5's device-only ms on path C's captured inputs, into
    their rows (taken after every host-timed phase: a profiler session
    slows later host-bound launches)."""
    from repro_torch.kernels import ssd

    for name, keep, fn in (("ssd_chunk_state", "ssd_state",
                            ssd.ssd_chunk_state),
                           ("ssd_chunk_output", "ssd_output",
                            ssd.ssd_chunk_output)):
        args = captured[name][0]
        ms, how = device_time(name, lambda: fn(*args), 20, torch, keep=keep)
        next(r for r in rows if r["name"] == name).update(device_ms=ms,
                                                          device_by=how)
        log(f"{name}: device {ms:.4f} ms ({how})")


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


# ---------------------------------------------------------------------------
# path E: the dense decoder family at full width
# ---------------------------------------------------------------------------


def consistency(what, step, full, vocab):
    """Decoding token S after a prefill of S-1 gives the S-token prefill's
    last logits within ``CONSIST``; returns the largest gap."""
    a, b = step[:, :vocab].float(), full[:, :vocab].float()
    gap = (a - b).abs()
    bad = gap > CONSIST["atol"] + CONSIST["rtol"] * b.abs()
    if bool(bad.any()):
        fail(f"{what} prefill-then-decode: {int(bad.sum())} logits beyond "
             f"rtol {CONSIST['rtol']} atol {CONSIST['atol']} (max gap "
             f"{float(gap.max())})")
    log(f"check {what} prefill-then-decode: ok (max |gap| "
        f"{float(gap.max()):.4f}, rtol {CONSIST['rtol']} atol "
        f"{CONSIST['atol']})")
    return float(gap.max())


def dense_prefill(what, MT, params, cfg, toks, torch):
    """One timed prefill of ``toks`` (B, S), or of a whole batch dict (the
    frontend stubs'); fails on logits not finite or misshapen."""
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    b = batch["embeds" if "embeds" in batch else "tokens"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, logits = MT.prefill(params, batch, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if logits.shape != (b, MT.padded_vocab(cfg)) or not bool(
            torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        fail(f"{what} prefill: logits {tuple(logits.shape)} not finite")
    return cache, logits, wall, torch.cuda.max_memory_allocated() / 2**30


def dense_decode(what, MT, params, cfg, cache, tok, steps, torch, np,
                 cap=None):
    """``steps`` greedy decode steps, each synchronized and timed; fails
    on non-finite logits or, with ``cap``, a real logit beyond it."""
    vocab, walls = cfg.vocab_size, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = MT.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(lg[:, :vocab], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        real = lg[:, :vocab]
        if not bool(torch.isfinite(real).all()):
            fail(f"{what} decode: non-finite logits")
        if cap is not None and float(real.abs().max()) > cap + 1e-3:
            fail(f"{what} decode: |logit| {float(real.abs().max())} beyond "
                 f"the softcap {cap}")
    w = np.asarray(walls) * 1e3
    log(f"{what} decode {steps} steps, batch {tok.shape[0]}, to position "
        f"{cache['pos']}: p50 {np.percentile(w, 50):.2f} ms p99 "
        f"{np.percentile(w, 99):.2f} ms per step (host wall, "
        f"synchronized); card {card_line()}")
    return cache


def dense_path(seed, dev, torch, np):
    """E1 qwen1.5-0.5b and E2 gemma2-2b at their published widths, E3 the
    four dense archs on the card against the host.  Returns E1's first
    prefill's layer-0 ``flash_attention`` call (args, kwargs) for the
    timing line.  Fails if anything on the path calls PyTorch's fused
    attention or ``torch.compile``."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as MT

    captured = {}
    real_flash = MT.flash_attention

    def flash(*args, **kwargs):
        if "flash_attention" not in captured:  # E1's layer 0
            captured["flash_attention"] = (
                tuple(a.clone() for a in args), dict(kwargs))
        return real_flash(*args, **kwargs)

    MT.flash_attention = flash
    try:
        with no_fused_attention("E", torch):
            _dense_e1(seed, dev, torch, np, MT, serve, get_config)
            _dense_e2(seed, dev, torch, np, MT, get_config)
            # E3: the card against the host on one set of float32 weights
            for arch in ("qwen1.5-0.5b", "starcoder2-3b", "olmo-1b",
                         "gemma2-2b"):
                cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                          dtype="float32")
                card_vs_host(f"E3 {arch}", MT, cfg, seed, dev, torch, np,
                             E3_LEN)
    finally:
        MT.flash_attention = real_flash
    return captured["flash_attention"]


def card_vs_host(what, MT, cfg, seed, dev, torch, np, n, probe=None):
    """``cfg`` (reduced, float32) on the card and on the host, one set of
    weights: a prefill of 2 x ``n`` tokens, then 4 decode steps, every
    logit within ``E3_TOL``.  With an ``MoEProbe``, each MoE routing's ids
    and keep must also be equal on both."""
    import copy

    host = MT.init_params(cfg, seed=seed, device="cpu")
    card = copy.deepcopy(host).to(dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, n + 4)).astype(np.int32))
    runs, routes = [], []
    for params, where in ((card, dev), (host, "cpu")):
        if probe is not None:
            probe.clear()
        t = toks.to(where)
        cache, lg = MT.prefill(params, {"tokens": t[:, :n]}, cfg)
        cache = MT.grow_cache(cfg, cache, n + 4)
        out = [lg]
        for i in range(n, n + 4):
            lg, cache = MT.decode_step(params, cache, t[:, i:i + 1], cfg)
            out.append(lg)
        runs.append([x[:, :cfg.vocab_size].cpu() for x in out])
        if probe is not None:
            routes.append([(ids.cpu(), keep.cpu())
                           for ids, keep, _ in probe.routes])
    gaps = []
    for a, b in zip(*runs):
        gap = (a - b).abs()
        gaps.append(float(gap.max()))
        if bool((gap > E3_TOL * (1.0 + b.abs())).any()):
            fail(f"{what}: card vs host max |gap| {float(gap.max())} beyond "
                 f"{E3_TOL}")
    tail = ""
    if probe is not None:
        diff = sum(int((a != b).sum()) for ra, rb in zip(*routes)
                   for a, b in zip(ra, rb))
        if len(routes[0]) != len(routes[1]) or not routes[0] or diff:
            fail(f"{what}: card vs host routing: {len(routes[0])} / "
                 f"{len(routes[1])} MoE routings, {diff} ids/keep "
                 f"differences")
        tail = (f"; {len(routes[0])} MoE routings, ids/keep differences "
                f"{diff}")
    log(f"check {what} (reduced, float32, prefill 2 x {n} + 4 decode "
        f"steps): card vs host ok, max |gap| prefill {gaps[0]:.2e}, decode "
        f"{max(gaps[1:]):.2e} (tol {E3_TOL}){tail}")


@contextlib.contextmanager
def no_fused_attention(path, torch):
    """Counts every call of PyTorch's fused attention and of
    ``torch.compile`` inside; the path fails if there was one."""
    import torch.nn.functional as F

    banned = {"scaled_dot_product_attention": 0, "compile": 0}
    real_sdpa, real_compile = F.scaled_dot_product_attention, torch.compile

    def ban(name, fn):
        def call(*args, **kwargs):
            banned[name] += 1
            return fn(*args, **kwargs)
        return call

    F.scaled_dot_product_attention = ban("scaled_dot_product_attention",
                                         real_sdpa)
    torch.compile = ban("compile", real_compile)
    try:
        yield
    finally:
        F.scaled_dot_product_attention = real_sdpa
        torch.compile = real_compile
    if any(banned.values()):
        fail(f"path {path} called a fused attention or torch.compile: "
             f"{banned}")
    log(f"path {path}: scaled_dot_product_attention and torch.compile "
        f"called 0 times")


def serve_check(what, MT, serve, params, cfg, dev, torch):
    """``ServingEngine`` through ``launch/serve.py``'s ``serve`` with its
    defaults (FISH, 2 replicas x 4 slots, 64 requests, ``max_seq`` 128):
    every request served, every logit finite (checked on the device, read
    once at the end); decodes past the cache's end take the reference's
    clamp, and are counted (Griffin's: those that wrap its ring)."""
    vocab = cfg.vocab_size
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    real_step = MT.decode_step

    def checked(*args, **kwargs):
        lg, c = real_step(*args, **kwargs)
        bad.add_((~torch.isfinite(lg[:, :vocab])).sum())
        return lg, c

    MT.decode_step = checked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, reps = serve.serve(cfg, params, device=dev)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        MT.decode_step = real_step
    m = eng.metrics()
    steps = sum(r.tokens_generated for r in reps) // reps[0].tokens.shape[0]
    if cfg.rglru is not None:
        max_seq = reps[0].cache["attn"][0].shape[2]
        past = (f"at pos >= its ring's {max_seq} slots (written at pos % "
                f"{max_seq})")
    else:
        max_seq = reps[0].cache["layers"][0].shape[MT._seq_axis(cfg)]
        past = f"at pos >= max_seq {max_seq} (the reference's clamp)"
    clamped = sum(max(0, r.cache["pos"] + 1 - max_seq) for r in reps)
    if len(eng.done) != 64 or m.shed or int(bad):
        fail(f"{what} serving: {len(eng.done)} of 64 requests done, "
             f"{int(bad)} non-finite logits")
    log(f"check {what} serving: ok, 64 requests over 2 replicas x 4 slots "
        f"in {eng.now:.0f} ticks, p50 {m.latency_p50:.1f} p99 "
        f"{m.latency_p99:.1f} ticks, {m.throughput_tokens:.2f} tok/tick, "
        f"session replication {m.session_replicas_norm:.2f}x; {steps} "
        f"decode steps in {serve_s:.2f} s ({serve_s / max(steps, 1) * 1e3:.2f}"
        f" ms per step), {clamped} of them {past}, every logit finite; card "
        f"{card_line()}")


def _dense_e1(seed, dev, torch, np, MT, serve, get_config):
    cfg = get_config("qwen1.5-0.5b")
    vocab, prompts, n = cfg.vocab_size, PROMPTS, PROMPT_LEN
    params = MT.init_params(cfg, seed=seed, device=dev)
    log(f"E1 qwen1.5-0.5b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {vocab}, {cfg.dtype}: "
        f"{MT.num_params(params):,} parameters, random init (seed {seed})")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (prompts, n + 1)).astype(np.int32)).to(dev)
    _, full, wall, peak = dense_prefill("E1", MT, params, cfg, toks[:, :n],
                                        torch)
    log(f"E1 prefill {prompts} x {n} (prefill_32k's 32 x 32,768 cut for "
        f"time): {wall:.3f} s, {prompts * n / wall:,.0f} tokens/s, peak "
        f"{peak:.2f} GiB")
    cache, _, wall2, _ = dense_prefill("E1", MT, params, cfg,
                                       toks[:, :n - 1], torch)
    cache = MT.grow_cache(cfg, cache, n + DECODE_STEPS)
    step, cache = MT.decode_step(params, cache, toks[:, n - 1:n], cfg)
    consistency("E1 qwen1.5-0.5b", step, full, vocab)
    log(f"E1 second prefill {prompts} x {n - 1}: {wall2:.3f} s, "
        f"{prompts * (n - 1) / wall2:,.0f} tokens/s")
    tok = torch.argmax(step[:, :vocab], -1)[:, None].to(torch.int32)
    cache = dense_decode("E1", MT, params, cfg, cache, tok, DECODE_STEPS,
                         torch, np)
    if cache["pos"] != n - 1 + DECODE_STEPS:
        fail(f"E1 decode: position {cache['pos']}")
    del cache, full, step

    serve_check("E1", MT, serve, params, cfg, dev, torch)


def _dense_e2(seed, dev, torch, np, MT, get_config):
    cfg = get_config("gemma2-2b")
    vocab, prompts, n, cap = cfg.vocab_size, E2_PROMPTS, E2_LEN, \
        cfg.logit_softcap
    params = MT.init_params(cfg, seed=seed, device=dev)
    log(f"E2 gemma2-2b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, "
        f"windows {cfg.local_global_pattern} of {cfg.sliding_window}, "
        f"softcaps {cfg.attn_softcap} / {cap}, tied head, {cfg.dtype}: "
        f"{MT.num_params(params):,} parameters, random init (seed {seed})")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, vocab, (prompts, n)).astype(np.int32)).to(dev)
    _, full, wall, peak = dense_prefill("E2", MT, params, cfg, toks, torch)
    if float(full[:, :vocab].abs().max()) > cap + 1e-3:
        fail(f"E2 prefill: |logit| beyond the softcap {cap}")
    log(f"E2 prefill {prompts} x {n} (past the {cfg.sliding_window} window"
        f" of the local layers): {wall:.3f} s, {prompts * n / wall:,.0f} "
        f"tokens/s, peak {peak:.2f} GiB")
    cache, _, _, _ = dense_prefill("E2", MT, params, cfg, toks[:, :n - 1],
                                   torch)
    cache = MT.grow_cache(cfg, cache, n + E2_DECODE)
    step, cache = MT.decode_step(params, cache, toks[:, n - 1:n], cfg)
    consistency("E2 gemma2-2b", step, full, vocab)
    tok = torch.argmax(step[:, :vocab], -1)[:, None].to(torch.int32)
    dense_decode("E2", MT, params, cfg, cache, tok, E2_DECODE, torch, np,
                 cap=cap)
    log(f"check E2 gemma2-2b softcap: ok, every real logit within "
        f"{cap} + 1e-3")


def attention_times(what, call, torch):
    """One layer's ``flash_attention`` (CUDA events) beside PyTorch's
    ``scaled_dot_product_attention`` on the same float32 q/k/v (the kv
    heads repeated to the query heads; a window as a boolean mask), as a
    library time only, with the bound of the causal (windowed) work, or of
    every (query, key) pair for a non-causal call."""
    import torch.nn.functional as F

    from repro_torch.models import attention as attn

    (q, k, v), kw = call
    b, s, hq, dh = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    ms = time_cuda(lambda: attn.flash_attention(q, k, v, **kw), 5, torch)
    out = attn.flash_attention(q, k, v, **kw).float()
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (kf, vf))
    scale = kw.get("scale") or 1.0 / dh ** 0.5
    window, causal = kw.get("window"), kw.get("causal", True)
    if not causal:  # every query sees every key
        mask, pairs = {}, s * k.shape[1]
    elif window is None:
        mask = {"is_causal": True}
        pairs = s * (s + 1) / 2  # the causal half
    else:
        rel = torch.arange(s, device=q.device)
        rel = rel[:, None] - rel[None, :]
        mask = {"attn_mask": (rel >= 0) & (rel < window)}
        w = min(window, s)  # query i sees min(i + 1, window) keys
        pairs = w * (w + 1) / 2 + (s - w) * w

    def sdpa():
        return F.scaled_dot_product_attention(qf, kf, vf, scale=scale,
                                              **mask)

    lib_ms = time_cuda(sdpa, 5, torch)
    gap = float((sdpa().transpose(1, 2) - out).abs().max())
    # QK^T and PV over the (key, query) pairs the mask keeps
    ops = 2.0 * b * hq * (dh + dv) * pairs
    bytes_ = q.element_size() * (q.numel() + k.numel() + v.numel() +
                                 b * s * hq * dv)  # + the output
    bound = max(ops / F32_OPS, bytes_ / HBM_BPS) * 1e3
    row = {"what": f"flash_attention, {what}",
           "shape": [b, s, hq, hkv, dh, dv], "block_k": kw.get("block_k"),
           "window": window, "causal": causal,
           "ms": ms, "sdpa_f32_ms": lib_ms, "sdpa_max_abs_gap": gap,
           "bound_ms": bound, "bound_by": "operations"
           if ops / F32_OPS >= bytes_ / HBM_BPS else "bytes"}
    log(f"attention {what} ({b} x {s}, {hq} q / {hkv} kv heads x {dh} / "
        f"{dv}, window {window}, block_k {kw.get('block_k')}"
        f"{'' if causal else ', non-causal'}): "
        f"flash_attention {ms:.3f} ms (CUDA events); "
        f"scaled_dot_product_attention float32 {lib_ms:.3f} ms (library "
        f"time only, max |gap| {gap:.2e}); bound {bound:.3f} ms "
        f"({'causal ' if causal else ''}float32 operations at "
        f"{F32_OPS / 1e12:.0f} TFLOP/s); card {card_line()}")
    log(f"attention: {json.dumps(row)}")


# ---------------------------------------------------------------------------
# path F: the MoE family with FISH expert routing (MLA and GQA)
# ---------------------------------------------------------------------------


class MoEProbe:
    """Wraps the port's ``moe_ffn`` where the model calls it and
    ``_route`` where ``moe_ffn`` calls it.  While ``record`` is set, keeps
    each ``moe_ffn`` call's metrics and (hotness, new hotness) and each
    ``_route`` call's (ids, keep, capacities), all left on the device
    (under training's remat a layer's calls come twice: the forward's,
    then the backward's recompute); while ``capture`` is set, the
    first ``moe_ffn`` call's tokens and the first ``flash_attention``
    call (args, kwargs).  While ``pinned`` holds a list of (G, T, K) ids,
    each ``_route`` call takes the next as its top-k choices, in place of
    its own, with its own gates at those ids."""

    def __init__(self, MT, MM):
        self.MT, self.MM = MT, MM
        self.metrics, self.routes, self.hotness = [], [], []
        self.first_x = self.flash = self.pinned = None
        self.record = self.capture = True

    def __enter__(self):
        real_ffn, real_route, real_flash = self.real = (
            self.MT.moe_ffn, self.MM._route, self.MT.flash_attention)

        def flash(*args, **kwargs):
            if self.capture and self.flash is None:
                self.flash = (tuple(a.detach().clone() for a in args),
                              dict(kwargs))
            return real_flash(*args, **kwargs)

        def ffn(params, x, moe, hotness):
            if self.capture and self.first_x is None:
                self.first_x = x.detach().clone()
            out = real_ffn(params, x, moe, hotness)
            if self.record:
                self.metrics.append(out[3])
                self.hotness.append((hotness.clone(), out[1].clone()))
            return out

        def route(gates, moe, capacities):
            if self.pinned is None:
                out = real_route(gates, moe, capacities)
            else:
                ids, real_top_k = self.pinned.pop(0), self.MM._top_k
                self.MM._top_k = lambda g, k: (g.gather(-1, ids), ids)
                try:
                    out = real_route(gates, moe, capacities)
                finally:
                    self.MM._top_k = real_top_k
            if self.record:
                self.routes.append((out[0], out[2], capacities))
            return out

        self.MT.moe_ffn, self.MM._route, self.MT.flash_attention = (
            ffn, route, flash)
        return self

    def __exit__(self, *exc):
        self.MT.moe_ffn, self.MM._route, self.MT.flash_attention = self.real

    def clear(self):
        self.metrics.clear()
        self.routes.clear()
        self.hotness.clear()

    def metric(self, name, torch):
        """One metric of every recorded call, on the host."""
        return torch.stack([m[name] for m in self.metrics]).float().cpu()


def moe_path(seed, dev, torch, np):
    """F1 deepseek-v2-lite-16b at its published widths, F4 FISH expert
    routing on one F1 MoE layer, F2 kimi-k2's dense prefix layer and one
    GQA + MoE layer at their published widths, F3 both archs reduced on
    the card against the host.  No kernel of the repo runs here (MoE
    routing, dispatch, the expert FFN and MLA are plain tensor ops, as the
    reference runs them on XLA): every launch counter must stay as it
    was.  Fails on any call of PyTorch's fused attention or
    ``torch.compile``."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import fish_count as fc
    from repro_torch.kernels import ssd
    from repro_torch.kernels import store_probe as sp
    from repro_torch.launch import serve
    from repro_torch.models import moe as MM
    from repro_torch.models import transformer as MT

    counters = (ff.LAUNCHES, fc.LAUNCHES, ssd.LAUNCHES, sp.LAUNCHES)
    before = [dict(c) for c in counters]
    f1 = get_config("deepseek-v2-lite-16b")
    with MoEProbe(MT, MM) as probe:
        with no_fused_attention("F (F1, F4)", torch):
            params = _moe_f1(seed, dev, torch, np, MT, MM, serve,
                             get_config, probe)
            _moe_f4(seed, dev, torch, np, MM, params.layers[0].moe, f1.moe,
                    probe)
        # where an F1 layer's time goes (SDPA's time a library one only)
        probe.record = False
        attention_times("F1 deepseek-v2-lite-16b layer 0 (MLA expanded)",
                        probe.flash, torch)
        moe_times(MT, MM, params, f1, probe.first_x, dev, torch, probe)
        del params
        probe.first_x = probe.flash = None
        probe.capture = False
        gc.collect()
        torch.cuda.empty_cache()
        with no_fused_attention("F (F2, F3)", torch):
            _moe_f2(seed, dev, torch, np, MT, MM, get_config, probe)
            gc.collect()
            torch.cuda.empty_cache()
            probe.record = True
            for arch in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b"):
                cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                          dtype="float32")
                card_vs_host(f"F3 {arch}", MT, cfg, seed, dev, torch, np,
                             F3_LEN, probe=probe)
    after = [dict(c) for c in counters]
    if after != before:
        fail(f"path F launched a kernel of the repo: {before} -> {after}")
    log("path F: no kernel of the repo launched (every launch counter as "
        "it was): MoE routing, dispatch, the expert FFN and MLA run as "
        "plain tensor ops, as the reference runs them on XLA")


def _moe_prefill(what, MT, MM, params, cfg, toks, torch, probe):
    """A timed prefill with its MoE layers' drop fractions and loads."""
    prompts, n = toks.shape
    plan = MM.capacity_plan(cfg.moe, prompts * n)
    probe.record = True
    probe.clear()
    cache, logits, wall, peak = dense_prefill(what, MT, params, cfg, toks,
                                              torch)
    drops = probe.metric("moe_drop_frac", torch)
    loads = probe.metric("moe_load_max_over_mean", torch)
    if len(drops) != cfg.num_layers - cfg.moe.first_dense_layers:
        fail(f"{what} prefill: {len(drops)} MoE layers ran")
    log(f"{what} prefill {prompts} x {n} (prefill_32k's 32 x 32,768 cut "
        f"for time; {plan.groups} dispatch groups of {plan.group_size}, "
        f"c_max {plan.c_max}): {wall:.3f} s, {prompts * n / wall:,.0f} "
        f"tokens/s, peak {peak:.2f} GiB; moe_drop_frac mean "
        f"{float(drops.mean()):.4f} min {float(drops.min()):.4f} max "
        f"{float(drops.max()):.4f} over {len(drops)} MoE layers, load "
        f"max/mean {float(loads.mean()):.3f} (mean over layers)")
    return cache, logits


def _moe_f1(seed, dev, torch, np, MT, MM, serve, get_config, probe):
    import dataclasses

    cfg = get_config("deepseek-v2-lite-16b")
    mla, moe = cfg.mla, cfg.moe
    vocab, prompts, n = cfg.vocab_size, PROMPTS, PROMPT_LEN
    params = MT.init_params(cfg, seed=seed, device=dev)
    log(f"F1 deepseek-v2-lite-16b: {cfg.num_layers} layers "
        f"({moe.first_dense_layers} dense, d_ff {cfg.d_ff}), d_model "
        f"{cfg.d_model}, MLA r {mla.kv_lora_rank} dn {mla.qk_nope_dim} dr "
        f"{mla.qk_rope_dim} dv {mla.v_head_dim} x {cfg.num_heads} heads, "
        f"{moe.num_experts} experts top-{moe.top_k} (d_ff "
        f"{moe.d_ff_expert}) + {moe.shared_experts} shared, routing "
        f"{moe.routing}, dispatch {moe.dispatch_impl}, capacity factor "
        f"{moe.capacity_factor}, vocab {vocab}, {cfg.dtype}: "
        f"{MT.num_params(params):,} parameters, random init (seed {seed})")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (prompts, n)).astype(np.int32)).to(dev)
    cache, logits = _moe_prefill("F1", MT, MM, params, cfg, toks, torch,
                                 probe)
    cache = MT.grow_cache(cfg, cache, n + DECODE_STEPS)
    tok = torch.argmax(logits[:, :vocab], -1)[:, None].to(torch.int32)
    probe.record = False
    cache = dense_decode("F1", MT, params, cfg, cache, tok, DECODE_STEPS,
                         torch, np)
    if cache["pos"] != n - 1 + DECODE_STEPS:
        fail(f"F1 decode: position {cache['pos']}")
    del cache, logits

    # prefill-then-decode, with room in every expert for every claim: at
    # the published capacity a decode step's group of 4 tokens drops
    # claims that the prefill's groups of 1,024 keep
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=float(moe.num_experts)))
    c, k = F1_CHECK_LEN, moe.top_k
    probe.record = True
    probe.clear()
    _, full, _, _ = dense_prefill("F1", MT, params, roomy, toks[:, :c],
                                  torch)
    # each MoE layer's top-k for every token of the c-token prefill
    want = [ids[0].view(prompts, c, k) for ids, _, _ in probe.routes]
    drops = [probe.metric("moe_drop_frac", torch)]
    gaps = {}
    for how in ("own", "pinned", "wrong"):
        # "own": each pass routes by its own gates; "pinned": the
        # (c-1)-token prefill and the decode step take the c-token
        # prefill's choices; "wrong": as pinned, but the decode step takes
        # the next prompt's choices, which the check must see
        if how != "own":
            probe.pinned = [i[:, :c - 1].reshape(1, -1, k) for i in want]
        probe.clear()
        cache, _, _, _ = dense_prefill("F1", MT, params, roomy,
                                       toks[:, :c - 1], torch)
        cache = MT.grow_cache(roomy, cache, c)
        drops.append(probe.metric("moe_drop_frac", torch))
        pre = sum(int((a[:, :c - 1].reshape(-1, k).sort(-1).values !=
                       ids[0].sort(-1).values).any(-1).sum())
                  for a, (ids, _, _) in zip(want, probe.routes))
        if how != "own":
            probe.pinned = [i[:, c - 1].roll(int(how == "wrong"), 0)
                          .reshape(1, prompts, k) for i in want]
        probe.clear()
        step, _ = MT.decode_step(params, cache, toks[:, c - 1:c], roomy)
        drops.append(probe.metric("moe_drop_frac", torch))
        if probe.pinned:
            fail(f"F1 prefill-then-decode: {len(probe.pinned)} pinned "
                 f"routings left over")
        probe.pinned = None
        flips = sum(int((a[:, c - 1].sort(-1).values !=
                         ids[0].sort(-1).values).any())
                    for a, (ids, _, _) in zip(want, probe.routes))
        what = (f"F1 deepseek-v2-lite-16b ({prompts} x {c - 1} -> {c}, "
                f"capacity factor {roomy.moe.capacity_factor:g}, routing "
                f"{how})")
        if how == "wrong":
            a, b = step[:, :vocab].float(), full[:, :vocab].float()
            gap = (a - b).abs()
            seen = int((gap > CONSIST["atol"] +
                        CONSIST["rtol"] * b.abs()).sum())
            if not seen:
                fail(f"{what}: the next prompt's experts in every layer "
                     f"give logits within tolerance (max |gap| "
                     f"{float(gap.max())}): the check cannot see a wrong "
                     f"routing")
            log(f"check {what}: ok, the decode step with the next prompt's "
                f"experts in every MoE layer puts {seen} logits beyond the "
                f"tolerance (max |gap| {float(gap.max()):.4f})")
            continue
        if how == "pinned" and (pre or flips):
            fail(f"{what}: {pre} prefill and {flips} decode routings differ "
                 f"from the pinned ones")
        gaps[how] = consistency(what, step, full, vocab)
        log(f"F1 prefill-then-decode, routing {how}: {pre} of "
            f"{len(want) * prompts * (c - 1)} (MoE layer, token) top-{k} "
            f"sets of the {c - 1}-token prefill and {flips} of {len(want)} "
            f"MoE layers' token-{c} sets in the decode step differ from the "
            f"{c}-token prefill's; max |logit| "
            f"{float(full[:, :vocab].abs().max()):.4f}")
    drop = max(float(d.max()) for d in drops)
    if drop != 0.0:
        fail(f"F1 prefill-then-decode at capacity factor "
             f"{roomy.moe.capacity_factor}: drop fraction {drop}")
    log(f"F1 prefill-then-decode: drop fraction 0 in every pass; max |gap| "
        f"{gaps['own']:.4f} with each pass's own routing, {gaps['pinned']:.4f}"
        f" with the routing pinned to the {c}-token prefill's")
    del cache, full, step
    probe.record = False
    serve_check("F1", MT, serve, params, cfg, dev, torch)
    return params


def moe_times(MT, MM, params, cfg, x, dev, torch, probe):
    """Where an F1 layer's time goes, CUDA events over back-to-back calls:
    ``moe_ffn`` on the prefill's 16,384 tokens and on a decode step's 4,
    and the MLA decode against 4,128 positions.  Each beside its bound:
    ``moe_ffn``'s from the claims this run's dispatch keeps (their bf16
    products at ``BF16_OPS``) and the weights of the experts they hit
    (bytes at ``HBM_BPS``), and beside it the bound of the reference's
    static shapes (every slot of every expert's buffer multiplied, every
    expert's weights read), which the port computes as the reference
    does."""
    moe, mla = cfg.moe, cfg.mla
    layer = params.layers[0]
    e, d, f = moe.num_experts, cfg.d_model, moe.d_ff_expert
    fs = f * moe.shared_experts
    hot = torch.zeros(e, device=dev)
    rows = []

    def bound(ops, bytes_):
        return (max(ops / BF16_OPS, bytes_ / HBM_BPS) * 1e3,
                "operations" if ops / BF16_OPS >= bytes_ / HBM_BPS
                else "bytes")

    for what, t in (("prefill", x.shape[0]), ("decode", 4)):
        xt = x[:t].contiguous()
        plan = MM.capacity_plan(moe, t)
        probe.record = True
        probe.clear()
        MM.moe_ffn(layer.moe, xt, moe, hot)
        (ids, keep, _), = probe.routes
        probe.record = False
        kept, hit = int(keep.sum()), int(ids[keep].unique().numel())
        ms = time_cuda(lambda: MM.moe_ffn(layer.moe, xt, moe, hot), 5, torch)
        rest_ops = 2 * 3 * t * d * fs + 2 * t * d * e  # shared, router
        rest_bytes = 2 * 3 * d * fs + 4 * d * e + 2 * 2 * t * d
        ms_bound, by = bound(2 * 3 * kept * d * f + rest_ops,
                             2 * 3 * hit * d * f + rest_bytes)
        static, static_by = bound(
            2 * 3 * plan.groups * e * plan.c_max * d * f + rest_ops,
            2 * 3 * e * d * f + rest_bytes)
        rows.append({"what": f"moe_ffn {what}", "tokens": t,
                     "c_max": plan.c_max, "claims_kept": kept,
                     "experts_hit": hit, "ms": ms, "bound_ms": ms_bound,
                     "bound_by": by, "static_bound_ms": static,
                     "static_bound_by": static_by})
    b, s = 4, PROMPT_LEN + DECODE_STEPS
    cache = (torch.zeros((b, s, mla.kv_lora_rank), dtype=x.dtype,
                         device=dev),
             torch.zeros((b, s, mla.qk_rope_dim), dtype=x.dtype,
                         device=dev))
    h = x[:b, None]
    ms = time_cuda(lambda: MT._mla_decode(layer.attn, h, cache, s - 1, cfg),
                   20, torch)
    bytes_ = sum(t.numel() * t.element_size() for t in cache) + sum(
        p.numel() * p.element_size() for p in layer.attn.parameters())
    rows.append({"what": "mla decode", "positions": s, "ms": ms,
                 "bound_ms": bytes_ / HBM_BPS * 1e3, "bound_by": "bytes"})
    for r in rows:
        static = (f"; the static shapes' bound {r['static_bound_ms']:.4f} ms "
                  f"({r['static_bound_by']}), {r['claims_kept']} claims "
                  f"kept, {r['experts_hit']} experts hit"
                  if "static_bound_ms" in r else "")
        log(f"F1 layer time: {r['what']}: {r['ms']:.3f} ms (CUDA events, "
            f"back to back), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){static}")
    log(f"F1 layer times: {json.dumps(rows)}")


def _moe_f2(seed, dev, torch, np, MT, MM, get_config, probe):
    import dataclasses

    full = get_config("kimi-k2-1t-a32b")
    moe = full.moe
    cfg = dataclasses.replace(full, num_layers=moe.first_dense_layers + 1)
    vocab, prompts, n = cfg.vocab_size, PROMPTS, PROMPT_LEN
    whole = MT.num_params(MT.Model(full, device="meta"))
    params = MT.init_params(cfg, seed=seed, device=dev)
    one = sum(p.numel() * p.element_size()
              for p in params.layers[0].parameters())
    log(f"F2 kimi-k2-1t-a32b: d_model {cfg.d_model}, {cfg.num_heads} q / "
        f"{cfg.num_kv_heads} kv heads x {cfg.head_dim}, {moe.num_experts} "
        f"experts top-{moe.top_k} (d_ff {moe.d_ff_expert}) + "
        f"{moe.shared_experts} shared, vocab {vocab}, {cfg.dtype}; cut in "
        f"depth to {cfg.num_layers} of {full.num_layers} layers (the dense "
        f"prefix layer, d_ff {cfg.d_ff}, and one GQA + MoE layer; one MoE "
        f"layer is {one / 1e9:.1f} GB, the whole model {whole:,} "
        f"parameters, {whole * 2 / 2**30:,.0f} GiB in bf16): "
        f"{MT.num_params(params):,} parameters, random init (seed {seed})")
    toks = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, vocab, (prompts, n)).astype(np.int32)).to(dev)
    cache, logits = _moe_prefill("F2", MT, MM, params, cfg, toks, torch,
                                 probe)
    cache = MT.grow_cache(cfg, cache, n + F2_DECODE)
    tok = torch.argmax(logits[:, :vocab], -1)[:, None].to(torch.int32)
    probe.record = False
    cache = dense_decode("F2", MT, params, cfg, cache, tok, F2_DECODE, torch,
                         np)
    if cache["pos"] != n - 1 + F2_DECODE:
        fail(f"F2 decode: position {cache['pos']}")


def _moe_f4(seed, dev, torch, np, MM, layer, moe, probe):
    """One F1 MoE layer's ``moe_ffn`` on its prefill input (16,384
    tokens), under fish, pkg and fg in turn, from a Zipf(1.2)-skewed
    hotness, carrying ``new_hotness`` from call to call."""
    import dataclasses

    x = probe.first_x
    t, e, k = x.shape[0], moe.num_experts, moe.top_k
    plan = MM.capacity_plan(moe, t)
    zipf = np.arange(1, e + 1, dtype=np.float64) ** -1.2
    rng = np.random.default_rng(seed)
    hot = torch.from_numpy((zipf[rng.permutation(e)] / zipf.sum() * t * k
                            ).astype(np.float32)).to(dev)
    probe.record = True
    for i, routing in enumerate(("fish", "pkg", "fg")):
        mode = dataclasses.replace(moe, routing=routing)
        probe.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, new, _, m = MM.moe_ffn(layer, x, mode, hot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (ids, _, caps), = probe.routes
        counts = torch.bincount(ids.reshape(-1).cpu(), minlength=e).float()
        if not torch.equal(new.cpu(), mode.fish_alpha * hot.cpu() + counts):
            fail(f"F4 {routing}: new_hotness != alpha * hotness + counts")
        what = "new_hotness == alpha * h + counts exactly"
        if routing == "fish":
            want = MM.fish_capacities(hot.cpu(), budget=plan.budget,
                                      c_max=plan.c_max,
                                      theta_frac=mode.fish_theta_frac)
            if not torch.equal(caps.cpu(), want):
                fail(f"F4 fish: card capacities {caps.tolist()} != the "
                     f"CPU's {want.tolist()}")
            what += ", capacities == the CPU's fish_capacities exactly"
        if not bool(torch.isfinite(y).all()):
            fail(f"F4 {routing}: non-finite output")
        log(f"check F4 {routing}: ok, {t} tokens, hotness "
            f"{'Zipf(1.2) from the seed' if i == 0 else 'carried'} (sum "
            f"{float(hot.sum()):.1f}, max {float(hot.max()):.1f}), "
            f"{wall * 1e3:.2f} ms; moe_drop_frac "
            f"{float(m['moe_drop_frac']):.4f}, load max/mean "
            f"{float(m['moe_load_max_over_mean']):.3f}, capacities min "
            f"{int(caps.min())} max {int(caps.max())} sum {int(caps.sum())} "
            f"(budget {plan.budget}, c_max {plan.c_max}); {what}")
        hot = new


# ---------------------------------------------------------------------------
# path G: training, where FISH expert hotness evolves
# ---------------------------------------------------------------------------


def train_path(seed, dev, torch, np):
    """G1 qwen1.5-0.5b trained at its published widths and depth, with a
    checkpoint restored bit for bit; G2 deepseek-v2-lite-16b at its
    published widths cut to 4 of 27 layers, the FISH hotness carried from
    step to step and held to Alg. 1's recurrence; G3 one train step of
    three archs reduced on the card against the host.  No kernel of the
    repo runs here (the reference trains on XLA): every launch counter
    must stay as it was.  Fails on any call of PyTorch's fused attention
    or ``torch.compile``."""
    import gc

    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import fish_count as fc
    from repro_torch.kernels import ssd
    from repro_torch.kernels import store_probe as sp
    from repro_torch.models import moe as MM
    from repro_torch.models import transformer as MT

    counters = (ff.LAUNCHES, fc.LAUNCHES, ssd.LAUNCHES, sp.LAUNCHES)
    before = [dict(c) for c in counters]
    gc.collect()
    torch.cuda.empty_cache()
    with MoEProbe(MT, MM) as probe:
        probe.record = False
        with no_fused_attention("G", torch):
            flash = _train_g1(seed, dev, torch, np, probe)
            gc.collect()
            torch.cuda.empty_cache()
            layer_rows = [train_attention_time("G1 qwen1.5-0.5b layer 0",
                                               flash, torch)]
            layer_rows += _train_g2(seed, dev, torch, np, MT, MM, probe)
            gc.collect()
            torch.cuda.empty_cache()
            for arch in ("qwen1.5-0.5b", "deepseek-v2-lite-16b",
                         "kimi-k2-1t-a32b"):
                train_card_vs_host(arch, seed, dev, torch, np, MT, probe)
    log(f"G layer times: {json.dumps(layer_rows)}")
    after = [dict(c) for c in counters]
    if after != before:
        fail(f"path G launched a kernel of the repo: {before} -> {after}")
    log("path G: no kernel of the repo launched (every launch counter as "
        "it was): the training path runs as plain tensor ops under "
        "autograd, as the reference trains on XLA")


def _opt_cfg(cfg):
    """``launch/train.py main()``'s optimizer for ``cfg``."""
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                       state_dtype=cfg.opt_state_dtype,
                       factored_v=cfg.opt_factored)


def touched_params(cfg, MT):
    """Parameters one token's forward multiplies by: all but the routed
    experts a token does not choose (top-k of E)."""
    n = MT.num_params(MT.Model(cfg, device="meta"))
    if cfg.moe is None:
        return n
    moe = cfg.moe
    routed = 3 * cfg.d_model * moe.d_ff_expert * moe.num_experts
    n_moe = cfg.num_layers - moe.first_dense_layers
    return n - n_moe * routed * (1 - moe.top_k / moe.num_experts)


def timed_steps(what, loop, steps, torch, np, cfg, MT, on_step=None):
    """``steps`` train steps through ``TrainLoop.run``, each synchronized
    and timed on the host clock (the pipeline's batch included).  Returns
    the losses and each step's wall, s."""
    losses, walls = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += loop.run(1, ckpt_every=0, log_every=10**9)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not np.isfinite(losses[-1]):
            fail(f"{what} step {loop.step}: loss {losses[-1]}")
        if on_step is not None:
            on_step(i)
    tokens, touched = loop.batch * loop.seq, touched_params(cfg, MT)
    p50 = float(np.percentile(walls, 50))
    share = 6.0 * touched * tokens / p50 / BF16_OPS
    log(f"{what}: {steps} steps of {loop.batch} x {loop.seq} ({tokens:,} "
        f"tokens): step wall p50 {p50:.3f} s (first {walls[0]:.3f} s, "
        f"min {min(walls):.3f}, max {max(walls):.3f}), "
        f"{tokens / p50:,.0f} tokens/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, model-flops "
        f"share {share:.4f} (6 x {touched:,.0f} parameters "
        f"touched x tokens / step wall / {BF16_OPS / 1e12:.0f} TFLOP/s "
        f"bf16); losses {[round(x, 4) for x in losses]}; card "
        f"{card_line()}")
    return losses, walls


def _snapshot(loop, MT, torch):
    """Host copies of the loop's parameters (the reference's leaves), m, v,
    step and hotness."""
    st = loop.opt_state

    def host(x):  # a copy, also of a tensor already on the host
        return x.to("cpu", copy=True)

    return {"params": MT.param_tree(loop.params, device="cpu"),
            "m": {k: host(x) for k, x in st.m.items()},
            "v": {k: host(x) for k, x in st.v.items()},
            "step": int(st.step),
            "hotness": None if loop.hotness is None else host(loop.hotness)}


def _bit_equal(a, b, what, torch):
    if a.keys() != b.keys():
        fail(f"G1 restore: {what} leaves differ")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            fail(f"G1 restore: {what} {k} not bit-equal")


def _train_g1(seed, dev, torch, np, probe):
    """qwen1.5-0.5b at its published widths and depth: ``TrainLoop`` over 4
    FISH-grouped hosts, 8 steps of 8 x 2,048; a checkpoint after step 4
    that a fresh loop restores bit for bit and continues from.  Returns
    the first step's layer-0 ``flash_attention`` call."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import transformer as MT

    cfg = get_config("qwen1.5-0.5b")
    ocfg = _opt_cfg(cfg)
    (REPO / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=REPO / "build")
    try:
        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(cfg, ocfg, batch=G1_BATCH, seq=G1_SEQ,
                         ckpt_dir=ckdir, seed=seed, device=dev)
        log(f"G1 qwen1.5-0.5b: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}: "
            f"{MT.num_params(loop.params):,} parameters, random init (seed "
            f"{seed}); AdamW {ocfg.state_dtype} state, lr {ocfg.lr} after "
            f"{ocfg.warmup_steps} warmup steps; TrainLoop over 4 FISH-grouped "
            f"hosts")
        probe.capture = True
        losses, walls = timed_steps("G1 steps 1-4", loop, G1_SAVE, torch, np,
                                    cfg, MT)
        probe.capture = False
        flash, probe.flash = probe.flash, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.save()
        save_s = time.perf_counter() - t0
        snap = _snapshot(loop, MT, torch)
        more, walls2 = timed_steps("G1 steps 5-8", loop, G_STEPS - G1_SAVE,
                                   torch, np, cfg, MT)
        losses += more
        walls += walls2
        p50 = float(np.percentile(walls, 50))
        log(f"G1 qwen1.5-0.5b train: {G_STEPS} steps, step wall p50 "
            f"{p50:.3f} s, {G1_BATCH * G1_SEQ / p50:,.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; card {card_line()}")
        del loop
        gc.collect()
        torch.cuda.empty_cache()

        size = sum(f.stat().st_size for f in Path(ckdir).rglob("*.npy"))
        fresh = TrainLoop(cfg, ocfg, batch=G1_BATCH, seq=G1_SEQ,
                          ckpt_dir=ckdir, seed=seed, device=dev)
        t0 = time.perf_counter()
        if not fresh.maybe_restore() or fresh.step != G1_SAVE:
            fail(f"G1: the fresh loop restored step {fresh.step}, not "
                 f"{G1_SAVE}")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = _snapshot(fresh, MT, torch)
        _bit_equal(got["params"], snap["params"], "parameter", torch)
        _bit_equal(got["m"], snap["m"], "m", torch)
        _bit_equal(got["v"], snap["v"], "v", torch)
        if got["step"] != snap["step"] or (got["hotness"] is None) != (
                snap["hotness"] is None):
            fail(f"G1 restore: step {got['step']} / {snap['step']}")
        del got, snap
        for _ in range(G1_SAVE):  # the batches the first loop trained on
            fresh.next_batch()
        resumed = fresh.run(2, ckpt_every=0, log_every=10**9)
        gap = max(abs(a - b) for a, b in zip(resumed,
                                             losses[G1_SAVE:G1_SAVE + 2]))
        if not gap <= G1_RESUME_TOL:
            fail(f"G1 resume: losses {resumed} vs the uninterrupted "
                 f"{losses[G1_SAVE:G1_SAVE + 2]} (gap {gap})")
        log(f"check G1 checkpoint: ok, step {G1_SAVE} saved in {save_s:.2f} "
            f"s ({size / 1e9:.2f} GB on disk, bf16 as float32, the "
            f"reference's format) and restored by a fresh loop in "
            f"{restore_s:.2f} s: parameters, m, v and step "
            f"bit-equal; its next 2 losses {[round(x, 6) for x in resumed]} "
            f"vs the uninterrupted run's "
            f"{[round(x, 6) for x in losses[G1_SAVE:G1_SAVE + 2]]} (max gap "
            f"{gap:.2e}, tol {G1_RESUME_TOL})")
        del fresh
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return flash


def _train_g2(seed, dev, torch, np, MT, MM, probe):
    """deepseek-v2-lite-16b at its published widths, cut to 4 of 27 layers:
    8 steps of 4 x 4,096 with the hotness carried.  Per step and MoE layer:
    the counts sum to T·k, the new hotness is ``α·h + counts`` exactly,
    the capacities are the uniform split at step 1 and the host's CHK from
    the carried hotness after, the recompute routes as the forward; the
    hotness sums follow ``H ← α·H + T·k``.  Returns the layer time rows."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop

    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, num_layers=G2_LAYERS)
    moe = cfg.moe
    n_moe = G2_LAYERS - moe.first_dense_layers
    t = G2_BATCH * G2_SEQ
    plan = MM.capacity_plan(moe, t)
    alpha = np.float32(moe.fish_alpha)
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, _opt_cfg(cfg), batch=G2_BATCH, seq=G2_SEQ,
                     seed=seed, device=dev)
    n = MT.num_params(loop.params)
    log(f"G2 deepseek-v2-lite-16b: d_model {cfg.d_model}, MLA, "
        f"{moe.num_experts} experts top-{moe.top_k} + {moe.shared_experts} "
        f"shared, capacity factor {moe.capacity_factor}, FISH routing "
        f"(alpha {moe.fish_alpha}), {cfg.dtype}; cut in depth to "
        f"{G2_LAYERS} of {full.num_layers} layers (the dense prefix layer + "
        f"{n_moe} MoE layers; the whole model's training state, bf16 "
        f"weights and grads + float32 m and v, is 12 B a parameter, "
        f"{MT.num_params(MT.Model(full, device='meta')) * 12 / 1e9:.0f} GB): "
        f"{n:,} parameters ({n * 12 / 2**30:.1f} GiB of training state), "
        f"random init (seed {seed}); {plan.groups} dispatch groups of "
        f"{plan.group_size}, budget {plan.budget}, c_max {plan.c_max}")
    H = [np.float32(0.0)] * n_moe
    rows = []

    def check(i):
        # the forward's calls, then the backward's recompute of each MoE
        # layer, last layer first (non-reentrant checkpointing stops a
        # recompute once it has what the backward needs: past the routing,
        # before moe_ffn returns)
        fwd, routes = probe.hotness[:n_moe], probe.routes[:n_moe]
        if len(fwd) != n_moe or len(probe.routes) != 2 * n_moe:
            fail(f"G2 step {i + 1}: {len(probe.hotness)} moe_ffn calls, "
                 f"{len(probe.routes)} routings (want {n_moe} forward calls "
                 f"and 2 x {n_moe} routings, the remat recompute's too)")
        drops = probe.metric("moe_drop_frac", torch)[:n_moe]
        loads = probe.metric("moe_load_max_over_mean", torch)[:n_moe]
        caps_txt, gaps = [], []
        for layer in range(n_moe):
            hot, new = (x.cpu() for x in fwd[layer])
            ids, keep, caps = routes[layer]
            r_ids, r_keep, _ = probe.routes[2 * n_moe - 1 - layer]
            if not (torch.equal(ids, r_ids) and torch.equal(keep, r_keep)):
                fail(f"G2 step {i + 1} layer {layer}: the recompute routed "
                     f"otherwise than the forward")
            counts = torch.bincount(ids.reshape(-1).cpu(),
                                    minlength=moe.num_experts).float()
            if int(counts.sum()) != t * moe.top_k:
                fail(f"G2 step {i + 1} layer {layer}: counts sum "
                     f"{int(counts.sum())} != {t * moe.top_k}")
            if not torch.equal(new, moe.fish_alpha * hot + counts):
                fail(f"G2 step {i + 1} layer {layer}: new hotness != "
                     f"alpha * hotness + counts")
            if not torch.equal(hot, loop_hot[layer]):
                fail(f"G2 step {i + 1} layer {layer}: routed from another "
                     f"hotness than the one carried")
            want = MM.fish_capacities(hot, budget=plan.budget,
                                      c_max=plan.c_max,
                                      theta_frac=moe.fish_theta_frac)
            caps = caps.cpu()
            if not torch.equal(caps, want) or (i == 0) != bool(
                    (caps == caps[0]).all()):
                fail(f"G2 step {i + 1} layer {layer}: capacities "
                     f"{caps.tolist()} (host CHK {want.tolist()})")
            H[layer] = np.float32(alpha * H[layer] + np.float32(
                t * moe.top_k))
            gaps.append(float(new.double().sum()) - float(H[layer]))
            caps_txt.append(f"{int(caps.min())}-{int(caps.max())}")
        why = ("uniform split: no hotness yet" if i == 0
               else "CHK from the carried hotness")
        log(f"G2 step {i + 1}: moe_drop_frac per MoE layer "
            f"{[round(float(x), 4) for x in drops]}, load max/mean "
            f"{[round(float(x), 3) for x in loads]}, capacities "
            f"{caps_txt} ({why}); "
            f"hotness sum - the float32 recurrence H <- {moe.fish_alpha} H + "
            f"{t * moe.top_k:,} (H = {float(H[0]):.4f}): "
            f"{[f'{g:+.6g}' for g in gaps]}")
        for layer, g in enumerate(gaps):
            # each step rounds every expert's alpha * h + c and the
            # recurrence once; decayed by alpha, the sums stay within
            # 2^-21 H of each other
            if abs(g) > 2.0 ** -21 * float(H[layer]):
                fail(f"G2 step {i + 1} layer {layer}: hotness sum off the "
                     f"recurrence by {g}")
        probe.clear()
        loop_hot[:] = [x.cpu() for x in loop.hotness]

    loop_hot = [x.cpu() for x in loop.hotness]
    probe.record = probe.capture = True
    probe.clear()
    timed_steps("G2 deepseek-v2-lite-16b (4 layers) train", loop, G_STEPS,
                torch, np, cfg, MT, on_step=check)
    probe.record = probe.capture = False
    log(f"check G2 FISH hotness: ok, {G_STEPS} steps x {n_moe} MoE layers: "
        f"counts sum to T.k = {t * moe.top_k:,} every step, new hotness == "
        f"alpha * hotness + counts bit for bit, capacities the uniform "
        f"split at step 1 and the host's CHK of the carried hotness after, "
        f"the remat recompute routed as the forward")
    layer = loop.params.layers[0]
    rows.append(train_attention_time("G2 deepseek-v2-lite-16b layer 0 (MLA "
                                     "expanded)", probe.flash, torch))
    rows.append(train_moe_time(MM, layer.moe, moe, probe.first_x,
                               loop.hotness[0], torch))
    probe.flash = probe.first_x = None
    del loop
    return rows


def train_attention_time(what, call, torch, path="G"):
    """One layer's ``flash_attention`` forward + backward (its KV blocks
    checkpointed, as in training), CUDA events."""
    from repro_torch.models import attention as attn

    (q, k, v), kw = call
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ct = torch.randn(q.shape[:3] + v.shape[-1:], device=q.device,
                     dtype=q.dtype)

    def step():
        torch.autograd.grad(attn.flash_attention(*xs, **kw), xs, ct)

    ms = time_cuda(step, 3, torch)
    b, s, hq, dh = q.shape
    row = {"what": f"flash_attention forward + backward, {what}",
           "shape": [b, s, hq, k.shape[2], dh, v.shape[-1]], "ms": ms}
    log(f"{path} layer time: {row['what']} ({b} x {s}, {hq} heads x {dh} "
        f"/ {v.shape[-1]}): {ms:.3f} ms (CUDA events); card {card_line()}")
    return row


def train_moe_time(MM, params, moe, x, hot, torch):
    """One layer's ``moe_ffn`` forward + backward at the step's tokens,
    CUDA events; the gradients go to the tokens and the layer's weights
    and are dropped."""
    xs = x.detach().requires_grad_(True)
    ws = list(params.parameters())
    ct = torch.randn_like(x)

    def step():
        y, _, aux, _ = MM.moe_ffn(params, xs, moe, hot)
        torch.autograd.grad((y.float() * ct.float()).sum() + aux, [xs, *ws])

    ms = time_cuda(step, 3, torch)
    row = {"what": "moe_ffn forward + backward, G2 MoE layer 0",
           "tokens": int(x.shape[0]), "ms": ms}
    log(f"G layer time: {row['what']} ({x.shape[0]:,} tokens): {ms:.3f} ms "
        f"(CUDA events); card {card_line()}")
    return row


def _tree_close(what, got, want, torch):
    """Each leaf of ``got`` within ``G3_TOL`` of ``want``'s largest
    magnitude, or, for a bfloat16 leaf, within one bfloat16 ulp (2^-7) of
    ``want`` (a float32 value an ulp off can round the other way); returns
    the largest gap relative to the leaf's max."""
    worst = 0.0
    for k in want:
        a, b = got[k].float().cpu(), want[k].float().cpu()
        scale = max(float(b.abs().max()), 1e-30)
        err = (a - b).abs()
        slack = 2.0 ** -7 * b.abs() if want[k].dtype == torch.bfloat16 \
            else 0.0
        if bool((err > G3_TOL * scale + slack).any()):
            fail(f"{what} {k}: card vs host {float(err.max()) / scale:.3e} "
                 f"of the leaf's max")
        worst = max(worst, float(err.max()) / scale)
    return worst


def train_card_vs_host(arch, seed, dev, torch, np, MT, probe):
    """G3: one ``make_train_step`` of ``arch`` at ``reduced_config`` in
    float32 on the card and on the host, one set of weights and a seeded
    carried hotness: the loss within ``G3_TOL``, the new hotness and every
    routing's ids and keep equal, m and v within ``G3_TOL`` of each leaf's
    largest magnitude (a bfloat16 leaf: or one bfloat16 ulp), and the
    parameters too wherever the gradient is not near zero (Adam's first
    step moves an element by lr·g/(|g| + eps): a rounding of a near-zero
    gradient moves it by up to ±lr, so there the bound is 2·lr)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import init_opt_state

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    ocfg = _opt_cfg(cfg)
    host = MT.init_params(cfg, seed=seed, device="cpu")
    card = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (G3_BATCH, G3_SEQ + 1)).astype(
        np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    hot = None
    if cfg.moe is not None:
        hot = torch.from_numpy((rng.random(
            (cfg.num_layers - cfg.moe.first_dense_layers,
             cfg.moe.num_experts)) * 50).astype(np.float32))
    step = make_train_step(cfg, ocfg)
    runs = []
    for params, where in ((card, dev), (host, torch.device("cpu"))):
        probe.record = True
        probe.clear()
        _, state, new_hot, m = step(
            params, init_opt_state(params, ocfg),
            None if hot is None else hot.to(where),
            {k: x.to(where) for k, x in batch.items()})
        runs.append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                     "hot": new_hot,
                     "params": MT.param_tree(params, device="cpu"),
                     "m": state.m, "v": state.v,
                     "routes": [(i.cpu(), k.cpu()) for i, k, _ in
                                probe.routes]})
    probe.record = False
    probe.clear()
    card_r, host_r = runs
    lgap = abs(card_r["loss"] - host_r["loss"])
    if not lgap <= G3_TOL * abs(host_r["loss"]):
        fail(f"G3 {arch}: loss {card_r['loss']} vs {host_r['loss']}")
    if (hot is None) != (card_r["hot"] is None) or (
            hot is not None and not torch.equal(card_r["hot"].cpu(),
                                                host_r["hot"])):
        fail(f"G3 {arch}: new hotness differs card vs host")
    diff = sum(int((a != b).sum()) for ra, rb in zip(card_r["routes"],
                                                     host_r["routes"])
               for a, b in zip(ra, rb))
    if len(card_r["routes"]) != len(host_r["routes"]) or diff or (
            cfg.moe is not None and not card_r["routes"]):
        fail(f"G3 {arch}: routings {len(card_r['routes'])} / "
             f"{len(host_r['routes'])}, {diff} ids/keep differences")
    gm = _tree_close(f"G3 {arch} m", card_r["m"], host_r["m"], torch)

    def flat_v(v):  # a factored leaf's r and c as leaves of their own
        return {f"{k}/{part}" if part else k: y for k, x in v.items()
                for part, y in (x.items() if isinstance(x, dict)
                                else (("", x),))}

    gv = _tree_close(f"G3 {arch} v", flat_v(card_r["v"]),
                     flat_v(host_r["v"]), torch)
    gp, lr = 0.0, host_r["lr"]
    for k, want in host_r["params"].items():
        err = (card_r["params"][k] - want).abs()
        m = host_r["m"][k].float().abs()
        stable = m > 1e-3 * m.max()
        scale = max(float(want.abs().max()), 1e-30)
        gap = (float(err[stable].max()) / scale if bool(stable.any())
               else 0.0)
        if gap > G3_TOL or float(err.max()) > 2 * lr + G3_TOL * scale:
            fail(f"G3 {arch} parameters {k}: card vs host {gap:.3e} of the "
                 f"leaf's max where the gradient is not near zero, "
                 f"{float(err.max()):.3e} anywhere (lr {lr:.3e})")
        gp = max(gp, gap)
    log(f"check G3 {arch} (reduced, float32, {G3_BATCH} x {G3_SEQ}, "
        f"grad_accum {cfg.grad_accum}, AdamW {ocfg.state_dtype} state"
        f"{', factored v' if ocfg.factored_v else ''}): card vs host ok, "
        f"loss {card_r['loss']:.6f} (gap {lgap:.2e}); "
        f"{len(card_r['routes'])} routings, ids/keep differences {diff}, "
        f"new hotness {'equal' if hot is not None else 'none'}; m, v, "
        f"parameters within {gm:.2e}, {gv:.2e}, {gp:.2e} of each leaf's max "
        f"(tol {G3_TOL})")


# ---------------------------------------------------------------------------
# path H: the Griffin family (RG-LRU + local MQA, a ring-buffer decode cache)
# ---------------------------------------------------------------------------


def griffin_path(seed, dev, torch, np):
    """H1 recurrentgemma-9b at its published widths and depth: prefill,
    the prefill-then-decode check, decode, serving, one layer's times; H2
    the model at full width cut to 8 layers trained by ``TrainLoop``; H3
    the reduced model on the card against the host.  No kernel of the repo
    runs here (the reference's RG-LRU scan and local attention are XLA):
    every launch counter must stay as it was.  Fails on any call of
    PyTorch's fused attention or ``torch.compile`` outside the layer
    times' library call."""
    import gc

    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import fish_count as fc
    from repro_torch.kernels import ssd
    from repro_torch.kernels import store_probe as sp
    from repro_torch.models import ssm as MS
    from repro_torch.models import transformer as MT

    counters = (ff.LAUNCHES, fc.LAUNCHES, ssd.LAUNCHES, sp.LAUNCHES)
    before = [dict(c) for c in counters]
    gc.collect()
    torch.cuda.empty_cache()
    captured = {}
    real_flash, real_block = MT.flash_attention, MS.rglru_block

    def cap(name, fn):
        def call(*args, **kwargs):
            if captured.get("on") and name not in captured:  # H1's first
                captured[name] = (tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return call

    MT.flash_attention = cap("flash_attention", real_flash)
    MS.rglru_block = cap("rglru_block", real_block)
    try:
        with no_fused_attention("H1", torch):
            params = _griffin_h1(seed, dev, torch, np, MT, captured)
    finally:
        MT.flash_attention, MS.rglru_block = real_flash, real_block
    griffin_layer_times(MS, captured, torch)
    attention_times("H1 attention layer 2 (local MQA)",
                    captured.pop("flash_attention"), torch)
    del params, captured
    gc.collect()
    torch.cuda.empty_cache()
    with no_fused_attention("H2, H3", torch):
        _griffin_h2(seed, dev, torch, np, MT)
        gc.collect()
        torch.cuda.empty_cache()
        _griffin_h3(seed, dev, torch, np, MT)
    after = [dict(c) for c in counters]
    if after != before:
        fail(f"path H launched a kernel of the repo: {before} -> {after}")
    log("path H: no kernel of the repo launched (every launch counter as "
        "it was): the RG-LRU scan and the local attention run as plain "
        "tensor ops, as the reference runs them on XLA")


def _griffin_h1(seed, dev, torch, np, MT, captured):
    """recurrentgemma-9b at its published widths and depth: a cold and a
    warm prefill of 4 x 4,096, the check against a prefill of 4 x 4,097,
    32 decode steps and ``serve()``.  Returns the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("recurrentgemma-9b")
    rg, vocab, n = cfg.rglru, cfg.vocab_size, H1_LEN
    t0 = time.perf_counter()
    params = MT.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    count = MT.num_params(params)
    if count != H1_PARAMS:
        fail(f"H1: {count:,} parameters, not {H1_PARAMS:,}")
    groups, tail = MT._griffin_layout(cfg)
    log(f"H1 recurrentgemma-9b: {cfg.num_layers} layers ({groups} x (rec, "
        f"rec, attn) + {tail} rec), d_model {cfg.d_model}, RG-LRU width "
        f"{rg.lru_width} ({rg.gate_blocks} gate blocks, conv {rg.conv_width}"
        f"), local MQA {cfg.num_heads} q / {cfg.num_kv_heads} kv heads x "
        f"{cfg.head_dim} over a window of {rg.local_window}, d_ff "
        f"{cfg.d_ff} GeGLU, vocab {vocab}, softcap {cfg.logit_softcap}, "
        f"{cfg.dtype}: {count:,} parameters, random init (seed {seed}) in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (H1_PROMPTS, n + 1)).astype(np.int32)).to(dev)
    captured["on"] = True
    cache, _, cold, peak = dense_prefill("H1", MT, params, cfg,
                                         toks[:, :n], torch)
    captured["on"] = False
    _, _, warm, _ = dense_prefill("H1", MT, params, cfg, toks[:, :n], torch)
    log(f"H1 prefill {H1_PROMPTS} x {n} (prefill_32k's 32 x 32,768 cut for "
        f"time; {n // rg.local_window} windows): cold {cold:.3f} s, warm "
        f"{warm:.3f} s, {H1_PROMPTS * n / warm:,.0f} tokens/s, peak "
        f"{peak:.2f} GiB; card {card_line()}")
    step, cache = MT.decode_step(params, cache, toks[:, n:n + 1], cfg)
    _, full, _, _ = dense_prefill("H1", MT, params, cfg, toks, torch)
    consistency("H1 recurrentgemma-9b (ring of "
                f"{cache['attn'][0].shape[2]} slots after {n} tokens)",
                step, full, vocab)
    del full
    tok = torch.argmax(step[:, :vocab], -1)[:, None].to(torch.int32)
    cache = dense_decode("H1", MT, params, cfg, cache, tok, DECODE_STEPS,
                         torch, np, cap=cfg.logit_softcap)
    if cache["pos"] != n + DECODE_STEPS:
        fail(f"H1 decode: position {cache['pos']}")
    del cache
    serve_check("H1", MT, serve, params, cfg, dev, torch)
    log(f"H1 peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(since the last prefill)")
    return params


def griffin_layer_times(MS, captured, torch):
    """One H1 rec layer's ``rglru_block`` and its ``_lru_scan`` at the
    prefill's shapes (CUDA events), each beside its bound: the block's
    bf16 products at 989 TFLOP/s, the scan's bytes (a and b read, h
    written, float32) at 3.35 TB/s."""
    (p, x, rg), _ = captured.pop("rglru_block")
    b, s, d = x.shape
    w = p.w_x.shape[1]
    ms_block = time_cuda(lambda: MS.rglru_block(p, x, rg), 5, torch)
    a, bb = MS._rglru_gates(p, MS._rglru_conv(x @ p.w_x, p))
    ms_scan = time_cuda(lambda: MS._lru_scan(a, bb), 5, torch)
    block_bound = 3 * 2.0 * b * s * d * w / BF16_OPS * 1e3
    scan_bound = 3 * a.numel() * 4 / HBM_BPS * 1e3
    row = {"what": "H1 rec layer 0", "shape": [b, s, d, w],
           "rglru_block_ms": ms_block, "rglru_block_bound_ms": block_bound,
           "lru_scan_ms": ms_scan, "lru_scan_bound_ms": scan_bound}
    log(f"H1 layer time: rglru_block {ms_block:.3f} ms (bound "
        f"{block_bound:.3f}, its three bf16 products), of which _lru_scan "
        f"{ms_scan:.3f} ms (bound {scan_bound:.3f}, bytes; {b} x {s} x {w} "
        f"float32, 16 chunk scans of {s // 16}); CUDA events; card "
        f"{card_line()}")
    log(f"H1 layer times: {json.dumps(row)}")


def _griffin_h2(seed, dev, torch, np, MT):
    """recurrentgemma-9b at its published widths cut to 8 of 38 layers (2
    groups + a tail of 2): ``TrainLoop``, 4 steps of 4 x 2,048."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop

    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, num_layers=H2_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, _opt_cfg(cfg), batch=H2_BATCH, seq=H2_SEQ,
                     seed=seed, device=dev)
    n = MT.num_params(loop.params)
    if n != H2_PARAMS:
        fail(f"H2: {n:,} parameters, not {H2_PARAMS:,}")
    groups, tail = MT._griffin_layout(cfg)
    log(f"H2 recurrentgemma-9b: its published widths cut in depth to "
        f"{H2_LAYERS} of {full.num_layers} layers ({groups} groups + {tail} "
        f"rec; the whole model's training state, bf16 weights and grads + "
        f"float32 m and v, is 12 B a parameter, {H1_PARAMS * 12 / 1e9:.0f} "
        f"GB): {n:,} parameters ({n * 12 / 2**30:.1f} GiB of training "
        f"state), random init (seed {seed}), remat {cfg.remat} (each group "
        f"checkpointed); TrainLoop over 4 FISH-grouped hosts")
    losses, _ = timed_steps(f"H2 recurrentgemma-9b ({H2_LAYERS} layers) "
                            "train", loop, H2_STEPS, torch, np, cfg, MT)
    log(f"check H2: ok, {H2_STEPS} steps, every loss finite "
        f"({[round(x, 4) for x in losses]})")
    del loop


def _griffin_h3(seed, dev, torch, np, MT):
    """The reduced model (5 layers: a group and a tail of 2; window 8) in
    float32 on the card against the host, one set of weights: a prefill
    of 2 x 11 (not a multiple of the window: the ring's quirk on) and 8
    decode steps, then one ``forward_train``'s loss and gradients, within
    ``tests/test_torch_griffin.py``'s bounds."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, reduced_config

    base = reduced_config(get_config("recurrentgemma-9b"))
    cfg = dataclasses.replace(base, num_layers=5, dtype="float32",
                              rglru=dataclasses.replace(base.rglru,
                                                        local_window=8))
    host = MT.init_params(cfg, seed=seed, device="cpu")
    card = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(seed)
    n = H3_LEN
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n + 8)
                                         ).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)
                                           ).astype(np.int32))
    runs = []
    for params, where in ((card, dev), (host, "cpu")):
        t = toks.to(where)
        cache, lg = MT.prefill(params, {"tokens": t[:, :n]}, cfg)
        out = [lg]
        for i in range(n, n + 8):
            lg, cache = MT.decode_step(params, cache, t[:, i:i + 1], cfg)
            out.append(lg)
        leaves = [cache["rec"]["conv"], cache["rec"]["h"], *cache["attn"],
                  *[st[k] for st in cache["tail"] for k in ("conv", "h")]]
        params.requires_grad_(True)
        loss, _ = MT.forward_train(params, {
            "tokens": labels.roll(1, 1).to(where),
            "labels": labels.to(where)}, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        runs.append(([x[:, :cfg.vocab_size].cpu() for x in out],
                     [x.cpu() for x in leaves], float(loss.detach()),
                     [g.cpu() for g in grads]))
    (logits, leaves, loss, grads), (w_logits, w_leaves, w_loss, w_grads) = \
        runs
    lgap = max(float((a - b).abs().max()) for a, b in zip(logits, w_logits))
    cgap = max(float((a - b).abs().max()) for a, b in zip(leaves, w_leaves))
    ggap = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(grads, w_grads))
    if lgap > H3_TOL["logits"] or cgap > H3_TOL["cache"] or abs(
            loss - w_loss) > H3_TOL["loss"] * abs(w_loss) or \
            ggap > H3_TOL["grad"]:
        fail(f"H3: card vs host logits {lgap:.2e}, caches {cgap:.2e}, loss "
             f"{loss} / {w_loss}, gradients {ggap:.2e} of the leaf's max "
             f"(tol {H3_TOL})")
    log(f"check H3 recurrentgemma-9b (reduced, 5 layers, window 8, float32"
        f"): card vs host ok: prefill 2 x {n} (ring of "
        f"{min(n, 8)} slots, {n} % 8 != 0: the reference's quirk on) + 8 "
        f"decode steps, logits within {lgap:.2e} (tol "
        f"{H3_TOL['logits']}), caches {cgap:.2e} (tol {H3_TOL['cache']}); "
        f"forward_train at 2 x 32: loss {loss:.6f} (gap "
        f"{abs(loss - w_loss):.2e}), gradients within {ggap:.2e} of each "
        f"leaf's max (tol {H3_TOL['grad']})")


# ---------------------------------------------------------------------------
# path I: the frontend stubs (whisper's encoder-decoder, qwen2-vl's M-RoPE)
# ---------------------------------------------------------------------------


def mrope_positions(text0, grid, s, np):
    """Qwen2-VL's (3, B, S) position ids (arXiv:2409.12191 §2.1), one row
    per entry of ``text0``: a text prefix of ``text0[r]`` tokens on equal
    streams, one image of grid x grid merged patches at one temporal index
    (height and width offsets from the prefix), then text from the largest
    position + 1 to S."""
    rows = []
    for t0 in text0:
        hh, ww = np.meshgrid(np.arange(grid), np.arange(grid),
                             indexing="ij")
        img = np.stack([np.zeros(grid * grid, np.int64), hh.ravel(),
                        ww.ravel()]) + t0
        n1 = s - t0 - grid * grid
        rows.append(np.concatenate([
            np.broadcast_to(np.arange(t0), (3, t0)), img,
            np.broadcast_to(int(img.max()) + 1 + np.arange(n1), (3, n1))],
            axis=1))
    return np.stack(rows, axis=1).astype(np.int32)


def frontend_path(seed, dev, torch, np):
    """I1 whisper-large-v3 and I2 qwen2-vl-2b at their published widths and
    depths: prefill, the prefill-then-decode check, decode; one whisper
    encoder layer's non-causal ``flash_attention`` beside SDPA's; I3 both
    trained through ``make_train_step``; I4 both reduced on the card
    against the host.  No kernel of the repo runs here (the reference's
    encoder, cross attention and M-RoPE are XLA): every launch counter must
    stay as it was.  Fails on any call of PyTorch's fused attention or
    ``torch.compile`` outside the layer time's library call."""
    import gc

    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import fish_count as fc
    from repro_torch.kernels import ssd
    from repro_torch.kernels import store_probe as sp
    from repro_torch.models import transformer as MT

    counters = (ff.LAUNCHES, fc.LAUNCHES, ssd.LAUNCHES, sp.LAUNCHES)
    before = [dict(c) for c in counters]
    gc.collect()
    torch.cuda.empty_cache()
    captured = {}
    real_flash = MT.flash_attention

    def flash(*args, **kwargs):
        if captured.get("on") and "flash_attention" not in captured:
            captured["flash_attention"] = (tuple(a.clone() for a in args),
                                           dict(kwargs))
        return real_flash(*args, **kwargs)

    MT.flash_attention = flash
    try:
        with no_fused_attention("I1", torch):
            _frontend_i1(seed, dev, torch, np, MT, captured)
    finally:
        MT.flash_attention = real_flash
    gc.collect()
    torch.cuda.empty_cache()
    call = captured.pop("flash_attention")
    attention_times("I1 encoder layer 0", call, torch)
    row = train_attention_time("I1 encoder layer 0", call, torch, path="I")
    log(f"I layer times: {json.dumps(row)}")
    del captured, call
    gc.collect()
    torch.cuda.empty_cache()
    with no_fused_attention("I2, I3, I4", torch):
        _frontend_i2(seed, dev, torch, np, MT)
        gc.collect()
        torch.cuda.empty_cache()
        _frontend_i3(seed, dev, torch, np, MT)
        gc.collect()
        torch.cuda.empty_cache()
        for arch, sections in (("whisper-large-v3", None),
                               ("qwen2-vl-2b", None),
                               ("qwen2-vl-2b", (4, 6, 6))):
            _frontend_i4(arch, sections, seed, dev, torch, np, MT)
    after = [dict(c) for c in counters]
    if after != before:
        fail(f"path I launched a kernel of the repo: {before} -> {after}")
    log("path I: no kernel of the repo launched (every launch counter as "
        "it was): the encoder, cross attention and M-RoPE run as plain "
        "tensor ops, as the reference runs them on XLA")


def _frontend_params(what, arch, want, seed, dev, torch, MT):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = MT.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    count = MT.num_params(params)
    if count != want:
        fail(f"{what}: {count:,} parameters, not {want:,}")
    return cfg, params, count, time.perf_counter() - t0


def _randn(shape, seed, dev, dtype, torch):
    """Standard normal values made on the card from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _frontend_i1(seed, dev, torch, np, MT, captured):
    """whisper-large-v3 at its published widths and depth: the encoder over
    4 x 1,500 frame embeddings (the 30 s window after the stubbed conv),
    a cold and a warm prefill of 4 x 416 tokens, the check (415 + one
    decode step against 416), 32 decode steps to position 447 (the
    published max_target_positions 448)."""
    cfg, params, count, init_s = _frontend_params(
        "I1", "whisper-large-v3", I1_PARAMS, seed, dev, torch, MT)
    vocab, n, b = cfg.vocab_size, I1_LEN, I1_PROMPTS
    log(f"I1 whisper-large-v3: {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff} "
        f"{cfg.activation}, {cfg.norm}, vocab {vocab}, no positional signal "
        f"(rope_kind {cfg.rope_kind!r}), {cfg.dtype}: {count:,} parameters, "
        f"random init (seed {seed}) in {init_s:.2f} s")
    enc = _randn((b, cfg.encoder_seq, cfg.d_model), seed, dev,
                 getattr(torch, cfg.dtype), torch)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, n)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "enc_embeds": enc}
    captured["on"] = True
    _, _, cold, peak = dense_prefill("I1", MT, params, cfg, batch, torch)
    captured["on"] = False
    cache, full, warm, _ = dense_prefill("I1", MT, params, cfg, batch, torch)
    cross = cache["layers"][1][0]
    log(f"I1 prefill {b} x {cfg.encoder_seq} frames (encoder) + {b} x {n} "
        f"tokens (decoder): cold {cold:.3f} s, warm {warm:.3f} s, "
        f"{b * n / warm:,.0f} decoder tokens/s, "
        f"{b * cfg.encoder_seq / warm:,.0f} frames/s, peak {peak:.2f} GiB; "
        f"cross-attention cache {2 * cross.numel() * cross.element_size():,}"
        f" bytes, made once by the prefill; card {card_line()}")
    short, _, _, _ = dense_prefill("I1", MT, params, cfg,
                                   {"tokens": toks[:, :n - 1],
                                    "enc_embeds": enc}, torch)
    short = MT.grow_cache(cfg, short, n)
    step, _ = MT.decode_step(params, short, toks[:, n - 1:n], cfg)
    consistency(f"I1 whisper-large-v3 ({n - 1} + 1 -> {n} tokens)", step,
                full, vocab)
    del short, step
    cache = MT.grow_cache(cfg, cache, n + DECODE_STEPS)
    tok = torch.argmax(full[:, :vocab], -1)[:, None].to(torch.int32)
    cache = dense_decode("I1", MT, params, cfg, cache, tok, DECODE_STEPS,
                         torch, np)
    if cache["pos"] != n - 1 + DECODE_STEPS or cache["layers"][1][0] \
            is not cross:
        fail(f"I1 decode: position {cache['pos']}, or the cross cache was "
             "replaced")


def _frontend_i2(seed, dev, torch, np, MT):
    """qwen2-vl-2b at its published widths and depth: a cold and a warm
    prefill of 4 x 4,096 embeddings with Qwen2-VL's positions (a 512-token
    prefix, one image of 56 x 56 merged patches, text after), the check
    (one decode step by embedding at the reference's position (S, S, S)
    against a prefill of 4,097 whose last position is that), 32 decode
    steps by token."""
    cfg, params, count, init_s = _frontend_params(
        "I2", "qwen2-vl-2b", I2_PARAMS, seed, dev, torch, MT)
    vocab, n, b = cfg.vocab_size, I2_LEN, I2_PROMPTS
    log(f"I2 qwen2-vl-2b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, "
        f"M-RoPE sections {cfg.mrope_sections} theta {cfg.rope_theta:g}, "
        f"d_ff {cfg.d_ff} SwiGLU, vocab {vocab}, {cfg.dtype}: {count:,} "
        f"parameters, random init (seed {seed}) in {init_s:.2f} s")
    emb = _randn((b, n + 1, cfg.d_model), seed, dev,
                 getattr(torch, cfg.dtype), torch)
    pos = mrope_positions([I2_TEXT0] * b, I2_GRID, n, np)
    pos = torch.from_numpy(np.concatenate(
        [pos, np.full((3, b, 1), n, np.int32)], axis=2)).to(dev)
    batch = {"embeds": emb[:, :n], "positions": pos[:, :, :n]}
    _, _, cold, peak = dense_prefill("I2", MT, params, cfg, batch, torch)
    cache, _, warm, _ = dense_prefill("I2", MT, params, cfg, batch, torch)
    log(f"I2 prefill {b} x {n} embeddings ({I2_TEXT0} text + "
        f"{I2_GRID} x {I2_GRID} image patches + "
        f"{n - I2_TEXT0 - I2_GRID ** 2} text; positions up to "
        f"{int(pos[:, :, :n].max())}): cold {cold:.3f} s, warm {warm:.3f} "
        f"s, {b * n / warm:,.0f} tokens/s, peak {peak:.2f} GiB; card "
        f"{card_line()}")
    cache = MT.grow_cache(cfg, cache, n + 1 + DECODE_STEPS)
    step, cache = MT.decode_step(params, cache, None, cfg,
                                 embeds=emb[:, n:])
    _, full, _, _ = dense_prefill("I2", MT, params, cfg,
                                  {"embeds": emb, "positions": pos}, torch)
    consistency(f"I2 qwen2-vl-2b ({n} + 1 at ({n}, {n}, {n}) -> {n + 1})",
                step, full, vocab)
    del full
    tok = torch.argmax(step[:, :vocab], -1)[:, None].to(torch.int32)
    cache = dense_decode("I2", MT, params, cfg, cache, tok, DECODE_STEPS,
                         torch, np)
    if cache["pos"] != n + DECODE_STEPS:
        fail(f"I2 decode: position {cache['pos']}")


def _train_steps(what, cfg, params, make_batch, tokens, flops, torch, np):
    """``I3_STEPS`` steps of ``make_train_step`` (``launch/train.py``'s
    optimizer), each synchronized and timed, the batch made first;
    ``tokens`` the decoder tokens a step, ``flops`` its model flops (6 x
    each parameter x the positions it multiplies)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import init_opt_state

    ocfg = _opt_cfg(cfg)
    step = make_train_step(cfg, ocfg)
    state = init_opt_state(params, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(I3_STEPS):
        batch = make_batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _, m = step(params, state, None, batch)
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if not np.isfinite(loss):
            fail(f"{what} step {i + 1}: loss {loss}")
        log(f"{what} step {i + 1}: loss {loss:.4f}, wall {walls[-1]:.3f} s, "
            f"{tokens / walls[-1]:,.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
            f"{card_line()}")
    p50 = float(np.percentile(walls, 50))
    share = flops / p50 / BF16_OPS
    log(f"check {what}: ok, {I3_STEPS} steps, every loss finite "
        f"({[round(x, 4) for x in losses]}); step wall p50 {p50:.3f} s "
        f"(first {walls[0]:.3f}), {tokens / p50:,.0f} tokens/s, model-flops "
        f"share {share:.4f} ({flops / 1e12:.1f} TFLOP a step / step wall / "
        f"{BF16_OPS / 1e12:.0f} TFLOP/s bf16), grad_accum {cfg.grad_accum},"
        f" remat {cfg.remat}; card {card_line()}")


def _frontend_i3(seed, dev, torch, np, MT):
    """Both archs at their published widths and depths trained through
    ``make_train_step`` (the reference's pipeline makes tokens only):
    whisper 4 x (1,500 frames + 448 tokens), qwen2-vl 4 x 2,048 embeddings
    with ``grad_accum`` 2 (each row's image at another offset, so the
    split of the (3, B, S) positions shows), ``I3_STEPS`` steps each."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config

    rng = np.random.default_rng(seed)
    cfg = get_config("whisper-large-v3")
    b, n = I3_WHISPER
    params = MT.init_params(cfg, seed=seed, device=dev)
    dt = getattr(torch, cfg.dtype)

    def whisper_batch(i):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, n + 1))
                                .astype(np.int32)).to(dev)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "enc_embeds": _randn((b, cfg.encoder_seq, cfg.d_model),
                                     seed + i, dev, dt, torch)}

    # the encoder's parameters multiply the frames, the rest but the
    # token table (a gather) the tokens
    n_enc = sum(p.numel() for p in params.enc_stack.parameters()) + sum(
        p.numel() for p in params.enc_final_norm.parameters())
    flops = 6.0 * (n_enc * b * cfg.encoder_seq + (
        MT.num_params(params) - n_enc - params.embed.numel()) * b * n)
    log(f"I3 whisper-large-v3: {MT.num_params(params):,} parameters "
        f"({n_enc:,} in the encoder), {b} x ({cfg.encoder_seq} frames + {n}"
        f" tokens) a step; tokens/s below counts the decoder's tokens")
    _train_steps("I3 whisper-large-v3 train", cfg, params, whisper_batch,
                 b * n, flops, torch, np)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    b, n, accum, grid = I3_QWEN
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"), grad_accum=accum)
    params = MT.init_params(cfg, seed=seed, device=dev)
    text0 = [n // 8 + n // 32 * r for r in range(b)]  # 256 + 64 r
    pos = torch.from_numpy(mrope_positions(text0, grid, n, np)).to(dev)

    def qwen_batch(i):
        return {"embeds": _randn((b, n, cfg.d_model), seed + i, dev, dt,
                                 torch), "positions": pos,
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (b, n)).astype(np.int32)).to(dev)}

    log(f"I3 qwen2-vl-2b: {MT.num_params(params):,} parameters, {b} x {n} "
        f"embeddings a step in {accum} microbatches (image {grid} x {grid} "
        f"after text prefixes of {text0})")
    # the token table is not read: the batch carries embeddings
    flops = 6.0 * (MT.num_params(params) - params.embed.numel()) * b * n
    _train_steps("I3 qwen2-vl-2b train", cfg, params, qwen_batch, b * n,
                 flops, torch, np)


def _frontend_i4(arch, sections, seed, dev, torch, np, MT):
    """``arch`` at ``reduced_config`` in float32 (qwen2-vl also with
    ``sections``, so that all three M-RoPE streams act at head_dim 32) on
    the card against the host, one set of weights (biases and norm
    weights moved off their init): a prefill of 2 x 16, 8 decode steps
    (qwen2-vl by embedding and by token in turn), one ``forward_train``,
    within ``H3_TOL``.  A whisper key bias's gradient is zero in exact
    arithmetic (no rotation follows it: the softmax takes the constant
    out), so it is held within the bound of its query bias's gradient."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, reduced_config

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    if sections is not None:
        cfg = dataclasses.replace(cfg, mrope_sections=sections)
    host = MT.init_params(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for p in host.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    card = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(seed)
    s, steps, d = I4_LEN, I4_DECODE, cfg.d_model

    def t(a):
        return torch.from_numpy(a)

    batch = {"labels": t(rng.integers(0, cfg.vocab_size, (2, s)).astype(
        np.int32))}
    if cfg.embeds_input:
        batch["embeds"] = t(rng.standard_normal((2, s, d)).astype(
            np.float32))
        batch["positions"] = t(mrope_positions([3, 5], 2, s, np))
    else:
        batch["tokens"] = t(rng.integers(0, cfg.vocab_size, (2, s)).astype(
            np.int32))
    if cfg.encoder_layers:
        batch["enc_embeds"] = t(rng.standard_normal(
            (2, cfg.encoder_seq, d)).astype(np.float32))
    toks = t(rng.integers(0, cfg.vocab_size, (2, steps)).astype(np.int32))
    embs = t(rng.standard_normal((2, steps, d)).astype(np.float32))
    runs = []
    for params, where in ((card, dev), (host, torch.device("cpu"))):
        bw = {k: x.to(where) for k, x in batch.items()}
        cache, lg = MT.prefill(params, bw, cfg)
        cache = MT.grow_cache(cfg, cache, s + steps)
        out = [lg]
        for i in range(steps):
            emb = (embs[:, i:i + 1].to(where)
                   if cfg.embeds_input and i % 2 == 0 else None)
            lg, cache = MT.decode_step(params, cache,
                                       toks[:, i:i + 1].to(where), cfg,
                                       embeds=emb)
            out.append(lg)
        leaves = [x for kv in cache["layers"] for x in (
            kv if isinstance(kv, tuple) else (kv,))]
        params.requires_grad_(True)
        loss, _ = MT.forward_train(params, bw, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    materialize_grads=True)
        params.requires_grad_(False)
        runs.append(([x[:, :cfg.vocab_size].cpu() for x in out],
                     [x.cpu() for x in leaves], float(loss.detach()),
                     {n: g.cpu() for (n, _), g in
                      zip(params.named_parameters(), grads)}))
    (logits, leaves, loss, grads), (w_logits, w_leaves, w_loss, w_grads) = \
        runs
    lgap = max(float((a - b).abs().max()) for a, b in zip(logits, w_logits))
    cgap = max(float((a - b).abs().max()) for a, b in zip(leaves, w_leaves))
    ggap = 0.0
    for name, w in w_grads.items():
        zero = cfg.rope_kind == "none" and name.endswith(".bk")
        scale = w_grads[name[:-1] + "q"] if zero else w
        ggap = max(ggap, float((grads[name] - w).abs().max()) / max(
            float(scale.abs().max()), 1e-30))
    what = f"I4 {arch}" + (f" sections {sections}" if sections else "")
    if lgap > H3_TOL["logits"] or cgap > H3_TOL["cache"] or abs(
            loss - w_loss) > H3_TOL["loss"] * abs(w_loss) or \
            ggap > H3_TOL["grad"]:
        fail(f"{what}: card vs host logits {lgap:.2e}, caches {cgap:.2e}, "
             f"loss {loss} / {w_loss}, gradients {ggap:.2e} of the leaf's "
             f"max (tol {H3_TOL})")
    log(f"check {what} (reduced, float32): card vs host ok: prefill 2 x "
        f"{s} + {steps} decode steps, logits within {lgap:.2e} (tol "
        f"{H3_TOL['logits']}), caches {cgap:.2e} (tol {H3_TOL['cache']}); "
        f"forward_train: loss {loss:.6f} (gap {abs(loss - w_loss):.2e}), "
        f"gradients within {ggap:.2e} of each leaf's max (tol "
        f"{H3_TOL['grad']})")


# ---------------------------------------------------------------------------
# path D: the time-evolving control plane on the fused engine
# ---------------------------------------------------------------------------


class RunnerProbe:
    """Counts ``FusedEdgeRunner.refresh_membership`` calls and keeps each
    fused runner's worker lanes (``w1``) as first fed and after its last
    feed — the worker-universe growth of a run, read on the card."""

    def __init__(self):
        from repro_torch.kernels.feed_fused import FusedEdgeRunner as R

        self.refreshes = 0
        self.w1 = {}  # id(runner) -> [w1 after its first feed began, last]
        self._real = (R.refresh_membership, R.begin_feed)
        real_refresh, real_begin = self._real

        def refresh(runner, grouper, state):
            self.refreshes += 1
            return real_refresh(runner, grouper, state)

        def begin(runner, *a):
            out = real_begin(runner, *a)
            self.w1.setdefault(id(runner), [runner._w1, None])[1] = \
                runner._w1
            return out
        R.refresh_membership, R.begin_feed = refresh, begin

    def reset(self):
        self.refreshes = 0
        self.w1 = {}

    def uninstall(self):
        from repro_torch.kernels.feed_fused import FusedEdgeRunner as R

        R.refresh_membership, R.begin_feed = self._real


def _holds_event(sess, batch) -> bool:
    """Whether a pending scoped event fires inside this feed (the
    scenario topologies have one edge: its input index is the source's)."""
    n0, n = sess._n_source, len(batch)
    for evs in sess._pending.values():
        for e in evs:
            t = getattr(e, "at_time", None)
            if (t is not None and n and t <= float(batch.timestamps[-1])) \
                    or (t is None and e.at < n0 + n):
                return True
    return False


class _AuditedSession:
    """A simulator session whose fused runner runs under an
    ``EdgeAuditor`` from its second feed on (the first creates it), with
    each feed that fires an event declared ``expect("event")`` and the
    close ``expect("close")``."""

    def __init__(self, sess, pane_stride, auditors):
        self._s = sess
        self._stride = pane_stride
        self._auditors = auditors
        self._aud = None

    def __getattr__(self, name):
        return getattr(self._s, name)

    def advance(self, events):
        return self._s.advance(events)

    def feed(self, batch):
        from repro_torch.analysis.audit import EdgeAuditor

        s = self._s
        if self._aud is None:
            rec = s.feed(batch)
            st = next(iter(s._st.values()), None)
            if st is not None and st.state is not None:
                self._aud = EdgeAuditor(st.state.device, self._stride,
                                        offset=st.n).__enter__()
                self._auditors.append(self._aud)
            return rec
        if _holds_event(s, batch):
            with self._aud.expect("event"):
                return s.feed(batch)
        return s.feed(batch)

    def close(self):
        if self._aud is None:
            return self._s.close()
        with self._aud.expect("close"):
            rep = self._s.close()
        self._aud.restore()
        return rep


@contextlib.contextmanager
def audited_sessions(pane_stride=None):
    """Every ``SimulatorEngine`` session opened inside runs audited; yields
    the list its auditors land in."""
    from repro_torch.topology.engine import SimulatorEngine

    auditors = []
    real_open = SimulatorEngine.open

    def open_(eng, *a, **k):
        return _AuditedSession(real_open(eng, *a, **k), pane_stride,
                               auditors)
    SimulatorEngine.open = open_
    try:
        yield auditors
    finally:
        SimulatorEngine.open = real_open


def check_audit(auditors, what):
    """One audited fused session: the launch and sync budgets held, and
    the numbers it saw."""
    if len(auditors) != 1:
        fail(f"{what}: {len(auditors)} audited sessions, want 1")
    aud = auditors[0]
    if not aud.on_card:
        fail(f"{what}: the audited runner is not on the card")
    try:
        aud.assert_launch_budget()
        aud.assert_sync_budget(closed=True)
    except AssertionError as e:
        fail(f"{what}: {e}")
    ctx = {}
    for e in aud.events:
        if e.kind in ("flush_pane", "host_sync"):
            ctx[e.context] = ctx.get(e.context, 0) + 1
    return (f"audited {aud.dispatches} segments, launches "
            f"{json.dumps(aud.totals())}, refresh_membership "
            f"{aud.count('refresh_membership')}, syncs by context "
            f"{json.dumps(ctx)}: budgets held")


def launch_delta(l0, ff, sp):
    now = dict(ff.LAUNCHES, **sp.LAUNCHES)
    return {k: now[k] - l0[k] for k in now}


def timed(fn, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def scenario_path(dev, torch, syncs, n_tuples=D_TUPLES,
                  ol_rate=OL_RATE):
    """Path D: the RQ4 scenario suite (D1), open loop with autoscaling
    (D2) and a trace of one fused session (D3), on the card."""
    import dataclasses
    import tempfile

    from repro_torch import obs
    from repro_torch import scenarios as S
    from repro_torch.analysis import contracts
    from repro_torch.analysis.sanitize import double_run
    from repro_torch.kernels import feed_fused as ff
    from repro_torch.kernels import store_probe as sp
    from repro_torch.obs.cli import summarize_trace
    from repro_torch.obs.export import TraceWriter, validate_chrome_trace
    from repro_torch.state import WindowOp

    t_d = time.perf_counter()
    for d in (ff.LAUNCHES, sp.LAUNCHES):
        d.update(dict.fromkeys(d, 0))
    probe = RunnerProbe()
    win_card = WindowOp(agg="sum", size=WINDOW, backend="device")
    win_host = WindowOp(agg="sum", size=WINDOW, backend="array")
    feeds = D_FEEDS
    log(f"path D1: default_scenarios(num_tuples={n_tuples}, num_keys="
        f"{NUM_KEYS}, workers={WORKERS}): {n_tuples} tuples a run, cut "
        f"from path A's {N_TUPLES} for time; {feeds} feeds of "
        f"{n_tuples // feeds}; a tumbling {WINDOW}-tuple sum window "
        f"(device store on the card, array store on the host); fused "
        f"(card) against batched (host), all six schemes")
    d1 = {}
    for sc in S.default_scenarios(num_tuples=n_tuples, num_keys=NUM_KEYS,
                                  workers=WORKERS):
        _, keys_s = timed(lambda: S.build_keys(sc.workload), torch)
        for scheme in SCHEMES:
            probe.reset()
            l0, s0 = dict(ff.LAUNCHES, **sp.LAUNCHES), syncs.n
            audit = scheme in D_AUDITED
            ctx = (audited_sessions(WINDOW) if audit
                   else contextlib.nullcontext([]))
            with ctx as auditors:
                rf, wall_f = timed(lambda: S.run_dspe_scenario(
                    sc, scheme, engine="fused", window=win_card,
                    feeds=feeds, device=dev), torch)
            dl = launch_delta(l0, ff, sp)
            n_sync = syncs.n - s0
            w1 = list(probe.w1.values())
            if len(w1) != 1:
                fail(f"D1 {sc.name} {scheme}: {len(w1)} fused runners, "
                     "want 1 (a fallback to the host engine?)")
            rb, wall_b = timed(lambda: S.run_dspe_scenario(
                sc, scheme, engine="batched", window=win_host,
                feeds=feeds), torch)
            why = contracts.row_violations(scheme, rf, rb)
            for k in ("remap_events", "remap_frac_mean"):
                if rf[k] != rb[k]:
                    why.append(f"{k} {rf[k]} != {rb[k]}")
            for r, eng in ((rf, "fused"), (rb, "batched")):
                if not r["state"]["exact"]:
                    why.append(f"{eng} merged windows != direct_aggregate")
            if rf["state"]["windows"] != rb["state"]["windows"]:
                why.append("window counts differ")
            segs = dl["fifo_workers"]
            want = contracts.SEGMENT_KERNELS[scheme]
            bad = {k: v for k, v in dl.items()
                   if k not in ("pane_update", "store_probe")
                   and v != (segs if k in want else 0)}
            if bad or dl["pane_update"] < segs:
                why.append(f"launches {dl} off the budget of {segs} "
                           f"segments x {want} + pane_update")
            if why:
                fail(f"D1 {sc.name} {scheme}: fused vs batched: "
                     + "; ".join(why))
            d1[(sc.name, scheme)] = {
                "fused_tuples_per_s": n_tuples / wall_f,
                "batched_tuples_per_s": n_tuples / wall_b,
                "segments": segs, "pane_syncs": n_sync, "launches": dl,
                "refresh_membership": probe.refreshes, "w1": w1[0]}
            log(f"D1 {sc.name:18s} {scheme:4s}: fused {n_tuples / wall_f:,.0f}"
                f" tuples/s (card) vs batched {n_tuples / wall_b:,.0f} "
                f"(host), keys built in {keys_s * 1e3:.0f} ms of each; "
                f"{feeds} feeds, {segs} segments, {n_sync} pane syncs, "
                f"launches {json.dumps({k: v for k, v in dl.items() if v})}"
                f", refresh_membership {probe.refreshes}, w1 {w1[0][0]} -> "
                f"{w1[0][1]}; remaps {len(rf['remap_events'])} (mean frac "
                f"{rf['remap_frac_mean']}); check ok: exec "
                f"{rf['execution_time']:.6f}/{rb['execution_time']:.6f} s, "
                f"p99 {rf['latency_p99']:.6f}/{rb['latency_p99']:.6f} s, "
                f"imbalance {rf['imbalance']:.6f}/{rb['imbalance']:.6f}, "
                f"memory {rf['memory_overhead']}/{rb['memory_overhead']}, "
                f"windows exact")
            if audit:
                log(f"   audit {sc.name} {scheme}: "
                    + check_audit(auditors, f"D1 {sc.name} {scheme}"))
    log("path D1 per run: " + json.dumps(
        {f"{sc}/{scheme}": v for (sc, scheme), v in d1.items()}))
    grew = [k for k, v in d1.items() if v["w1"][1] > v["w1"][0]]
    if not grew:
        fail("D1: no run grew the runner's worker lanes on the card")
    log(f"D1: worker lanes grew on the card in {len(grew)} runs "
        f"({', '.join(sorted({k[0] for k in grew}))})")

    storm = next(s for s in S.default_scenarios(
        num_tuples=n_tuples, num_keys=NUM_KEYS, workers=WORKERS)
        if s.name == "churn_storm")
    (r1, r2, div), wall = timed(lambda: double_run(
        lambda: S.run_dspe_scenario(storm, "fish", engine="fused",
                                    window=win_card, feeds=feeds,
                                    device=dev)), torch)
    if div:
        fail(f"D1 churn_storm fish: the sanitized double run diverges: "
             f"{div[:5]}")
    log(f"D1 churn_storm fish: sanitized double run bit-identical "
        f"({wall:.2f} s for both, readbacks finite)")

    # -- D2: open loop with autoscaling ----------------------------------------
    tick = S.OpenLoopScenario("t").tick
    log(f"path D2: default_open_loop_scenarios(rate={ol_rate:g}, horizon="
        f"{OL_HORIZON}, workers={OL_WORKERS}, num_keys={NUM_KEYS}), "
        f"max_workers={OL_MAX_WORKERS}, slo_p99={OL_SLO_P99} s: at "
        f"utilization 0.8 a worker takes {0.8 * OL_WORKERS / ol_rate * 1e3:.3f}"
        f" ms a tuple, so a run at the mean rate keeps p99 within a few "
        f"ms, while the 3x flash crowd overloads the pool and its p99 "
        f"climbs toward the 0.25 s backpressure bound: {OL_SLO_P99 * 1e3:g} "
        f"ms lies between the two; feeds of about "
        f"{ol_rate * tick:,.0f} tuples (tick {tick} s)")
    d2 = {}
    for ol in S.default_open_loop_scenarios(rate=ol_rate,
                                            horizon=OL_HORIZON,
                                            workers=OL_WORKERS,
                                            num_keys=NUM_KEYS):
        ol = dataclasses.replace(ol, max_workers=OL_MAX_WORKERS,
                                 slo_p99=OL_SLO_P99)
        for scheme in SCHEMES:
            probe.reset()
            l0 = dict(ff.LAUNCHES, **sp.LAUNCHES)
            audit = scheme in D_AUDITED
            ctx = (audited_sessions() if audit
                   else contextlib.nullcontext([]))
            with ctx as auditors:
                rf, wall_f = timed(lambda: S.run_open_loop_scenario(
                    ol, scheme, engine="fused", device=dev), torch)
            dl = launch_delta(l0, ff, sp)
            w1 = list(probe.w1.values())
            rb, wall_b = timed(lambda: S.run_open_loop_scenario(
                ol, scheme, engine="batched"), torch)
            why = []
            if len(w1) != 1:
                why.append(f"{len(w1)} fused runners, want 1")
            if not rf["identity_ok"]:
                why.append("offered != fed + shed + residual")
            wf = rf["workers_final"]
            if not OL_WORKERS <= len(wf) <= OL_MAX_WORKERS:
                why.append(f"{len(wf)} workers at the end")
            if ol.name == "flash_crowd" and not rf["autoscale_events"]:
                why.append("the flash crowd caused no autoscale event")
            if scheme in contracts.EXACT_SCHEMES:
                why += contracts.row_violations(scheme, rf, rb)
                for k in ("offered", "fed", "shed", "residual",
                          "workers_final"):
                    if rf[k] != rb[k]:
                        why.append(f"{k} {rf[k]} != {rb[k]}")
                ef, eb = rf["autoscale_events"], rb["autoscale_events"]
                if [dict(e, p99=None) for e in ef] != \
                        [dict(e, p99=None) for e in eb] or any(
                        abs(a["p99"] - b["p99"])
                        > contracts.F32_REL * b["p99"]
                        for a, b in zip(ef, eb)):
                    why.append("autoscale decisions differ")
            if why:
                fail(f"D2 {ol.name} {scheme}: " + "; ".join(why))
            n = rf["offered"]
            d2[(ol.name, scheme)] = {
                "fused_tuples_per_s": rf["fed"] / wall_f,
                "batched_tuples_per_s": rb["fed"] / wall_b,
                "segments": dl["fifo_workers"], "launches": dl,
                "autoscale_events": len(rf["autoscale_events"]),
                "refresh_membership": probe.refreshes, "w1": w1[0]}
            log(f"D2 {ol.name:20s} {scheme:4s}: fused {rf['fed'] / wall_f:,.0f}"
                f" tuples/s (card) vs batched {rb['fed'] / wall_b:,.0f} "
                f"(host); offered {n}, fed {rf['fed']}, shed {rf['shed']}, "
                f"deferred {rf['deferred']}; {dl['fifo_workers']} segments, "
                f"launches {json.dumps({k: v for k, v in dl.items() if v})}"
                f", autoscale events {len(rf['autoscale_events'])} (batched "
                f"{len(rb['autoscale_events'])}), workers {OL_WORKERS} -> "
                f"{len(wf)}, refresh_membership {probe.refreshes}, w1 "
                f"{w1[0][0]} -> {w1[0][1]}; p99 {rf['latency_p99']:.6f}/"
                f"{rb['latency_p99']:.6f} s, total p99 "
                f"{rf['total_latency_p99']}; check ok"
                + (" (exact)" if scheme in contracts.EXACT_SCHEMES
                   else " (identity and budgets; banded timing may move "
                        "backpressure and autoscale decisions)"))
            if audit:
                log(f"   audit {ol.name} {scheme}: "
                    + check_audit(auditors, f"D2 {ol.name} {scheme}"))
    log("path D2 per run: " + json.dumps(
        {f"{ol}/{scheme}": v for (ol, scheme), v in d2.items()}))
    if not any(v["w1"][1] > v["w1"][0] for k, v in d2.items()
               if k[0] == "flash_crowd"):
        fail("D2: no autoscaler scale-out grew the runner's worker lanes")

    launches = dict(ff.LAUNCHES, **sp.LAUNCHES)
    log(f"launches on path D (D1 and D2): {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on path D: {missing}")
    probe.uninstall()
    log(f"path D1+D2 wall {time.perf_counter() - t_d:.1f} s")

    # -- D3: one traced session (telemetry reads the tracker back each
    # epoch, so it is never timed) -------------------------------------------
    flip = S.default_scenarios(num_tuples=n_tuples, num_keys=NUM_KEYS,
                               workers=WORKERS)[0]
    tel = obs.enable(label="hot_key_flip-fish")
    try:
        S.run_dspe_scenario(flip, "fish", engine="fused", window=win_card,
                            feeds=feeds, device=dev)
    finally:
        obs.disable()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "hot_key_flip-fish.trace.json"
        with TraceWriter(str(path)) as w:
            w.write_telemetry(tel)
        trace = json.loads(path.read_text())
        size = path.stat().st_size
    problems = validate_chrome_trace(trace)
    if problems:
        fail(f"D3: the trace is not valid: {problems[:5]}")
    spans = summarize_trace(trace)["spans"]
    top = sorted(spans.items(), key=lambda kv: -kv[1]["total_ms"])[:10]
    log(f"D3 trace hot_key_flip fish: {len(trace['traceEvents'])} events, "
        f"{size:,} bytes, valid; top spans (count, total ms, p50 ms):")
    for name, sp_ in top:
        log(f"   {name:28s} {sp_['count']:6d} {sp_['total_ms']:10.3f} "
            f"{sp_['p50_ms']:9.4f}")
    log("D3 spans: " + json.dumps(
        {k: {f: v[f] for f in ("count", "total_ms", "p50_ms")}
         for k, v in top}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuples", type=int, default=N_TUPLES,
                    help="stream length per scheme of paths A and B (a cut "
                    "for time)")
    ap.add_argument("--scenario-tuples", type=int, default=D_TUPLES,
                    help="tuples a path D scenario run (a cut for time)")
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
        from repro_torch.analysis import contracts
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
    # the launch budget: one launch of each of the scheme's segment
    # kernels per segment, pane_update also once per pane table growth
    for scheme in SCHEMES:
        dl = path_a[scheme]["launches"]
        want = contracts.SEGMENT_KERNELS[scheme]
        bad = {k: v for k, v in dl.items() if k not in ("pane_update",
                                                        "store_probe")
               and v != (segments if k in want else 0)}
        if bad or dl["pane_update"] < segments:
            fail(f"{scheme}: launches {dl} off the budget of {segments} "
                 f"segments x {want} + pane_update")
        log(f"launches {scheme:4s}: {len(want) + 1} per segment x "
            f"{segments} segments (+ {dl['pane_update'] - segments} pane "
            f"table growths)")
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

    # -- path D: the time-evolving control plane ---------------------------------
    scenario_path(dev, torch, syncs, n_tuples=args.scenario_tuples)
    log(f"path D (scenarios, open loop, trace) done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- path E: the dense decoder family -----------------------------------------
    attention_times("E1 layer 0", dense_path(args.seed, dev, torch, np),
                    torch)
    log(f"path E (dense family) done at {time.perf_counter() - t_start:.1f} s")

    # -- path F: the MoE family ----------------------------------------------------
    moe_path(args.seed, dev, torch, np)
    log(f"path F (MoE family) done at {time.perf_counter() - t_start:.1f} s")

    # -- path G: training ------------------------------------------------------------
    train_path(args.seed, dev, torch, np)
    log(f"path G (training) done at {time.perf_counter() - t_start:.1f} s")

    # -- path H: the Griffin family --------------------------------------------
    griffin_path(args.seed, dev, torch, np)
    log(f"path H (Griffin) done at {time.perf_counter() - t_start:.1f} s")

    # -- path I: the frontend stubs (whisper, qwen2-vl) ------------------------
    frontend_path(args.seed, dev, torch, np)
    log(f"path I (frontend stubs) done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # path A's and B's kernels last: their device times come from
    # torch.profiler, whose tracing is kept away from the timed paths
    rows = kernel_checks(cap, torch, np, launches)
    log(f"path A kernel checks done at {time.perf_counter() - t_start:.1f} s")
    ssd_device_times(ssd_cap, ssd_rows, torch)
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
