"""Every hand-written CUDA kernel against its plain PyTorch version, on the
card (``cuda``-marked; each test skips where there is no card — a CUDA
kernel has no CPU interpret mode).  This file imports neither JAX nor the
JAX package, so it runs on a machine with the card alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly; so must the float ones of the stream
and FISH kernels, since both versions round the same float32/float64
operations in the same order (the kernels build with ``-fmad=false``).
The SSD kernels run their products on the tensor cores in 3xTF32 and sum
in another order than the plain einsums: within 3e-4
(``tests/test_kernels.py``'s bound).
"""

import copy
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.chash import ConsistentHashRing, hash32
from repro_torch.data.synthetic import zipf_time_evolving
from repro_torch.core import fish as F
from repro_torch.kernels import feed_fused as ff
from repro_torch.kernels import fish_count as fc
from repro_torch.kernels import ops
from repro_torch.kernels import ssd
from repro_torch.kernels import store_probe as sp
from repro_torch.models import transformer as PT

import torch_helpers  # caps torch threads; shared cases

T = torch.from_numpy


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(300, 5_000), (1, 7), (4_096, 100_000)])
def test_cuda_store_probe_matches_plain(k, n):
    dev = _card()
    rng = np.random.default_rng(k)
    table = np.sort(rng.choice(4 * k + 10, size=k, replace=False)).astype(
        np.int32)
    keys = rng.integers(0, 4 * k + 10, n).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    args = [T(x).to(dev) for x in (table, keys, vals)]
    got = sp.store_probe(*args, validate=True)
    want = sp.store_probe_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if k > 1:  # a descending table breaks the kernel's precondition
        with pytest.raises(ValueError, match="ascending"):
            sp.store_probe(args[0].flip(0), args[1], args[2], validate=True)


def _segment(seed=10, m=1_500, n_pad=2_048, kcap=1_024, workers=8,
             z=1.4, on_ring=None, live=None):
    """One segment's inputs over ``workers`` worker lanes (w1 = workers +
    1): the ring holds ``on_ring`` (default every worker; fewer leave -1 at
    the rows' ends), ``live`` are WC's live lanes (default every worker)."""
    rng = np.random.default_rng(seed)
    keys = np.full(n_pad, kcap, np.int32)
    keys[:m] = zipf_time_evolving(m, num_keys=kcap, z=z, seed=seed)
    ring = ConsistentHashRing(
        range(workers) if on_ring is None else on_ring, virtual_nodes=16)
    pts, cands = ff._build_ring_table(ring, max(workers, 2))
    hashes = np.asarray([hash32(int(k)) for k in np.unique(keys[:m])],
                        np.uint32)
    h = np.zeros(n_pad, np.uint32)
    h[:m] = hashes[np.searchsorted(np.unique(keys[:m]), keys[:m])]
    w1 = workers + 1
    return dict(
        m=m, n_pad=n_pad, kcap=kcap, w1=w1, keys=keys, pts=pts, cands=cands,
        h=h, counts=rng.integers(0, 5, w1).astype(np.int32),
        t=np.sort(rng.random(n_pad) * 0.1),
        busy=rng.random(w1) * 0.05, caps=rng.uniform(5e-4, 2e-3, w1),
        act_mask=(np.arange(w1) < workers if live is None
                  else np.isin(np.arange(w1), live)),
        ebl=(rng.random(w1) * 3).astype(np.float32),
        eas=rng.integers(0, 4, w1).astype(np.float32),
        ecaps=rng.uniform(0.5, 1.5, w1).astype(np.float32),
        m_k=np.where(np.arange(kcap + 1) < 20, rng.integers(0, 6, kcap + 1),
                     0).astype(np.int32))


def _run_segment(scheme, s, where):
    """ring_rows, tracker_segment, route_scan, fifo_workers and
    pane_update of one segment on ``where``; every output and every
    state tensor they update."""
    m, n_pad, kcap, w1 = s["m"], s["n_pad"], s["kcap"], s["w1"]
    width = {"fg": 1, "pkg": 2}.get(scheme, s["cands"].shape[1])
    d = torch.device(where)
    up = (lambda a: T(np.ascontiguousarray(a)).to(d))
    kw = {}
    fixed = {}
    rows = None
    if scheme != "sg":
        rows = ff.ring_rows(up(ff._u32_bits(s["pts"])), up(s["cands"]),
                            up(ff._u32_bits(s["h"])), None, m, width, n_pad)
    else:
        a_live = s.get("a_live", w1 - 1)
        fixed.update(act=up(np.arange(w1, dtype=np.int32)), a_live=a_live,
                     rr=2)
    if scheme in ("dc", "wc", "fish"):
        trk = torch.zeros(kcap + 1, dtype=torch.float32, device=d)
        carry = torch.zeros(2, dtype=torch.float32, device=d)
        tk = (dict(g0=300, epoch=500, pre=0, ne=-(-(m + 300) // 500),
                   alpha=0.2)
              if scheme == "fish" else dict(ne=1))
        fv, tot, top = ff.tracker_update(trk, carry, up(s["keys"]), m, **tk)
        kw.update(trk=trk, carry=carry, fv=fv, tot=tot, top=top,
                  g0=tk.get("g0", 0), epoch=tk.get("epoch", 0),
                  theta=0.25 / (w1 - 1), wnum=float(w1 - 1),
                  act_mask=up(s["act_mask"]))
    if scheme == "fish":
        kw.update(m_k=up(s["m_k"]), d_min=2, ebl=up(s["ebl"]),
                  eas=up(s["eas"]), ecaps=up(s["ecaps"]), do_tick=1,
                  elapsed=0.3)
    busy, counts = up(s["busy"]), up(s["counts"])
    fifo = dict(t=up(s["t"]), busy=busy, caps=up(s["caps"]), counts=counts)
    if scheme in ("sg", "fg"):
        workers, fin = ff.fifo_workers(scheme, m, rows=rows, **fifo, **fixed)
    else:
        workers = ff.route_scan(scheme, m, keys=up(s["keys"]), counts=counts,
                                rows=rows, **{k: v for k, v in kw.items()
                                              if k not in ("trk", "carry")})
        workers, fin = ff.fifo_workers(scheme, m, workers=workers, **fifo)
    cap = ff.pane_capacity(m)
    pane_keys = torch.empty(cap, dtype=torch.int64, device=d)
    pane_vc = torch.empty((2, cap), dtype=torch.int32, device=d)
    last = torch.zeros((w1,), dtype=torch.int32, device=d)
    repl = torch.zeros((kcap + 1, w1), dtype=torch.bool, device=d)
    ff.pane_update(up(s["keys"]), workers, m, repl=repl, vals=up(s["keys"]),
                   seg_base=7, pane_keys=pane_keys, pane_vc=pane_vc,
                   pane_last=last, reset=True)
    # the pane in canonical form: slot places differ between the two
    pairs, vc = ff.pane_canonical(pane_keys, pane_vc)
    outs = [workers[:m], fin[:m], busy, counts, pairs, vc, last, repl]
    outs += [kw[k] for k in ("trk", "carry", "fv", "tot", "top", "m_k",
                             "ebl", "eas") if kw.get(k) is not None]
    if rows is not None:
        outs.append(rows)
    return outs


def _assert_card_equals_plain(scheme, s):
    before = dict(ff.LAUNCHES)
    card = _run_segment(scheme, s, "cuda")
    plain = _run_segment(scheme, s, "cpu")
    for c, p in zip(card, plain):
        assert torch.equal(c.cpu(), p), scheme
    routed = scheme not in ("sg", "fg")
    assert ff.LAUNCHES["route_scan"] == before["route_scan"] + routed
    assert ff.LAUNCHES["fifo_workers"] == before["fifo_workers"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sg", "fg", "pkg", "dc", "wc", "fish"])
def test_cuda_segment_kernels_match_plain(scheme):
    """One whole segment — ring_rows, tracker_segment, route_scan,
    fifo_workers and pane_update — on the card and through the plain
    versions."""
    _card()
    _assert_card_equals_plain(scheme, _segment())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sg", "fg", "pkg", "dc", "wc", "fish"])
def test_cuda_segment_kernels_match_plain_at_main_path_shapes(scheme):
    """The main path's segment: 16,384 tuples of a z = 1.2 stream over a
    100,000-key table, 128 workers (w1 = 129), candidate width 128."""
    _card()
    _assert_card_equals_plain(scheme, _segment(
        seed=12, m=16_384, n_pad=16_384, kcap=100_000, workers=128, z=1.2))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sg", "pkg", "fish"])
def test_cuda_segment_kernels_match_plain_one_worker(scheme):
    """Every tuple on one worker: SG with one live worker, PKG and FISH on
    a ring of one — fifo_workers' longest possible run."""
    _card()
    s = _segment(seed=13, m=3_000, n_pad=4_096, workers=1)
    s["a_live"] = 1
    _assert_card_equals_plain(scheme, s)


def _tracker_run(where, trk0, carry0, keys, m, kw, **variant):
    """tracker_update on ``where`` from (trk0, carry0): trk, carry, fv,
    tot, top, on the CPU."""
    d = torch.device(where)
    trk = T(trk0.copy()).to(d)
    carry = T(carry0.copy()).to(d)
    fv, tot, top = ff.tracker_update(trk, carry, T(keys).to(d), m, **kw,
                                     **variant)
    return [x.cpu() for x in (trk, carry, fv, tot, top)]


def _tracker_case(case):
    """(trk0, carry0, keys, m, kw) of one tracker case."""
    rng = np.random.default_rng(40)
    kcap, m, n_pad = 100_000, 16_384, 16_384
    keys = np.full(n_pad, kcap, np.int32)
    keys[:m] = zipf_time_evolving(m, num_keys=kcap, z=1.2, seed=41)
    trk0 = np.zeros(kcap + 1, np.float32)
    trk0[:kcap] = rng.integers(0, 40, kcap) * (rng.random(kcap) < 0.2)
    kw = dict(g0=17_000, epoch=1_000, pre=1, ne=17, alpha=0.2)
    if case == "m1":
        m = 1
    elif case == "one_key":
        keys[:m] = 4_321
    elif case == "edge_keys":  # the last key and the phantom row
        keys[:m:3] = kcap - 1
        keys[1:m:7] = kcap
    elif case == "dcwc":
        kw = dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
    elif case == "dcwc_2p24":  # values past 2^24: counts round as they add
        kw = dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
        trk0[:kcap:7] = 2.0 ** 24 - 2
    elif case == "ne1":
        kw = dict(g0=21_000, epoch=20_000, pre=0, ne=1, alpha=0.2)
    elif case == "ne_many":  # epochs of 200: ne = 83, past the 64-bit mask
        kw = dict(g0=150, epoch=200, pre=0, ne=83, alpha=0.2)
    elif case == "ne_huge":  # epochs of 8: ne = 2,048, past 1,024 maxima
        kw = dict(g0=8, epoch=8, pre=1, ne=2_048, alpha=0.2)
    elif case == "alpha1_epochs":
        kw = dict(g0=500, epoch=1_000, pre=0, ne=17, alpha=1.0)
    if kw["epoch"]:
        g0, ep = kw["g0"], kw["epoch"]
        kw["ne"] = (g0 + m - 1) // ep - g0 // ep + 1
        kw["pre"] = 1 if (g0 > 0 and g0 % ep == 0) else 0
    carry0 = np.asarray([trk0.sum(dtype=np.float32), trk0.max()],
                        np.float32)
    return trk0, carry0, keys, m, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fish", "m1", "one_key", "edge_keys",
                                  "dcwc", "dcwc_2p24", "ne1", "ne_many",
                                  "ne_huge", "alpha1_epochs"])
def test_cuda_tracker_segment_matches_plain(case):
    """tracker_segment against tracker_update_plain, bit for bit on trk,
    the carried (total, max), fv, tot and top: a FISH segment at the main
    path's shapes (16,384 tuples of a z = 1.2 stream over 100,000 keys,
    17 epochs starting on a boundary), one tuple, every tuple on one key,
    keys at the capacity's edge and in the phantom row, DC/WC (no epochs;
    and with values past 2^24, where the counts round as they add), one
    epoch, 83 and 2,048 epochs (past the kernel's ordinal mask and its
    per-block maxima), and alpha = 1 with epochs.  One launch each."""
    _card()
    trk0, carry0, keys, m, kw = _tracker_case(case)
    before = ff.LAUNCHES["tracker_segment"]
    card = _tracker_run("cuda", trk0, carry0, keys, m, kw)
    assert ff.LAUNCHES["tracker_segment"] == before + 1
    plain = _tracker_run("cpu", trk0, carry0, keys, m, kw)
    for name, c, p in zip(("trk", "carry", "fv", "tot", "top"), card,
                          plain):
        assert torch.equal(c, p), (case, name)
    assert card[1][1] == card[0].max()  # the carried max is trk's max


@pytest.mark.cuda
@pytest.mark.parametrize("m,kcap,scheme,tables", [
    (16_384, 100_000, "fish", "shared"),
    (16_384, 1 << 21, "fish", "shared"),
    (70_000, 100_000, "fish", "global"),
    (70_000, 100_000, "dc", "global"),
    (30_000, 1_000, "fish", "shared")])
def test_cuda_tracker_segment_variants_match_plain(m, kcap, scheme, tables):
    """Each layout the card's plan picks by the tables' size — the tables
    in the blocks' shared memory, or (>= 2 x 70,000 pair slots) in global
    scratch, with tuples past the four rounds a thread keeps in registers
    — gives the plain version's outputs: FISH and DC/WC, over path A's key
    capacity, KEY_CAP_LIMIT's and a small one."""
    _card()
    rng = np.random.default_rng(44)
    keys = zipf_time_evolving(m, num_keys=kcap, z=1.2,
                              seed=45).astype(np.int32)
    trk0 = np.zeros(kcap + 1, np.float32)
    trk0[:kcap] = rng.integers(0, 40, kcap) * (rng.random(kcap) < 0.2)
    kw = dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
    if scheme == "fish":
        kw = dict(g0=3_000, epoch=1_000, pre=1, alpha=0.2,
                  ne=(3_000 + m - 1) // 1_000 - 3 + 1)
    log2k, log2p = ff._tracker_tables(m, kcap + 1)
    assert ff._tracker_plan(torch.device("cuda"), log2k, log2p)[1] == (
        tables == "global")
    carry0 = np.asarray([trk0.sum(dtype=np.float32), trk0.max()],
                        np.float32)
    card = _tracker_run("cuda", trk0, carry0, keys, m, kw)
    plain = _tracker_run("cpu", trk0, carry0, keys, m, kw)
    for name, c, p in zip(("trk", "carry", "fv", "tot", "top"), card,
                          plain):
        assert torch.equal(c, p), (m, kcap, scheme, name)


@pytest.mark.cuda
def test_cuda_tracker_segment_carries_across_segments():
    """Six FISH segments in a row, the state carried on the card and on
    the CPU: equal after each, and the carried max trk's max."""
    _card()
    kcap, seg, epoch = 5_000, 4_000, 1_500
    keys = zipf_time_evolving(6 * seg, num_keys=kcap, z=1.1, flip_at=0.5,
                              flip_head=900, seed=43).astype(np.int32)
    state = {w: (torch.zeros(kcap + 1, device=w),
                 torch.zeros(2, device=w)) for w in ("cuda", "cpu")}
    for g0 in range(0, 6 * seg, seg):
        kw = dict(g0=g0, epoch=epoch, alpha=0.2,
                  pre=1 if (g0 and g0 % epoch == 0) else 0,
                  ne=(g0 + seg - 1) // epoch - g0 // epoch + 1)
        outs = {}
        for w, (trk, carry) in state.items():
            outs[w] = ff.tracker_update(trk, carry,
                                        T(keys[g0:g0 + seg]).to(w), seg,
                                        **kw)
        for c, p in zip(outs["cuda"] + state["cuda"],
                        outs["cpu"] + state["cpu"]):
            assert torch.equal(c.cpu(), p)
        assert state["cuda"][1][1] == state["cuda"][0].max()


def _pane_run(where, segs, caps, resets=(0,), w1=9, kcap=1_024):
    """Segments into a pane table on ``where``: ``segs`` is a list of
    (keys, workers, vals) numpy triples, ``caps`` the table's slots before
    each (a larger one grows the table, its slots re-inserted), ``resets``
    the segments that start a pane.  Returns the canonical pane,
    pane_last, repl and the pane_update launches made."""
    d = torch.device(where)
    up = (lambda a: T(np.ascontiguousarray(a)).to(d))
    pane_keys = torch.empty(caps[0], dtype=torch.int64, device=d)
    pane_vc = torch.empty((2, caps[0]), dtype=torch.int32, device=d)
    last = torch.empty((w1,), dtype=torch.int32, device=d)
    repl = torch.zeros((kcap + 1, w1), dtype=torch.bool, device=d)
    before = ff.LAUNCHES["pane_update"]
    base = 0
    for j, ((k, w, v), cap) in enumerate(zip(segs, caps)):
        if cap > pane_keys.shape[0]:
            pane_keys, pane_vc = ff.pane_grow(pane_keys, pane_vc, cap)
        ff.pane_update(up(k), up(w), k.shape[0], repl=repl, vals=up(v),
                       seg_base=base, pane_keys=pane_keys, pane_vc=pane_vc,
                       pane_last=last, reset=j in resets)
        base += k.shape[0]
    pairs, vc = ff.pane_canonical(pane_keys, pane_vc)
    return [pairs, vc, last, repl], ff.LAUNCHES["pane_update"] - before


def _pane_seg(rng, m, kcap=1_024, workers=8, hot=0.0):
    keys = rng.integers(0, kcap, m).astype(np.int32)
    wk = rng.integers(0, workers, m).astype(np.int32)
    if hot:  # one (key, worker) pair takes this share of the tuples
        sel = rng.random(m) < hot
        keys[sel], wk[sel] = 5, 3
    return keys, wk, rng.integers(-5, 10, m).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot_pair", "growth", "reset_after_growth"])
def test_cuda_pane_update_matches_plain(case):
    """pane_update's compact table on the card against its plain version,
    in canonical form: one pair hit by ~12,000 of a segment's 16,384
    tuples (whole warps of one pair, and CAS races on one slot); three
    segments whose table grows twice mid-pane; and a reset segment into
    a table that grew in the pane before."""
    _card()
    rng = np.random.default_rng({"hot_pair": 1, "growth": 2,
                                 "reset_after_growth": 3}[case])
    if case == "hot_pair":
        segs = [_pane_seg(rng, 16_384, hot=0.75)]
        caps = [ff.pane_capacity(16_384)]
    else:  # 8,192 -> 16,384 -> 32,768 slots
        segs = [_pane_seg(rng, 3_000, hot=0.2) for _ in range(3)]
        caps = [ff.pane_capacity(3_000 * (j + 1)) for j in range(3)]
    card, n_card = _pane_run("cuda", segs, caps)
    plain, _ = _pane_run("cpu", segs, caps)
    for c, p in zip(card, plain):
        assert torch.equal(c.cpu(), p), case
    assert n_card == len(segs) + (2 if case != "hot_pair" else 0)
    if case == "reset_after_growth":
        # a new pane in the grown table: the reset clears every slot, so
        # it holds what the segment alone gives
        seg = [_pane_seg(rng, 3_000)]
        card2, _ = _pane_run("cuda", segs + seg, caps + caps[-1:], (0, 3))
        plain2, _ = _pane_run("cpu", segs + seg, caps + caps[-1:], (0, 3))
        fresh, _ = _pane_run("cpu", seg, caps[-1:])
        for c, p in zip(card2, plain2):
            assert torch.equal(c.cpu(), p), case
        for c, f in zip(card2[:2], fresh[:2]):
            assert torch.equal(c.cpu(), f), case


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reset", "steady", "from_entries"])
def test_cuda_pane_update_refuses_an_overfull_table(case):
    """A caller past the table's half load gets ValueError, never a hung
    probe: a reset call of more tuples than C / 2 is refused before the
    launch; a steady call that brings more new pairs than the table has
    free slots drops them and the full table is refused by its reader;
    entries past C / 2 are refused by pane_from_entries.  The card stays
    usable after."""
    _card()
    with pytest.raises(ValueError, match="past half load"):
        torch_helpers.overfull_pane(case, "cuda")
    torch.cuda.synchronize()
    assert int(torch.ones(4, device="cuda").sum()) == 4


def _ring_case(seed, workers, vnodes, n_pad, m, hits):
    rng = np.random.default_rng(seed)
    ring = ConsistentHashRing(range(workers), virtual_nodes=vnodes)
    pts, cands = ff._build_ring_table(ring, max(workers, 2))
    h = rng.integers(0, 2 ** 32, n_pad, dtype=np.uint64).astype(np.uint32)
    if hits:  # hashes at ring points, at 0, at the last point and above
        sel = rng.integers(0, pts.shape[0], m // 4)
        h[:m // 4] = pts[sel]
        h[m // 4:m // 4 + 4] = [0, pts[-1], pts[-1] + 1, 2 ** 32 - 1]
        h[m // 4 + 4:m // 2] = pts[0] - 1
    return pts, cands, h


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 8, 16, 31, 32, 128, "dmax"])
@pytest.mark.parametrize("per_key", [True, False])
@pytest.mark.parametrize("ring", ["paper", "odd"])
def test_cuda_ring_rows_match_plain(width, per_key, ring):
    """ring_rows against ring_rows_plain: widths of FG (1), PKG (2), odd
    and warp-edge widths, 8 and 16 (DC/WC/FISH edges of few workers), 128
    (FISH/DC/WC at 128 workers) and the full candidate row; 128 workers x
    64 points (R = 8,192) and 37 x 7 (R = 259, not a multiple of 32, and a
    width-37 row: no 16-byte copies); hashes at ring points, at 0, at the
    last point and above it; per-key and per-tuple hashes; m < n_pad
    (padding rows -1), n_pad not a multiple of 32 (a warp's last rows
    past the end)."""
    dev = _card()
    workers, vnodes = (128, 64) if ring == "paper" else (37, 7)
    n_pad, m = 4_101, 3_001
    pts, cands, h = _ring_case(5, workers, vnodes, n_pad, m, hits=True)
    w = cands.shape[1] if width == "dmax" else min(width, cands.shape[1])
    keys = None
    if per_key:  # tuple i hashes as h[keys[i]]
        keys = np.random.default_rng(6).integers(0, n_pad, n_pad).astype(
            np.int32)
        keys[:m // 2] = np.arange(m // 2)  # the crafted hashes stay in use
    up = (lambda a, d: None if a is None else T(np.ascontiguousarray(a)).to(d))
    before = ff.LAUNCHES["ring_rows"]
    got = ff.ring_rows(up(ff._u32_bits(pts), dev), up(cands, dev),
                       up(ff._u32_bits(h), dev), up(keys, dev), m, w, n_pad)
    want = ff.ring_rows_plain(up(ff._u32_bits(pts), "cpu"), up(cands, "cpu"),
                              up(ff._u32_bits(h), "cpu"), up(keys, "cpu"), m,
                              w, n_pad)
    assert ff.LAUNCHES["ring_rows"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert bool((want[m:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["pkg", "dc", "wc", "fish"])
def test_cuda_route_scan_ties_match_plain(scheme):
    """All-equal counts and estimator state: every argmin is a tie, broken
    to the first candidate (PKG, DC, FISH) or the lowest worker id (WC hot
    keys)."""
    _card()
    s = _segment(seed=14, m=2_000, n_pad=2_048, workers=16)
    s["counts"][:] = 0
    s["ebl"][:] = 0.0
    s["eas"][:] = 0.0
    s["ecaps"][:] = 1.0
    _assert_card_equals_plain(scheme, s)


def _route_run(scheme, s, where, segments=1, chains=None):
    """ring_rows, tracker_update and route_scan over ``segments`` segments
    in a row (segment i's tuples rolled by 97 i), the counts, the tracker,
    FISH's CHK memory and estimator carried from each to the next: every
    route, then the state route_scan updates, on the CPU."""
    m, n_pad, kcap, w1 = s["m"], s["n_pad"], s["kcap"], s["w1"]
    width = 2 if scheme == "pkg" else s["cands"].shape[1]
    d = torch.device(where)
    up = (lambda a: T(np.ascontiguousarray(a)).to(d))
    pts, cands = up(ff._u32_bits(s["pts"])), up(s["cands"])
    counts, m_k, ebl, eas = (up(s[k]) for k in ("counts", "m_k", "ebl",
                                                 "eas"))
    trk = torch.zeros(kcap + 1, dtype=torch.float32, device=d)
    carry = torch.zeros(2, dtype=torch.float32, device=d)
    routes = []
    for i in range(segments):
        keys, h = s["keys"].copy(), s["h"].copy()
        keys[:m], h[:m] = np.roll(keys[:m], 97 * i), np.roll(h[:m], 97 * i)
        rows = ff.ring_rows(pts, cands, up(ff._u32_bits(h)), None, m, width,
                            n_pad)
        kw = {}
        if scheme in ("dc", "wc", "fish"):
            g0 = 300 + i * m
            tk = (dict(g0=g0, epoch=500, pre=int(g0 % 500 == 0),
                       ne=(g0 + m - 1) // 500 - g0 // 500 + 1, alpha=0.2)
                  if scheme == "fish" else dict(ne=1))
            fv, tot, top = ff.tracker_update(trk, carry, up(keys), m, **tk)
            kw.update(fv=fv, tot=tot, top=top, g0=tk.get("g0", 0),
                      epoch=tk.get("epoch", 0), theta=0.25 / (w1 - 1),
                      wnum=float(w1 - 1), act_mask=up(s["act_mask"]))
        if scheme == "fish":
            kw.update(m_k=m_k, d_min=2, ebl=ebl, eas=eas,
                      ecaps=up(s["ecaps"]), do_tick=int(i % 3 == 0),
                      elapsed=0.3)
        workers = ff.route_scan(scheme, m, keys=up(keys), counts=counts,
                                rows=rows, chains=chains, **kw)
        routes.append(workers[:m])
    return [x.cpu() for x in (torch.cat(routes), counts, m_k, ebl, eas)]


#: route_scan's register chain against the plain version: (segment,
#: segments in a row, the chain the card takes)
_CHAIN_CASES = {
    # the main path's: 128 workers (w1 = 129), width 128
    "main_path": (dict(seed=12, m=16_384, n_pad=16_384, kcap=100_000,
                       workers=128, z=1.2), 1, "reg"),
    "w1_not_32k": (dict(seed=15, m=3_000, n_pad=4_096, workers=45), 1,
                   "reg"),
    "one_worker": (dict(seed=16, m=3_000, n_pad=4_096, workers=1), 1, "reg"),
    # both sides of the 256-worker split
    "w256": (dict(seed=17, m=4_000, n_pad=4_096, workers=256), 1, "reg"),
    "w257": (dict(seed=18, m=4_000, n_pad=4_096, workers=257), 1, "smem"),
    # the zf512 cell's edge: 512 workers, 16k segments of the ZF mix, rows
    # 512 wide (PKG's 2), two segments in a row on the walk
    "w512": (dict(seed=22, m=16_384, n_pad=16_384, kcap=100_000,
                  workers=512, z=1.2), 2, "smem"),
    # 96 of 128 workers live and on the ring: every row ends in -1
    "rows_padded": (dict(seed=19, m=3_000, n_pad=4_096, workers=128,
                         on_ring=[w for w in range(128) if w % 4 != 1],
                         live=[w for w in range(128) if w % 4 != 1]), 1,
                    "reg"),
    # dead lanes (WC's hot keys skip them) still on the ring
    "dead_lanes": (dict(seed=20, m=3_000, n_pad=4_096, workers=128,
                        live=[w for w in range(128) if w % 5]), 1, "reg"),
    "ties": (dict(seed=14, m=2_000, n_pad=2_048, workers=128), 1, "reg"),
    "ten_segments": (dict(seed=21, m=2_100, n_pad=4_096, workers=128), 10,
                     "reg"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["pkg", "dc", "wc", "fish"])
@pytest.mark.parametrize("case", list(_CHAIN_CASES))
def test_cuda_route_scan_chains_match_plain(case, scheme):
    """route_scan's chains bit for bit against the plain version (routes,
    counts, CHK memory, estimator): the register chain on every edge of 1
    to 256 workers, the shared-memory walk past them, each counted by its
    ``chains`` counter once a segment."""
    _card()
    from repro_torch.obs.metrics import Counter

    kw, segments, chain = _CHAIN_CASES[case]
    s = _segment(**kw)
    if case == "ties":  # every argmin a tie: the lower position wins
        s["counts"][:] = 0
        s["ebl"][:] = 0.0
        s["eas"][:] = 0.0
        s["ecaps"][:] = 1.0
    chains = {"reg": Counter("reg"), "smem": Counter("smem")}
    card = _route_run(scheme, s, "cuda", segments, chains)
    plain = _route_run(scheme, s, "cpu", segments)
    for c, p in zip(card, plain):
        assert torch.equal(c, p), (case, scheme)
    assert {k: c.value for k, c in chains.items()} == {
        "reg": segments * (chain == "reg"),
        "smem": segments * (chain == "smem")}


@pytest.mark.cuda
def test_cuda_zf512_cell_is_correct_on_the_card():
    """A 1-second run of the benchmark's 512-worker cell: one whole cycle
    of the stream on the walk, its sampled feeds held against the plain
    reference."""
    _card()
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "streambench" / "run.py"), "--workload",
         "zf512.fish.closed", "--seed", str(2 ** 31 + 512), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["checks"]["route_mismatch"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 256])
def test_cuda_store_probe_grouped_matches_plain(g):
    """G pairs in one launch, some with empty chunks or empty tables,
    adding into preset columns: bit for bit the plain version per pair."""
    dev = _card()
    rng = np.random.default_rng(g)
    tables, keys, vals, cnts, offsets = [], [], [], [], [0]
    for j in range(g):
        k = int(rng.integers(0, 300)) if j % 7 else 0
        n = int(rng.integers(0, 500)) if j % 5 else 0
        if g == 1:
            k, n = 300, 5_000
        tables.append(np.sort(rng.choice(4 * k + 10, size=k,
                                         replace=False)).astype(np.int32))
        keys.append(rng.integers(0, 4 * k + 10, n).astype(np.int32))
        vals.append(rng.integers(-50, 50, n).astype(np.int32))
        cnts.append(rng.integers(1, 9, n).astype(np.int32))
        offsets.append(offsets[-1] + n)
    outs = []
    for d in (dev, torch.device("cpu")):
        up = (lambda a: T(np.concatenate(a) if isinstance(a, list)
                          else a).to(d))
        vout = [torch.full((t.shape[0],), 3, dtype=torch.int32, device=d)
                for t in tables]
        cout = [torch.full((t.shape[0],), 4, dtype=torch.int32, device=d)
                for t in tables]
        sp.store_probe_grouped([up(t) for t in tables], up(keys), up(vals),
                               up(cnts), offsets, vout, cout)
        outs.append(vout + cout)
    for c, p in zip(*outs):
        assert torch.equal(c.cpu(), p)


@pytest.mark.cuda
def test_cuda_slab_pane_syncs_match_the_cpu():
    """A 128-worker fused FISH edge into a device window store, on the
    card and on the CPU's plain versions: the same partials, partial for
    partial.  On the card each pane sync puts every store on one slab
    and launches ``store_probe`` once, and each window flush reads its
    pane back in one copy."""
    from repro_torch.core.stream import simulate_edge
    from repro_torch.obs import Tracer
    from repro_torch.state import KeyedStateManager, WindowOp
    from repro_torch.topology.configs import config_for

    _card()
    n, feed, window = 32_768, 4_096, 8_192
    keys = zipf_time_evolving(n, num_keys=20_000, z=1.2, seed=33)
    values = np.random.default_rng(34).integers(1, 10, n).astype(float)
    ts = np.arange(n, dtype=np.float64) / 2e4
    out = {}
    for device in ("cuda", "cpu"):
        tracer = Tracer()
        mgr = KeyedStateManager(WindowOp(agg="sum", value="payload",
                                         size=window, backend="device"),
                                device=device, tracer=tracer)
        g, st = config_for("fish").build(128), None
        launches = sp.LAUNCHES["store_probe"]
        for lo in range(0, n, feed):
            st = simulate_edge(g, keys[lo:lo + feed],
                               times=ts[lo:lo + feed], mode="fused",
                               state=st, arrival_rate=2e4, state_sink=mgr,
                               values=values[lo:lo + feed],
                               device=device).state
        st.device.flush_pane(mgr)
        mgr.finalize()
        out[device] = (mgr.partials, sp.LAUNCHES["store_probe"] - launches,
                       tracer.spans)
    (card, launched, spans), (host, host_launched, _) = (out["cuda"],
                                                        out["cpu"])
    assert len(card) == len(host) > 4 * 128 // 2
    for a, b in zip(card, host):
        assert (a.window, a.worker, a.last_index) == \
            (b.window, b.worker, b.last_index)
        for x, y in ((a.keys, b.keys), (a.values, b.values),
                     (a.counts, b.counts)):
            np.testing.assert_array_equal(x, y)
    merges = [s.args for s in spans if s.name == "state.merge_many"]
    assert launched == len(merges) == n // window and host_launched == 0
    assert all(m["slab"] == m["stores"] > 0 for m in merges)
    flushes = [s.args for s in spans if s.name == "state.flush_windows"]
    assert len(flushes) == n // window - 1
    assert all(f["readbacks"] == 1 for f in flushes)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sg", "fg", "pkg", "dc", "wc", "fish"])
def test_cuda_fused_engine_matches_plain_engine(scheme):
    """Whole sessions — several feeds, a scale-out, a straggler and a
    scale-in, device window store — on the card and on the CPU's plain
    versions: since every kernel matches its plain version exactly, the
    reports must be identical."""
    import repro_torch.core as C
    import repro_torch.topology as TP

    _card()
    keys = zipf_time_evolving(6_000, num_keys=700, z=1.3, seed=3)
    values = np.random.default_rng(4).integers(1, 10, 6_000).astype(float)
    events = [TP.ScopedEvent("agg", C.MembershipEvent(
                  at=2_100, workers=tuple(range(10)))),
              TP.ScopedEvent("agg", C.CapacityEvent(at=3_300,
                                                    capacities={0: 4e-3})),
              TP.ScopedEvent("agg", C.MembershipEvent(
                  at=4_700, workers=tuple(range(1, 10))))]
    reports = []
    for device in ("cuda", "cpu"):
        op = TP.WindowOp(agg="sum", value="payload", size=1_024,
                         backend="device")
        topo = TP.Topology(name=scheme,
                           stages=(TP.Stage("agg", 8, operator=op),),
                           edges=(TP.Edge("source", "agg",
                                          TP.config_for(scheme)),))
        sess = TP.SimulatorEngine(mode="fused", device=device).open(
            topo, arrival_rate=2e4)
        sess.advance(events)
        ts = np.arange(6_000) / 2e4
        for lo in range(0, 6_000, 1_500):
            sess.feed(TP.RecordBatch(keys[lo:lo + 1_500], ts[lo:lo + 1_500],
                                     values[lo:lo + 1_500]))
        reports.append(sess.close().to_dict())
    assert reports[0] == reports[1]


def _fish_table(k, seed):
    rng = np.random.default_rng(seed)
    table = np.full(k, -1, np.int32)
    real = k * 3 // 4
    table[:real] = rng.choice(4 * k + 10, real, replace=False)
    counts = np.zeros(k, np.float32)
    counts[:real] = rng.gamma(2.0, 3.0, real).astype(np.float32)
    return table, counts


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1_000, 1_000), (1, 7), (4_096, 100_000),
                                 (0, 5), (300, 0)])
def test_cuda_fish_count_matches_plain(k, n):
    dev = _card()
    table, _ = _fish_table(k, k + n)
    keys = np.random.default_rng(n).integers(0, 4 * k + 10, n).astype(
        np.int32)
    got = fc.fish_count(T(table).to(dev), T(keys).to(dev))
    want = fc.fish_count_plain(T(table), T(keys))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,alpha", [(1_000, 1_000, 0.2), (128, 1_500, 0.5),
                                       (50, 3_000, 0.2)])
def test_cuda_fish_epoch_count_matches_plain(k, n, alpha):
    """Bit for bit, the decayed counts included: fl(fl(c·alpha) + delta)."""
    dev = _card()
    table, counts = _fish_table(k, k)
    keys = zipf_time_evolving(n, num_keys=4 * k + 10, z=1.2, seed=n)
    keys[: n // 4] = np.resize(table[: k * 3 // 4], n // 4)
    got = fc.fish_epoch_count(T(table).to(dev), T(counts).to(dev),
                              T(keys).to(dev), alpha=alpha)
    want = fc.fish_epoch_count_plain(T(table), T(counts), T(keys),
                                     alpha=alpha)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["match_fn", "fused_fn"])
def test_cuda_epoch_update_matches_plain(path):
    """16 epochs of a ZF stream through the table on the card and on the
    CPU's plain versions: identical tables, identical CHK."""
    dev = _card()
    keys = zipf_time_evolving(16_000, num_keys=2_000, z=1.4, seed=7)
    fn = {"match_fn": ops.fish_count, "fused_fn": ops.fish_epoch_count}[path]
    before = dict(fc.LAUNCHES)
    states = []
    for d in (dev, torch.device("cpu")):
        st = F.init_fish_state(256, device=d)
        for i in range(0, 16_000, 1_000):
            st = F.epoch_update(st, T(keys[i:i + 1_000]).to(d), alpha=0.2,
                                **{path: fn})
        states.append(st)
    assert torch.equal(states[0]["keys"].cpu(), states[1]["keys"])
    assert torch.equal(states[0]["counts"].cpu(), states[1]["counts"])
    chk = [F.classify_hot_keys(st, num_workers=64, theta=0.25 / 64)
           for st in states]
    for g, w in zip(*chk):
        assert torch.equal(g.cpu(), w)
    assert fc.LAUNCHES[fn.__name__] == before[fn.__name__] + 16


def _epoch_case(k, n, seed):
    """A table with a quarter of its slots empty and an epoch whose first
    quarter repeats table keys: matches, repeats and new keys."""
    table, counts = _fish_table(k, seed)
    keys = zipf_time_evolving(n, num_keys=4 * k + 10, z=1.2, seed=seed)
    keys[: n // 4] = np.resize(table[: k * 3 // 4], n // 4)
    return table, counts, keys.astype(np.int32)


def _assert_epoch_update_equals_plain(table, counts, keys, ties, max_new):
    dev = _card()
    before = fc.LAUNCHES["fish_epoch_update"]
    got = fc.fish_epoch_update(T(table).to(dev), T(counts).to(dev),
                               T(keys).to(dev), alpha=0.2, max_new=max_new,
                               ties=ties)
    torch.cuda.synchronize()
    want = fc.fish_epoch_update_plain(T(table), T(counts), T(keys),
                                      alpha=0.2, max_new=max_new, ties=ties)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert fc.LAUNCHES["fish_epoch_update"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ties", ["first", "key"])
@pytest.mark.parametrize("k,n", [(1_000, 1_000), (256, 1_000), (1, 7),
                                 (4_480, 8_192), (300, 0)])
def test_cuda_fish_epoch_update_matches_plain(k, n, ties):
    """The whole epoch in one launch, bit for bit, at the paper's size, a
    table smaller than the epoch, one slot, the size limit (exactly the
    232,448 B of shared memory a block may use) and an empty epoch (decay
    only)."""
    table, counts, keys = _epoch_case(k, n, seed=k + n)
    _assert_epoch_update_equals_plain(table, counts, keys, ties,
                                      max_new=64)


@pytest.mark.cuda
@pytest.mark.parametrize("ties,want", [("first", 30), ("key", 20)])
def test_cuda_fish_epoch_update_tie_rules(ties, want):
    """Unmatched 30 and 20 twice each, 30 first, 20 the lower key."""
    table = np.array([5, -1, 7, 9], np.int32)
    counts = np.array([3.0, 0.0, 0.5, 2.0], np.float32)
    keys = np.array([30, 20, 20, 30, 10, 5, 5, 7], np.int32)
    _assert_epoch_update_equals_plain(table, counts, keys, ties, max_new=1)
    got = fc.fish_epoch_update(T(table).cuda(), T(counts).cuda(),
                               T(keys).cuda(), alpha=0.2, max_new=1,
                               ties=ties)[0].cpu().tolist()
    assert want in got and 50 - want not in got


@pytest.mark.cuda
@pytest.mark.parametrize("ties", ["first", "key"])
def test_cuda_epoch_update_epoch_fn_matches_plain(ties):
    """16 epochs of a ZF stream through ``epoch_update(epoch_fn=)`` on the
    card and on the CPU: identical tables, one launch an epoch."""
    dev = _card()
    keys = zipf_time_evolving(16_000, num_keys=2_000, z=1.4, seed=7)
    fn = functools.partial(ops.fish_epoch_update, ties=ties)
    before = fc.LAUNCHES["fish_epoch_update"]
    states = []
    for d in (dev, torch.device("cpu")):
        st = F.init_fish_state(256, device=d)
        for i in range(0, 16_000, 1_000):
            st = F.epoch_update(st, T(keys[i:i + 1_000]).to(d), alpha=0.2,
                                epoch_fn=fn)
        states.append(st)
    assert torch.equal(states[0]["keys"].cpu(), states[1]["keys"])
    assert torch.equal(states[0]["counts"].cpu(), states[1]["counts"])
    assert fc.LAUNCHES["fish_epoch_update"] == before + 16


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(4_481, 8_192), (1_000, 8_193)])
def test_cuda_fish_epoch_update_refuses_past_the_limit(k, n):
    dev = _card()
    before = fc.LAUNCHES["fish_epoch_update"]
    with pytest.raises(ValueError, match="one-block limit"):
        fc.fish_epoch_update(torch.full((k,), -1, dtype=torch.int32,
                                        device=dev),
                             torch.zeros(k, device=dev),
                             torch.zeros(n, dtype=torch.int32, device=dev),
                             alpha=0.2, max_new=64)
    assert fc.LAUNCHES["fish_epoch_update"] == before


def _ssd_close(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bc,q,h,p,g,n", [
    (2, 128, 48, 64, 1, 128),   # mamba2-780m's chunk
    (3, 32, 4, 16, 2, 16),
    (2, 48, 4, 32, 1, 32),      # a chunk that is not a multiple of 32 rows
    (1, 16, 4, 16, 1, 16),      # the reduced config's chunk
])
def test_cuda_ssd_chunk_kernels_match_plain(bc, q, h, p, g, n):
    dev = _card()
    rng = np.random.default_rng(q + h)
    up = (lambda a: T(a.astype(np.float32)).to(dev))
    x = up(rng.normal(size=(bc, q, h, p)))
    b = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    c = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    a_cum = up(np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.5,
                         axis=1))
    prev = up(rng.normal(size=(bc, h, n, p)))
    st, at = ssd.ssd_chunk_state(x, b, a_cum)
    st_p, at_p = ssd.ssd_chunk_state_plain(x, b, a_cum)
    _ssd_close(st, st_p)
    assert torch.equal(at, at_p)
    _ssd_close(ssd.ssd_chunk_output(x, b, c, a_cum, prev),
               ssd.ssd_chunk_output_plain(x, b, c, a_cum, prev))


def _ssd_inputs(bc, q, h, p, g, n, step, dev):
    """x, b, c, a_cum, prev on the card; a_cum falls by ``step`` x |N(0,1)|
    a row (0.8 step on average)."""
    rng = np.random.default_rng(q + h + g)
    up = (lambda a: T(a.astype(np.float32)).to(dev))
    x = up(rng.normal(size=(bc, q, h, p)))
    b = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    c = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    a_cum = up(np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * step,
                         axis=1))
    prev = up(rng.normal(size=(bc, h, n, p)))
    return x, b, c, a_cum, prev


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case,bc,q,h,p,g,n,step", [
    # ~20 a step: exp(a_i - a_j) above the diagonal would overflow to inf,
    # and inf * 0 is NaN; below it most weights underflow to 0
    ("steep_decay", 2, 128, 8, 64, 1, 128, 25.0),
    ("ragged_q100", 2, 100, 4, 32, 1, 32, 0.5),   # 64-row blocks, 32-row tiles
    ("two_groups", 2, 128, 8, 64, 2, 128, 0.5),   # G = 2 at the full chunk
    ("unaligned_views", 2, 32, 4, 16, 1, 16, 0.5),
    ("chunk_256", 1, 256, 4, 64, 1, 128, 0.5),    # the largest chunk taken
    ("ragged_q200", 1, 200, 4, 64, 1, 128, 0.5),  # four 64-row blocks
    ("p24_n48_g3", 2, 72, 6, 24, 3, 48, 0.5),     # odd tile counts, G = 3
])
def test_cuda_ssd_chunk_kernels_edge_cases_match_plain(case, bc, q, h, p, g,
                                                       n, step):
    """The SSD kernels beyond the main path's inputs, against their plain
    versions: finite where the plain version is, within 3e-4."""
    dev = _card()
    x, b, c, a_cum, prev = _ssd_inputs(bc, q, h, p, g, n, step, dev)
    want_st, want_at = ssd.ssd_chunk_state_plain(x, b, a_cum)
    want_y = ssd.ssd_chunk_output_plain(x, b, c, a_cum, prev)
    if case == "unaligned_views":  # the wrapper copies them to alignment
        x, b, c, prev = map(_unaligned, (x, b, c, prev))
    st, at = ssd.ssd_chunk_state(x, b, a_cum)
    y = ssd.ssd_chunk_output(x, b, c, a_cum, prev)
    for got, want in ((st, want_st), (y, want_y)):
        assert bool(torch.isfinite(want).all())
        assert bool(torch.isfinite(got).all())
        _ssd_close(got, want)
    assert torch.equal(at, want_at)


@pytest.mark.cuda
def test_cuda_ssd_kernels_refuse_shapes_they_do_not_take():
    """A CUDA shape outside the kernels' limits raises before any launch;
    nothing falls back to the plain version."""
    dev = _card()
    x, b, c, a_cum, prev = _ssd_inputs(1, 16, 4, 16, 1, 16, 0.5, dev)
    before = dict(ssd.LAUNCHES)
    with pytest.raises(ValueError, match="kernel takes"):
        ssd.ssd_chunk_state(x[..., :12].contiguous(), b, a_cum)
    with pytest.raises(ValueError, match="kernel takes"):
        ssd.ssd_chunk_output(x, b[..., :8].contiguous(),
                             c[..., :8].contiguous(), a_cum,
                             prev[:, :, :8].contiguous())
    assert ssd.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_mamba_prefill_and_decode_match_plain():
    """The reduced mamba2-780m in float32 on the card (SSD kernels) and on
    the CPU (their plain versions), same weights: prefill of a ragged
    length (padded to the chunk) and four decode steps."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer as MT

    dev = _card()
    cfg = dataclasses.replace(reduced_config(get_config("mamba2-780m")),
                              dtype="float32")
    cpu = MT.init_params(cfg, seed=1, device="cpu")
    card = MT.Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = T(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32))
    before = dict(ssd.LAUNCHES)
    out = []
    for params, d in ((card, dev), (cpu, torch.device("cpu"))):
        cache, logits = MT.prefill(params, {"tokens": toks[:, :41].to(d)},
                                   cfg)
        steps = [logits]
        for i in range(41, 45):
            lg, cache = MT.decode_step(params, cache, toks[:, i:i + 1].to(d),
                                       cfg)
            steps.append(lg)
        out.append(steps + [cache["layers"]["ssm"]])
    for g, w in zip(*out):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
    assert ssd.LAUNCHES["ssd_chunk_state"] == \
        before["ssd_chunk_state"] + cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sg", "fg", "pkg", "dc", "wc", "fish"])
def test_cuda_worker_growth_in_an_open_pane_matches_plain(scheme):
    """A fused edge that scales out (8 → 10 workers: the runner's worker
    lanes grow, the old phantom lane becomes a real worker) and back in
    (worker 9 and then worker 3 removed) inside one open 4,096-tuple pane,
    on the card and on the CPU's plain versions: every segment's routing
    and finish times, the merged windows and the replica sets are equal bit
    for bit (DC/WC counts stay far below 2^24)."""
    import repro_torch.core as C
    import repro_torch.topology as TP

    _card()
    n = 6_000
    keys = zipf_time_evolving(n, num_keys=900, z=1.3, seed=8)
    values = np.random.default_rng(9).integers(1, 10, n).astype(float)
    events = [TP.ScopedEvent("agg", C.MembershipEvent(
                  at=1_300, workers=tuple(range(10)))),
              TP.ScopedEvent("agg", C.MembershipEvent(
                  at=2_600, workers=tuple(range(9)))),
              TP.ScopedEvent("agg", C.MembershipEvent(
                  at=3_500, workers=(0, 1, 2, 4, 5, 6, 7, 8)))]
    real = ff.fifo_workers
    runs = {}
    for device in ("cuda", "cpu"):
        seen = []

        def spy(scheme_, m, **kw):
            workers, fin = real(scheme_, m, **kw)
            seen.append((workers[:m].cpu().clone(), fin[:m].cpu().clone()))
            return workers, fin

        ff.fifo_workers = spy
        try:
            op = TP.WindowOp(agg="sum", value="payload", size=4_096,
                             backend="device")
            topo = TP.Topology(name=scheme,
                               stages=(TP.Stage("agg", 8, operator=op),),
                               edges=(TP.Edge("source", "agg",
                                              TP.config_for(scheme)),))
            sess = TP.SimulatorEngine(mode="fused", device=device).open(
                topo, arrival_rate=2e4)
            sess.advance(events)
            ts = np.arange(n) / 2e4
            w1 = []
            for lo in range(0, n, 1_000):
                sess.feed(TP.RecordBatch(keys[lo:lo + 1_000],
                                         ts[lo:lo + 1_000],
                                         values[lo:lo + 1_000]))
                st = sess._st["source->agg"]
                w1.append(st.state.device._w1)
            grouper = sess._st["source->agg"].grouper
            replicas = {k: sorted(v) for k, v in
                        getattr(grouper, "replicas", {}).items()}
            rep = sess.close()
        finally:
            ff.fifo_workers = real
        runs[device] = (seen, rep.to_dict(), w1, replicas)
    card, plain = runs["cuda"], runs["cpu"]
    assert card[2] == plain[2] and card[2][0] == 9 and max(card[2]) == 11
    assert len(card[0]) == len(plain[0]) > n // 1_000
    for (wc_, fc_), (wp, fp) in zip(card[0], plain[0]):
        assert torch.equal(wc_, wp)
        assert torch.equal(fc_, fp)
    assert card[1] == plain[1]
    assert card[3] == plain[3]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-2b"])
def test_cuda_dense_model_matches_host(arch):
    """The dense family has no kernel of its own: its plain tensor ops on
    the card against the same ops on the host, one set of float32
    weights (reduced config), a prefill of 40 tokens (past the reduced
    gemma2's window of 32) and 4 decode steps, within 1e-3."""
    dev = _card()
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    host = PT.init_params(cfg, seed=0, device="cpu")
    runs = {}
    for where, params in (("cuda", copy.deepcopy(host).to(dev)),
                          ("cpu", host)):
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 44)).astype(np.int32)).to(where)
        cache, lg = PT.prefill(params, {"tokens": toks[:, :40]}, cfg)
        cache = PT.grow_cache(cfg, cache, 44)
        out = [lg]
        for i in range(40, 44):
            lg, cache = PT.decode_step(params, cache, toks[:, i:i + 1], cfg)
            out.append(lg)
        runs[where] = [x[:, :cfg.vocab_size].cpu() for x in out] + [
            t.cpu() for t in cache["layers"]]
    for card, plain in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(card, plain, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_cuda_moe_model_matches_host(arch, monkeypatch):
    """The MoE family (MLA or GQA, FISH expert routing) has no kernel of
    its own: its plain tensor ops on the card against the same ops on the
    host, one set of float32 weights (reduced config), a prefill of 2 x 64
    tokens (two dispatch groups) and 4 decode steps within 1e-3, and every
    MoE routing's ids, keep and pos equal on both."""
    from repro_torch.models import moe as PM

    dev = _card()
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    host = PT.init_params(cfg, seed=0, device="cpu")
    real_route, routes = PM._route, []

    def route(gates, moe, caps):
        out = real_route(gates, moe, caps)
        routes.append([out[i].cpu() for i in (0, 2, 3)])
        return out

    monkeypatch.setattr(PM, "_route", route)
    runs = {}
    for where, params in (("cuda", copy.deepcopy(host).to(dev)),
                          ("cpu", host)):
        routes.clear()
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 68)).astype(np.int32)).to(where)
        cache, lg = PT.prefill(params, {"tokens": toks[:, :64]}, cfg)
        cache = PT.grow_cache(cfg, cache, 68)
        out = [lg]
        for i in range(64, 68):
            lg, cache = PT.decode_step(params, cache, toks[:, i:i + 1], cfg)
            out.append(lg)
        runs[where] = ([x[:, :cfg.vocab_size].cpu() for x in out] +
                       [t.cpu() for t in cache["layers"]], list(routes))
    (card, card_routes), (plain, plain_routes) = runs["cuda"], runs["cpu"]
    for a, b in zip(card, plain):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    assert len(card_routes) == len(plain_routes) == 5
    for a, b in zip(card_routes, plain_routes):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("routing", ["fish", "pkg", "fg"])
def test_cuda_moe_ffn_matches_host(routing, impl):
    """``moe_ffn`` on 512 tokens (2 groups of 256), 16 experts top-4,
    capacity factor 1, from a skewed hotness: on the card against the
    host, ``new_hotness`` and the FISH capacities exact, ``y`` within
    1e-5."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as PM

    dev = _card()
    moe = MoEConfig(num_experts=16, top_k=4, d_ff_expert=32,
                    shared_experts=1, routing=routing, capacity_factor=1.0,
                    tokens_per_group=256, dispatch_impl=impl,
                    hot_headroom=2.0)
    gen = torch.Generator().manual_seed(3)
    host = PM.init_moe_params(gen, 64, moe, torch.float32, "cpu")
    card = copy.deepcopy(host).to(dev)
    x = torch.randn((512, 64), generator=gen)
    hot = (torch.arange(1, 17, dtype=torch.float32) ** -1.2 * 2048)[
        torch.randperm(16, generator=gen)]
    y_c, nh_c, aux_c, m_c = PM.moe_ffn(card, x.to(dev), moe, hot.to(dev))
    y_h, nh_h, aux_h, m_h = PM.moe_ffn(host, x, moe, hot)
    torch.testing.assert_close(y_c.cpu(), y_h, rtol=1e-5, atol=1e-5)
    assert torch.equal(nh_c.cpu(), nh_h)
    assert float(m_c["moe_drop_frac"]) == float(m_h["moe_drop_frac"])
    if routing == "fish":
        plan = PM.capacity_plan(moe, 512)
        caps = [PM.fish_capacities(h, budget=plan.budget, c_max=plan.c_max)
                for h in (hot.to(dev), hot)]
        assert torch.equal(caps[0].cpu(), caps[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_cuda_train_step_matches_host(arch, monkeypatch):
    """The training path has no kernel of its own: one ``make_train_step``
    (reduced config, float32 weights, a carried hotness; kimi-k2 with its
    bf16 factored state and 8 microbatches) on the card against the host:
    the loss within 1e-4, every routing (the remat recompute's too) and
    the new hotness equal, m and v within 1e-4 of each leaf's largest
    magnitude (a bf16 leaf: or one bf16 ulp)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as PM
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    dev = _card()
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype,
                       factored_v=cfg.opt_factored)
    host = PT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 65)).astype(
        np.int32))
    hot = torch.from_numpy((rng.random(
        (cfg.num_layers - cfg.moe.first_dense_layers,
         cfg.moe.num_experts)) * 50).astype(np.float32))
    real_route, routes = PM._route, []

    def route(gates, moe, caps):
        out = real_route(gates, moe, caps)
        routes.append([out[i].cpu() for i in (0, 2)])
        return out

    monkeypatch.setattr(PM, "_route", route)
    step = make_train_step(cfg, ocfg)
    runs = []
    for where, params in ((dev, copy.deepcopy(host).to(dev)), ("cpu", host)):
        routes.clear()
        batch = {"tokens": toks[:, :-1].to(where),
                 "labels": toks[:, 1:].to(where)}
        _, state, new_hot, m = step(params, init_opt_state(params, ocfg),
                                    hot.to(where), batch)
        runs.append((float(m["loss"]), new_hot.cpu(), state, list(routes)))
    (loss, new_hot, state, card_routes), (want_loss, want_hot, want, rts) = \
        runs
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    assert torch.equal(new_hot, want_hot)
    assert len(card_routes) == len(rts) > 0
    for a, b in zip(card_routes, rts):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for path, w in want.m.items():
        got = state.m[path].float().cpu()
        slack = 2.0 ** -7 * w.float().abs() if w.dtype == torch.bfloat16 \
            else 0.0
        assert bool(((got - w.float()).abs() <= 1e-4 * w.float().abs().max()
                     + slack).all()), path
        v, wv = state.v[path], want.v[path]
        for a, b in ((v["r"], wv["r"]), (v["c"], wv["c"])) if isinstance(
                wv, dict) else ((v, wv),):
            b = b.float()
            assert bool(((a.float().cpu() - b).abs() <= 1e-4 * b.abs().max()
                         ).all()), path


@pytest.mark.cuda
def test_cuda_griffin_model_matches_host():
    """The Griffin family (RG-LRU + local MQA) has no kernel of its own:
    its plain tensor ops on the card against the same ops on the host, one
    set of float32 weights (reduced config, 5 layers: one (rec, rec, attn)
    group and a tail of 2; window 8).  A prefill of 2 x 11 (not a multiple
    of the window: the ring's quirk is on) and 8 decode steps, logits
    within 1e-4 and the caches within 1e-5; one ``forward_train`` at 2 x
    32, the loss within 1e-5 and every gradient within 1e-4 of its
    parameter's largest gradient (``tests/test_torch_griffin.py``'s
    bounds)."""
    dev = _card()
    base = reduced_config(get_config("recurrentgemma-9b"))
    cfg = dataclasses.replace(base, num_layers=5, dtype="float32",
                              rglru=dataclasses.replace(base.rglru,
                                                        local_window=8))
    host = PT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 19)).astype(
        np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(
        np.int32))
    runs = []
    for where, params in ((dev, copy.deepcopy(host).to(dev)), ("cpu", host)):
        t = toks.to(where)
        cache, lg = PT.prefill(params, {"tokens": t[:, :11]}, cfg)
        out = [lg]
        for i in range(11, 19):
            lg, cache = PT.decode_step(params, cache, t[:, i:i + 1], cfg)
            out.append(lg)
        leaves = [cache["rec"]["conv"], cache["rec"]["h"], *cache["attn"],
                  *[st[k] for st in cache["tail"] for k in ("conv", "h")]]
        params.requires_grad_(True)
        batch = {"tokens": labels.roll(1, 1).to(where),
                 "labels": labels.to(where)}
        loss, _ = PT.forward_train(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        runs.append(([x[:, :cfg.vocab_size].cpu() for x in out],
                     [x.cpu() for x in leaves], float(loss.detach()),
                     [g.cpu() for g in grads]))
    (logits, leaves, loss, grads), (w_logits, w_leaves, w_loss, w_grads) = \
        runs
    for a, b in zip(logits, w_logits):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(leaves, w_leaves, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert abs(loss - w_loss) <= 1e-5 * abs(w_loss)
    for (name, _), a, b in zip(host.named_parameters(), grads, w_grads):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-30), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch,sections", [("whisper-large-v3", None),
                                           ("qwen2-vl-2b", None),
                                           ("qwen2-vl-2b", (4, 6, 6))])
def test_cuda_frontends_match_host(arch, sections):
    """The frontend stubs have no kernel of their own: whisper (encoder,
    cross attention) and qwen2-vl (embedding input, M-RoPE; with sections
    (4, 6, 6) all three streams act at the reduced head_dim 32) as plain
    tensor ops on the card against the host, one set of float32 weights
    (reduced config).  A prefill of 2 x 16, 8 decode steps (qwen2-vl by
    embedding and by token in turn), logits within 1e-4 and the caches
    within 1e-5; one ``forward_train``, the loss within 1e-5 and every
    gradient within 1e-4 of its parameter's largest gradient — a whisper
    key bias's, zero in exact arithmetic (the softmax takes a constant
    out), within 1e-4 of its query bias's (``tests/
    test_torch_frontends.py``'s bounds)."""
    dev = _card()
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    if sections is not None:
        cfg = dataclasses.replace(cfg, mrope_sections=sections)
    host = PT.init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():  # biases and norm weights off their init
        g = torch.Generator().manual_seed(1)
        for p in host.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(1)
    s, steps, d = 16, 8, cfg.d_model
    batch = {"labels": T(rng.integers(0, cfg.vocab_size, (2, s)).astype(
        np.int32))}
    if cfg.embeds_input:
        batch["embeds"] = T(rng.standard_normal((2, s, d)).astype(np.float32))
        batch["positions"] = T(torch_helpers.mrope_positions([3, 5], 2, 3,
                                                             s))
    else:
        batch["tokens"] = T(rng.integers(0, cfg.vocab_size, (2, s)).astype(
            np.int32))
    if cfg.encoder_layers:
        batch["enc_embeds"] = T(rng.standard_normal(
            (2, cfg.encoder_seq, d)).astype(np.float32))
    toks = T(rng.integers(0, cfg.vocab_size, (2, steps)).astype(np.int32))
    embs = T(rng.standard_normal((2, steps, d)).astype(np.float32))
    runs = []
    for where, params in ((dev, copy.deepcopy(host).to(dev)), ("cpu", host)):
        b = {k: x.to(where) for k, x in batch.items()}
        cache, lg = PT.prefill(params, b, cfg)
        cache = PT.grow_cache(cfg, cache, s + steps)
        out = [lg]
        for i in range(steps):
            emb = (embs[:, i:i + 1].to(where)
                   if cfg.embeds_input and i % 2 == 0 else None)
            lg, cache = PT.decode_step(params, cache,
                                       toks[:, i:i + 1].to(where), cfg,
                                       embeds=emb)
            out.append(lg)
        leaves = [x for kv in cache["layers"] for x in (
            kv if isinstance(kv, tuple) else (kv,))]
        params.requires_grad_(True)
        loss, _ = PT.forward_train(params, b, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    materialize_grads=True)
        params.requires_grad_(False)
        runs.append(([x[:, :cfg.vocab_size].cpu() for x in out],
                     [x.cpu() for x in leaves], float(loss.detach()),
                     {n: gr.cpu() for (n, _), gr in
                      zip(params.named_parameters(), grads)}))
    (logits, leaves, loss, grads), (w_logits, w_leaves, w_loss, w_grads) = \
        runs
    for a, b in zip(logits, w_logits, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(leaves, w_leaves, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert abs(loss - w_loss) <= 1e-5 * abs(w_loss)
    for name, b in w_grads.items():
        zero = cfg.rope_kind == "none" and name.endswith(".bk")
        scale = w_grads[name[:-1] + "q"] if zero else b
        bound = 1e-4 * max(float(scale.abs().max()), 1e-30)
        assert float((grads[name] - b).abs().max()) <= bound, name
