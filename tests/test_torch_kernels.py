"""The port's kernels, piece by piece, against the JAX package.

Each kernel wrapper takes its plain PyTorch version for a CPU tensor; here
those plain versions meet the reference's own pieces on the same numpy-
seeded inputs: ``store_probe`` against the Pallas kernel (interpret mode)
and ``ops._store_probe_sorted``; the fused segment's parts against
``_build_ring_table``, ``_ring_rows``, ``_tracker_update``, ``_route_pkg``,
``_route_dcwc``, ``_route_fish`` (against ``route_scan``) and
``_fifo_scan`` (against ``fifo_workers``).
Integers must match exactly.  Floats: the DC/WC trackers hold integer
counts and match exactly; FISH's tracker folds its decay per epoch
(Horner) where the reference sums decayed weights in tuple order, so it
agrees to rtol 1e-5; the FIFO runs in float64 where the reference runs in
float32, so finish times agree to the float32 rounding the reference
accumulates over a segment's sequential adds (rtol 2e-5).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chash import ConsistentHashRing as RefRing
from repro.kernels import feed_fused as rff
from repro.kernels import ops as rops
from repro.kernels.store_probe import store_probe as pallas_store_probe
from repro_torch.core.chash import ConsistentHashRing, hash32
from repro_torch.kernels import feed_fused as ff
from repro_torch.kernels.ops import store_probe

import torch_helpers  # caps torch threads; shared cases

T = torch.from_numpy


def _probe_inputs(seed, k, n, empty=0):
    rng = np.random.default_rng(seed)
    table = np.sort(rng.choice(4 * k + 10, size=k, replace=False)).astype(
        np.int32)
    if empty:
        table[:empty] = -1  # empty slots (sorted first)
    keys = rng.integers(0, 4 * k + 10, n).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    return table, keys, vals


@pytest.mark.parametrize("seed,k,n,empty", [(0, 128, 700, 0),
                                            (1, 256, 1500, 7),
                                            (2, 1, 40, 0)])
def test_store_probe_matches_pallas_and_sorted(seed, k, n, empty):
    table, keys, vals = _probe_inputs(seed, k, n, empty)
    vp, cp, mp = store_probe(T(table), T(keys), T(vals))
    vr, cr, mr = pallas_store_probe(jnp.asarray(table), jnp.asarray(keys),
                                   jnp.asarray(vals), interpret=True)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mr))
    if not empty:  # the sorted form needs a strictly ascending table
        vs, cs, ms = rops._store_probe_sorted(
            jnp.asarray(table), jnp.asarray(keys), jnp.asarray(vals))
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vs))
        np.testing.assert_array_equal(cp.numpy(), np.asarray(cs))
        np.testing.assert_array_equal(mp.numpy(), np.asarray(ms))


def test_store_probe_checks_dtypes_and_devices():
    table, keys, vals = _probe_inputs(3, 16, 32)
    with pytest.raises(TypeError, match="int32"):
        store_probe(T(table).long(), T(keys), T(vals))
    with pytest.raises(ValueError, match="shape"):
        store_probe(T(table), T(keys), T(vals[:5]))


# ---------------------------------------------------------------------------
# a small segment, built once for the reference and the port
# ---------------------------------------------------------------------------


def _ring_pair(workers, members=None):
    rp = ConsistentHashRing(range(workers), virtual_nodes=16)
    rr = RefRing(range(workers), virtual_nodes=16)
    if members is not None:
        for ring in (rp, rr):
            for w in range(workers):
                if w not in members:
                    ring.remove_worker(w)
    return rp, rr


@pytest.mark.parametrize("workers,dmax,members", [(8, 2, None), (8, 8, None),
                                                  (12, 12, (0, 3, 5, 9)),
                                                  (6, 1, None)])
def test_ring_table_matches_reference(workers, dmax, members):
    rp, rr = _ring_pair(workers, members)
    pp, cp = ff._build_ring_table(rp, dmax)
    pr, cr = rff._build_ring_table(rr, dmax)
    np.testing.assert_array_equal(pp, pr)
    np.testing.assert_array_equal(cp, cr)


class Seg:
    """Seeded inputs of one segment: m live tuples padded to n_pad, a key
    table of kcap (+1 phantom row), w1 worker lanes (+1 phantom)."""

    def __init__(self, seed=0, m=1_500, n_pad=2_048, kcap=1_024, workers=8,
                 dmax=8):
        from repro_torch.data.synthetic import zipf_time_evolving

        rng = np.random.default_rng(seed)
        self.m, self.n_pad, self.kcap = m, n_pad, kcap
        self.w1 = workers + 1
        keys = np.full(n_pad, kcap, np.int32)
        keys[:m] = zipf_time_evolving(m, num_keys=kcap, z=1.4, seed=seed)
        self.keys = keys
        rp, rr = _ring_pair(workers)
        self.pts, self.cands = ff._build_ring_table(rp, dmax)
        hash_arr = np.asarray([hash32(k) for k in range(kcap)],
                              dtype=np.uint32)
        self.hash_arr = hash_arr
        self.h = np.zeros(n_pad, np.uint32)
        self.h[:m] = hash_arr[keys[:m]]
        self.valid = np.arange(n_pad) < m
        self.counts = rng.integers(0, 5, self.w1).astype(np.int32)
        self.t = np.sort(rng.random(n_pad) * 0.1).astype(np.float32)
        self.busy = (rng.random(self.w1) * 0.05).astype(np.float32)
        self.caps = np.full(self.w1, 1e-3, np.float32)
        self.caps[:workers] = rng.uniform(5e-4, 2e-3, workers)
        self.act_mask = np.ones(self.w1, bool)
        self.act_mask[-1] = False
        self.ebl = (rng.random(self.w1) * 3).astype(np.float32)
        self.eas = rng.integers(0, 4, self.w1).astype(np.float32)
        self.ecaps = rng.uniform(0.5, 1.5, self.w1).astype(np.float32)
        self.m_k = np.zeros(kcap + 1, np.int32)
        self.m_k[:20] = rng.integers(0, 6, 20)

    def rows(self, width=None, per_key=True):
        width = width or self.cands.shape[1]
        return ff.ring_rows(
            T(ff._u32_bits(self.pts)), T(self.cands),
            T(ff._u32_bits(self.hash_arr if per_key else self.h)),
            T(self.keys) if per_key else None, self.m, width, self.n_pad)

    def ref_a(self, **extra):
        a = {"pts": jnp.asarray(self.pts), "cands": jnp.asarray(self.cands),
             "keys": jnp.asarray(self.keys), "valid": jnp.asarray(self.valid),
             "counts": jnp.asarray(self.counts),
             "phantom_w": jnp.int32(self.w1 - 1)}
        a.update(extra)
        return a


@pytest.mark.parametrize("per_key", [True, False])
@pytest.mark.parametrize("width", [1, 2, None])
def test_ring_rows_matches_reference(per_key, width):
    s = Seg(seed=1)
    a = s.ref_a()
    if per_key:
        a["hash_arr"] = jnp.asarray(s.hash_arr)
    else:
        a["h"] = jnp.asarray(s.h)
    want = np.asarray(rff._ring_rows(a, width))[:s.m]
    got = s.rows(width, per_key).numpy()
    np.testing.assert_array_equal(got[:s.m], want)
    assert (got[s.m:] == -1).all()  # padding lanes masked, never gathered


def _carry(trk):
    """The tracker's carried (total, max), as a fresh runner or convert.py
    sets them: a float32 sum and the max."""
    return T(np.asarray([trk.sum(dtype=np.float32), trk.max(initial=0.0)],
                        np.float32))


def _fish_kw(g0, m, epoch, alpha=0.2):
    pre = 1 if (g0 > 0 and g0 % epoch == 0) else 0
    return dict(g0=g0, epoch=epoch, pre=pre,
                ne=(g0 + m - 1) // epoch - g0 // epoch + 1, alpha=alpha)


def _ref_tracker(s, trk, kw, hi):
    """The reference's ``_tracker_update`` over tuples [0, hi) of the
    segment (``valid`` cut there): the tracker at the end of tuple hi-1's
    epoch when hi is an epoch's end."""
    extra = {}
    valid = np.arange(s.n_pad) < hi
    if kw["epoch"]:
        g0, ep = kw["g0"], kw["epoch"]
        c_total = (g0 + hi - 1) // ep - g0 // ep + kw["pre"]
        extra = {"g0": jnp.int32(g0), "epoch": jnp.int32(ep),
                 "pre_decay": jnp.int32(kw["pre"]),
                 "c_total": jnp.float32(c_total),
                 "alpha": jnp.float32(kw["alpha"])}
    a = s.ref_a(trk=jnp.asarray(trk), valid=jnp.asarray(valid), **extra)
    trk_r, f_r, ftop_r = rff._tracker_update(a, "fish" if kw["epoch"]
                                             else "dc")
    return np.asarray(trk_r), np.asarray(f_r), float(ftop_r)


def _dense_tracker(trk0, keys, m, g0, epoch, pre, ne, alpha):
    """A dense float32 tracker stepped ordinal by ordinal, op by op (decay
    every key, add the ordinal's counts): per ordinal the tracker at its
    end; the port's plain and CUDA versions must match it bit for bit."""
    a = np.float32(alpha)
    trk = trk0.astype(np.float32).copy()
    if pre:
        trk = trk * a
    out = []
    for j, (lo, hi) in enumerate(ff._epoch_bounds(m, g0, epoch, ne)):
        if j:
            trk = trk * a
        c = np.bincount(keys[lo:hi], minlength=trk.shape[0])
        trk = np.where(c != 0, trk + c.astype(np.float32), trk)
        out.append((lo, hi, trk.copy()))
    return out


def _assert_tracker_exact(trk0, carry0, keys, m, kw, trk, carry, fv, tot,
                          top):
    """trk, fv and top bit for bit the dense tracker's, per ordinal; the
    carried total within 1e-5 of its float64 sum; carry = the last
    ordinal's (total, max)."""
    total = np.float64(carry0[0])
    for j, (lo, hi, dense) in enumerate(_dense_tracker(
            trk0, keys, m, **kw)):
        np.testing.assert_array_equal(fv[lo:hi], dense[keys[lo:hi]])
        assert top[j] == dense.max()
        total = total * (kw["alpha"] if (j or kw["pre"]) else 1.0) + hi - lo
        assert tot[j] == pytest.approx(dense.astype(np.float64).sum(),
                                       rel=1e-5)
        assert tot[j] == pytest.approx(total, rel=1e-5)
    np.testing.assert_array_equal(trk, dense)
    np.testing.assert_array_equal(carry, [tot[-1], top[-1]])


@pytest.mark.parametrize("scheme", ["dc", "wc", "fish"])
def test_tracker_matches_reference(scheme):
    """One segment against the reference's ``_tracker_update``: DC/WC (one
    ordinal, no decay) exact in trk, fv, the total and the max; FISH (a
    segment starting on an epoch boundary and crossing three more) within
    rtol 1e-5 in trk and, per epoch, fv against the reference cut at that
    epoch's end — and bit for bit the dense op-by-op tracker."""
    s = Seg(seed=2)
    rng = np.random.default_rng(7)
    trk0 = np.zeros(s.kcap + 1, np.float32)
    trk0[:s.kcap] = rng.integers(0, 30, s.kcap)
    kw = dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0)
    if scheme == "fish":
        kw = _fish_kw(2_000, s.m, 400)
        assert kw["pre"] == 1 and kw["ne"] == 4
    trk, carry = T(trk0.copy()), _carry(trk0)
    carry0 = carry.numpy().copy()
    fv, tot, top = ff.tracker_update(trk, carry, T(s.keys), s.m, **kw)
    fv, tot, top = fv.numpy(), tot.numpy(), top.numpy()
    trk_r, f_r, ftop_r = _ref_tracker(s, trk0, kw, s.m)
    if scheme == "fish":
        np.testing.assert_allclose(trk.numpy(), trk_r, rtol=1e-5, atol=1e-6)
        for lo, hi in ff._epoch_bounds(s.m, kw["g0"], kw["epoch"],
                                       kw["ne"]):
            trk_j = _ref_tracker(s, trk0, kw, hi)[0]
            np.testing.assert_allclose(fv[lo:hi], trk_j[s.keys[lo:hi]],
                                       rtol=1e-5)
        np.testing.assert_allclose(tot[-1], trk_r.astype(np.float64).sum(),
                                   rtol=1e-5)
        assert top[-1] / tot[-1] == pytest.approx(ftop_r, rel=1e-5)
    else:  # integer counts: exact
        np.testing.assert_array_equal(trk.numpy(), trk_r)
        assert tot[0] == np.float32(trk_r.sum())
        assert top[0] == trk_r.max()
        np.testing.assert_array_equal(fv, trk_r[s.keys[:s.m]])
        np.testing.assert_array_equal(fv / tot[0], f_r[:s.m])
        assert top[0] / tot[0] == np.float32(ftop_r)
    _assert_tracker_exact(trk0, carry0, s.keys, s.m, kw, trk.numpy(),
                          carry.numpy(), fv, tot, top)


@pytest.mark.parametrize("case", ["boundary", "mid_epoch", "short_epochs",
                                  "alpha_one_epochs", "one_tuple",
                                  "one_key"])
def test_tracker_segment_cases(case):
    """The plain version on segments that start on an epoch boundary
    (pre), start mid-epoch and cross several, have epochs of 7 tuples (ne
    ~ 215, past the kernel's 64-ordinal mask), count with epochs but
    alpha = 1, hold one tuple, or hold one key only: bit for bit the dense
    op-by-op tracker per ordinal, and within rtol 1e-5 of the reference
    at the segment's end."""
    s = Seg(seed=30)
    m = s.m
    rng = np.random.default_rng(31)
    trk0 = np.zeros(s.kcap + 1, np.float32)
    trk0[:s.kcap] = rng.integers(0, 50, s.kcap) * (rng.random(s.kcap) < .3)
    keys = s.keys.copy()
    kw = {"boundary": _fish_kw(1_200, m, 300),
          "mid_epoch": _fish_kw(1_250, m, 300),
          "short_epochs": _fish_kw(3, m, 7),
          "alpha_one_epochs": _fish_kw(450, m, 200, alpha=1.0),
          "one_tuple": _fish_kw(999, 1, 500),
          "one_key": _fish_kw(10, m, 400)}[case]
    if case == "one_tuple":
        m = 1
    if case == "one_key":
        keys[:m] = 17
    trk, carry = T(trk0.copy()), _carry(trk0)
    carry0 = carry.numpy().copy()
    fv, tot, top = ff.tracker_update(trk, carry, T(keys), m, **kw)
    _assert_tracker_exact(trk0, carry0, keys, m, kw, trk.numpy(),
                          carry.numpy(), fv.numpy(), tot.numpy(),
                          top.numpy())
    s.m, s.keys = m, keys
    trk_r = _ref_tracker(s, trk0, kw, m)[0]
    # keys only: with ~215 epochs the reference's padding lanes weigh
    # alpha^-k (inf) by 0, a NaN in the phantom row
    np.testing.assert_allclose(trk.numpy()[:-1], trk_r[:-1], rtol=1e-5,
                               atol=1e-6)


def test_tracker_carries_across_key_capacity_growth():
    """Two FISH segments with the key capacity grown between them as the
    runner grows it (``_grow_dev``: new slots zero, the carried total and
    max left as they are): the second segment's tracker, total and max
    against the dense tracker and the reference."""
    s1, s2 = Seg(seed=32, kcap=64), Seg(seed=33)
    trk = torch.zeros(65, dtype=torch.float32)
    carry = torch.zeros(2, dtype=torch.float32)
    kw1 = _fish_kw(0, s1.m, 250)
    ff.tracker_update(trk, carry, T(s1.keys), s1.m, **kw1)
    trk_r = _ref_tracker(s1, np.zeros(65, np.float32), kw1, s1.m)[0]
    trk = ff._grow_dev(trk, (64,), (s2.kcap + 1,), torch.float32, "cpu")
    grown = trk.numpy().copy()
    carry0 = carry.numpy().copy()
    assert carry0[1] == grown.max()
    kw2 = _fish_kw(s1.m, s2.m, 250)
    fv, tot, top = ff.tracker_update(trk, carry, T(s2.keys), s2.m, **kw2)
    _assert_tracker_exact(grown, carry0, s2.keys, s2.m, kw2, trk.numpy(),
                          carry.numpy(), fv.numpy(), tot.numpy(),
                          top.numpy())
    ref0 = np.zeros(s2.kcap + 1, np.float32)
    ref0[:64] = trk_r[:64]
    np.testing.assert_allclose(trk.numpy(), _ref_tracker(s2, ref0, kw2,
                                                         s2.m)[0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme", ["dc", "fish"])
def test_tracker_carry_from_a_converted_runner(scheme):
    """A fused edge run in the JAX package and carried into the port by
    ``convert.runner_from_reference``: the port's carried total is the
    float32 sum of the reference's tracker and its max the max, and the
    next segment's update meets the dense tracker from there."""
    from repro.core.stream import simulate_edge as ref_simulate_edge
    from repro.topology.configs import config_for as ref_config
    from repro_torch.convert import runner_from_reference

    keys, _ = torch_helpers.zf_stream(2_500, num_keys=300)
    g_ref = ref_config(scheme).build(8)
    r1 = ref_simulate_edge(g_ref, keys[:1_300], mode="fused",
                           arrival_rate=2e4)
    _, st = runner_from_reference(r1.state.device, g_ref, r1.state,
                                  device="cpu")
    run = st.device
    trk0 = np.asarray(r1.state.device.trk, np.float32)
    carry0 = run.trk_carry.numpy().copy()
    np.testing.assert_array_equal(
        carry0, [trk0.sum(dtype=np.float32), trk0.max()])
    m = 900  # FISH: across the epoch boundary at 2,000
    kw = (_fish_kw(1_300, m, g_ref.params.epoch,
                   float(np.float32(g_ref.params.alpha)))
          if scheme == "fish" else dict(g0=0, epoch=0, pre=0, ne=1,
                                        alpha=1.0))
    seg = keys[1_300:1_300 + m].astype(np.int32)
    fv, tot, top = ff.tracker_update(run.trk, run.trk_carry, T(seg), m, **kw)
    _assert_tracker_exact(trk0, carry0, seg, m, kw, run.trk.numpy(),
                          run.trk_carry.numpy(), fv.numpy(), tot.numpy(),
                          top.numpy())


def test_tracker_carry_stays_on_the_dense_sum_over_a_long_stream():
    """A 210-epoch FISH stream in segments that cross several epochs: at
    every epoch's end the carried total stays within 1e-5 relative of the
    float64 sum of the dense tracker, and the carried max equals its max
    exactly."""
    from repro_torch.data.synthetic import zipf_time_evolving

    epoch, seg, n, kcap = 50, 333, 10_500, 512
    keys = zipf_time_evolving(n, num_keys=kcap, z=1.3, flip_at=0.5,
                              flip_head=200, seed=34).astype(np.int32)
    trk = torch.zeros(kcap + 1, dtype=torch.float32)
    carry = torch.zeros(2, dtype=torch.float32)
    epochs = 0
    for g0 in range(0, n, seg):
        m = min(seg, n - g0)
        kw = _fish_kw(g0, m, epoch)
        trk0, carry0 = trk.numpy().copy(), carry.numpy().copy()
        fv, tot, top = ff.tracker_update(trk, carry, T(keys[g0:g0 + m]), m,
                                         **kw)
        _assert_tracker_exact(trk0, carry0, keys[g0:g0 + m], m, kw,
                              trk.numpy(), carry.numpy(), fv.numpy(),
                              tot.numpy(), top.numpy())
        epochs += kw["ne"] - 1 + kw["pre"]
    assert epochs >= 200


def _route(s, scheme, rows, **kw):
    """route_scan (PKG/DC/WC/FISH) then fifo_workers, as ``run_segment``
    chains them; SG/FG route inside fifo_workers."""
    busy = T(s.busy.astype(np.float64))
    counts = T(s.counts.copy())
    fifo = dict(t=T(s.t.astype(np.float64)), busy=busy,
                caps=T(s.caps.astype(np.float64)), counts=counts)
    if scheme in ("sg", "fg"):
        workers, fin = ff.fifo_workers(scheme, s.m, rows=rows, **fifo, **kw)
    else:
        routed = ff.route_scan(scheme, s.m, keys=T(s.keys), counts=counts,
                               rows=rows, **kw)
        workers, fin = ff.fifo_workers(scheme, s.m, workers=routed, **fifo)
        assert workers is routed
    return workers[:s.m].numpy(), fin[:s.m].numpy(), busy.numpy(), \
        counts.numpy()


@pytest.mark.parametrize("w1,width,path,k", [
    (1, 2, "smem", 0),      # no worker: nothing to hold
    (2, 2, "reg", 4),       # one worker
    (46, 45, "reg", 4),     # a worker count not a multiple of 32
    (129, 128, "reg", 4),   # the paper's 128 workers
    (129, 2, "reg", 4),     # PKG's rows
    (129, 300, "reg", 4),   # rows wider than the workers
    (130, 129, "reg", 8),
    (257, 256, "reg", 8),   # 256 workers: the widest register edge
    (258, 257, "smem", 0),  # 257: the shared-memory walk
    (258, 2, "smem", 0),
    (129, 1 << 23, "reg", 4),
    (129, (1 << 23) + 1, "smem", 0),  # a position word's sign bit
])
def test_route_scan_plan_picks_the_chain_by_worker_count(w1, width, path,
                                                         k):
    """route_scan's register chain on every edge of 1 to 256 workers (K =
    4 slots a lane to 128, else 8), the shared-memory walk past them."""
    plan = ff._route_scan_plan(w1, 17, width)
    assert (plan.path, plan.k) == (path, k)
    if path == "smem":
        assert plan.smem == ff._route_scan_smem(w1, 17, width)


@pytest.mark.parametrize("w1,width,k,tile", [(129, 128, 4, 219),
                                             (257, 256, 8, 108)])
def test_route_scan_register_plan_fits_the_block(w1, width, k, tile):
    """The register chain's tiles (32 lanes' K position words, d and the
    route a tuple, two buffers, two tuples' words of slack) beside the
    per-worker and per-epoch arrays fit a Hopper block's shared memory."""
    plan = ff._route_scan_plan(w1, 17, width)
    assert (plan.path, plan.k, plan.tile) == ("reg", k, tile)
    assert plan.smem <= ff._SMEM_LIMIT
    words = 32 * 4 * k
    assert plan.smem == (2 * tile * (words + 8) + 2 * words + 4 * 2 * w1
                         + 4 * (4 * w1 + 2 * 17))
    # many epochs shrink the tile, never past the block
    many = ff._route_scan_plan(w1, 12_000, width)
    assert many.tile < tile and many.smem <= ff._SMEM_LIMIT


@pytest.mark.parametrize("w1,width", [(1_025, 1_024), (258, 30_000),
                                      (300, 129)])
def test_route_scan_shared_walk_refusal_is_unchanged(w1, width):
    """Past 256 workers the plan is the shared-memory walk's, with its own
    shared memory: the wrapper refuses an edge whose walk does not fit."""
    plan = ff._route_scan_plan(w1, 17, width)
    tile = max(1, min(ff._TILE_MAX, ff._TILE_INTS // width))
    want = 4 * (2 * tile * width + 2 * tile + 2 * w1) + 4 * (4 * w1 + 34)
    assert plan == ff.RoutePlan("smem", 0, 0, want)
    assert (plan.smem > ff._SMEM_LIMIT) == (width >= 30_000)


def test_route_pkg_and_fifo_match_reference():
    s = Seg(seed=3)
    rows = s.rows(2)
    counts_r, workers_r = rff._route_pkg(s.ref_a(), jnp.asarray(rows.numpy()))
    workers, fin, busy, counts = _route(s, "pkg", rows)
    np.testing.assert_array_equal(workers, np.asarray(workers_r)[:s.m])
    np.testing.assert_array_equal(counts[:-1], np.asarray(counts_r)[:-1])
    busy_r, fin_r = rff._fifo_scan(jnp.asarray(s.busy), jnp.asarray(s.caps),
                                   workers_r, jnp.asarray(s.t))
    np.testing.assert_allclose(fin, np.asarray(fin_r)[:s.m], rtol=2e-5)
    np.testing.assert_allclose(busy[:-1], np.asarray(busy_r)[:-1], rtol=2e-5)


@pytest.mark.parametrize("scheme", ["sg", "fg"])
def test_fixed_routes_and_fifo_match_reference(scheme):
    s = Seg(seed=4)
    if scheme == "sg":
        act = np.full(s.w1, s.w1 - 1, np.int32)
        act[:s.w1 - 1] = np.arange(s.w1 - 1)
        workers, fin, busy, counts = _route(s, "sg", None, act=T(act),
                                            a_live=s.w1 - 1, rr=3)
        want = act[(3 + np.arange(s.m)) % (s.w1 - 1)]
    else:
        rows = s.rows(1)
        workers, fin, busy, counts = _route(s, "fg", rows)
        want = rows.numpy()[:s.m, 0]
    np.testing.assert_array_equal(workers, want)
    wpad = np.full(s.n_pad, s.w1 - 1, np.int32)
    wpad[:s.m] = workers
    busy_r, fin_r = rff._fifo_scan(jnp.asarray(s.busy), jnp.asarray(s.caps),
                                   jnp.asarray(wpad), jnp.asarray(s.t))
    np.testing.assert_allclose(fin, np.asarray(fin_r)[:s.m], rtol=2e-5)
    np.testing.assert_allclose(busy[:-1], np.asarray(busy_r)[:-1], rtol=2e-5)
    np.testing.assert_array_equal(
        counts - s.counts, np.bincount(workers, minlength=s.w1))


def _tracked(s, trk0, kw):
    fv, tot, top = ff.tracker_update(T(trk0.copy()), _carry(trk0),
                                     T(s.keys), s.m, **kw)
    return dict(fv=fv, tot=tot, top=top, g0=kw["g0"], epoch=kw["epoch"])


@pytest.mark.parametrize("scheme", ["dc", "wc"])
def test_route_dcwc_matches_reference(scheme):
    s = Seg(seed=5)
    trk0 = np.zeros(s.kcap + 1, np.float32)
    rows = s.rows()
    theta, wnum = 0.25 / 8, 8.0
    counts_r, workers_r, _ = rff._route_dcwc(
        s.ref_a(trk=jnp.asarray(trk0), theta=jnp.float32(theta),
                wnum=jnp.float32(wnum), act_mask=jnp.asarray(s.act_mask)),
        jnp.asarray(rows.numpy()), scheme)
    kw = _tracked(s, trk0, dict(g0=0, epoch=0, pre=0, ne=1, alpha=1.0))
    workers, _, _, counts = _route(s, scheme, rows, theta=theta, wnum=wnum,
                                   act_mask=T(s.act_mask), **kw)
    np.testing.assert_array_equal(workers, np.asarray(workers_r)[:s.m])
    np.testing.assert_array_equal(counts[:-1], np.asarray(counts_r)[:-1])


def test_route_fish_matches_reference_within_one_epoch():
    """Inside one epoch the port's epoch-granular FISH reads the same
    tracker as the reference's segment-granular one: routing, CHK memory
    and the estimator must match exactly."""
    s = Seg(seed=6)
    trk0 = np.zeros(s.kcap + 1, np.float32)
    rows = s.rows()
    theta, wnum = 0.25 / 8, 8.0
    for do_tick in (0, 1):
        a = s.ref_a(trk=jnp.asarray(trk0), theta=jnp.float32(theta),
                    wnum=jnp.float32(wnum), m_k=jnp.asarray(s.m_k),
                    d_min=jnp.int32(2), ebl=jnp.asarray(s.ebl),
                    eas=jnp.asarray(s.eas), ecaps=jnp.asarray(s.ecaps),
                    do_tick=jnp.int32(do_tick), elapsed=jnp.float32(0.7),
                    g0=jnp.int32(0), epoch=jnp.int32(10_000),
                    pre_decay=jnp.int32(0), c_total=jnp.float32(0.0),
                    alpha=jnp.float32(0.2))
        counts_r, workers_r, _, mk_r, bl_r, as_r = rff._route_fish(
            a, jnp.asarray(rows.numpy()))
        kw = _tracked(s, trk0, dict(g0=0, epoch=10_000, pre=0, ne=1,
                                    alpha=0.2))
        m_k, ebl, eas = T(s.m_k.copy()), T(s.ebl.copy()), T(s.eas.copy())
        workers, _, _, counts = _route(
            s, "fish", rows, theta=theta, wnum=wnum, m_k=m_k, d_min=2,
            ebl=ebl, eas=eas, ecaps=T(s.ecaps), do_tick=do_tick,
            elapsed=0.7, **kw)
        np.testing.assert_array_equal(workers, np.asarray(workers_r)[:s.m])
        np.testing.assert_array_equal(counts[:-1], np.asarray(counts_r)[:-1])
        np.testing.assert_array_equal(m_k.numpy()[:-1],
                                      np.asarray(mk_r)[:-1])
        np.testing.assert_array_equal(ebl.numpy()[:-1],
                                      np.asarray(bl_r)[:-1])
        np.testing.assert_array_equal(eas.numpy()[:-1],
                                      np.asarray(as_r)[:-1])


@pytest.mark.parametrize("case", ["reset", "steady", "growth"])
def test_pane_update_plain_matches_numpy(case):
    """The pane table in canonical form (occupied slots sorted by pair
    key), pane_last and the replica matrix against np.add.at /
    np.maximum.at: one segment into a cleared table (reset), three into
    one table (steady), and three into a table that grows twice in the
    pane, its slots re-inserted (growth)."""
    s = Seg(seed=8)
    rng = np.random.default_rng(9)
    kcap1 = s.kcap + 1
    segs = 1 if case == "reset" else 3
    cap = ff.pane_capacity(s.m if case == "growth" else segs * s.m)
    pane_keys = torch.full((cap,), 99, dtype=torch.int64)
    pane_vc = torch.full((2, cap), 99, dtype=torch.int32)
    last = torch.full((s.w1,), 99, dtype=torch.int32)
    repl = torch.zeros((kcap1, s.w1), dtype=torch.bool)
    want_v = np.zeros((s.w1, kcap1), np.int64)
    want_c = np.zeros((s.w1, kcap1), np.int64)
    want_last = np.full(s.w1, -1)
    grew = 0
    for j in range(segs):
        workers = np.full(s.n_pad, s.w1 - 1, np.int32)
        workers[:s.m] = rng.integers(0, s.w1 - 1, s.m)
        vals = rng.integers(-3, 10, s.n_pad).astype(np.int32)
        need = ff.pane_capacity((j + 1) * s.m)
        if need > pane_keys.shape[0]:
            pane_keys, pane_vc = ff.pane_grow(pane_keys, pane_vc, need)
            grew += 1
        ff.pane_update(T(s.keys), T(workers), s.m, repl=repl, vals=T(vals),
                       seg_base=500 + j * s.m, pane_keys=pane_keys,
                       pane_vc=pane_vc, pane_last=last, reset=j == 0)
        k, w, v = s.keys[:s.m], workers[:s.m], vals[:s.m]
        np.add.at(want_v, (w, k), v)
        np.add.at(want_c, (w, k), 1)
        np.maximum.at(want_last, w, 500 + j * s.m + np.arange(s.m))
    assert grew == (2 if case == "growth" else 0)
    pairs, vc = ff.pane_canonical(pane_keys, pane_vc)
    # the flush's one-copy form: the same pairs and sums, and pane_last
    block, n = ff.pane_block(pane_keys, pane_vc, last)
    got = ff.pane_unblock(block.numpy(), n, s.w1)
    for a, b in zip(got, (pairs.numpy(), vc.numpy(), last.numpy())):
        np.testing.assert_array_equal(a, b)
    ws, ks = np.nonzero(want_c)  # row-major: sorted by (worker, key)
    np.testing.assert_array_equal(pairs.numpy(), (ws << 32) | ks)
    np.testing.assert_array_equal(vc[0].numpy(), want_v[ws, ks])
    np.testing.assert_array_equal(vc[1].numpy(), want_c[ws, ks])
    np.testing.assert_array_equal(last.numpy(), want_last)
    np.testing.assert_array_equal(repl.numpy(), (want_c > 0).T)
    # every slot past the occupied ones is empty, with zero sums
    free = pane_keys == ff.PANE_EMPTY
    assert int((~free).sum()) == ws.shape[0]
    assert not bool(pane_vc[:, free].any())


@pytest.mark.parametrize("case", ["reset", "steady", "from_entries"])
def test_pane_update_plain_refuses_an_overfull_table(case):
    """The plain version refuses what the card refuses: a reset call of
    more tuples than C / 2, a steady call whose pairs pass half load, and
    entries past C / 2 into a fresh table (tests/test_torch_cuda.py holds
    the card to the same)."""
    with pytest.raises(ValueError, match="past half load"):
        torch_helpers.overfull_pane(case, "cpu")


@pytest.mark.parametrize("sizes", [[(64, 300)], [(40, 200), (0, 30), (16, 0),
                                                  (128, 500), (1, 9)]])
def test_store_probe_grouped_matches_pallas(sizes):
    """Each pair of a grouped probe — packed chunks, a count column, empty
    tables and empty chunks among them — against the Pallas kernel."""
    from repro_torch.kernels import store_probe as sp

    tables, keys, vals, cnts, offsets = [], [], [], [], [0]
    for g, (k, n) in enumerate(sizes):
        table, ks, vs = _probe_inputs(20 + g, max(k, 1), n)
        tables.append(table[:k])
        keys.append(ks)
        vals.append(vs)
        cnts.append(np.random.default_rng(g).integers(1, 9, n).astype(
            np.int32))
        offsets.append(offsets[-1] + n)
    cat = (lambda xs: T(np.concatenate(xs).astype(np.int32)))
    vout = [torch.full((t.shape[0],), 5, dtype=torch.int32) for t in tables]
    cout = [torch.full((t.shape[0],), 7, dtype=torch.int32) for t in tables]
    sp.store_probe_grouped([T(t) for t in tables], cat(keys), cat(vals),
                           cat(cnts), offsets, vout, cout)
    for g, table in enumerate(tables):
        if table.shape[0] == 0 or keys[g].shape[0] == 0:  # nothing to add
            assert (vout[g] == 5).all() and (cout[g] == 7).all()
            continue
        vr, _, _ = pallas_store_probe(jnp.asarray(table), jnp.asarray(keys[g]),
                                      jnp.asarray(vals[g]), interpret=True)
        cr, _, _ = pallas_store_probe(jnp.asarray(table), jnp.asarray(keys[g]),
                                      jnp.asarray(cnts[g]), interpret=True)
        np.testing.assert_array_equal(vout[g].numpy(), 5 + np.asarray(vr))
        np.testing.assert_array_equal(cout[g].numpy(), 7 + np.asarray(cr))


@pytest.mark.parametrize("fault", ["none", "dtype", "foreign_view"])
def test_store_probe_grouped_checks_the_slab_once(fault):
    """The packed call (``slab=``): chunks and meta as views of one int32
    buffer; the buffer is checked, not each column — a buffer of another
    dtype or a chunk from outside it is refused, and a sound one adds as
    the per-pair call does."""
    from repro_torch.kernels import store_probe as sp

    table = torch.tensor([2, 5, 9], dtype=torch.int32)
    buf = torch.tensor([5, 9, 5, 1, 2, 3, 1, 1, 1], dtype=torch.int32)
    keys, vals, cnts = buf[:3], buf[3:6], buf[6:9]
    slab = buf
    if fault == "dtype":
        slab = buf.to(torch.int64)
    elif fault == "foreign_view":
        keys = keys.clone()
    vout, cout = [torch.zeros(3, dtype=torch.int32) for _ in range(2)]
    call = (lambda: sp.store_probe_grouped([table], keys, vals, cnts, [0, 3],
                                           [vout], [cout], slab=slab))
    if fault == "none":
        call()
        assert vout.tolist() == [0, 1 + 3, 2] and cout.tolist() == [0, 2, 1]
    else:
        with pytest.raises(TypeError if fault == "dtype" else ValueError,
                           match="slab"):
            call()
