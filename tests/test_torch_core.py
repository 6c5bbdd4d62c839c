"""Port core vs the JAX package's core on the same seeded inputs: the hash
and ring, the generators, CHK, Alg. 3 and all six groupers' routing.
Everything here is host NumPy in both packages, so it must match exactly.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.synthetic as RD
from repro.core.assignment import greedy_allocate as greedy_ref
from repro.core.assignment import select_min_wait as rsel
from repro.core.fish import chk_num_workers_batch as chk_batch_ref
import repro.topology.configs as RC
import repro_torch.core as P
import repro_torch.data.synthetic as PD
import repro_torch.topology.configs as PC

from torch_helpers import SCHEMES


@pytest.mark.parametrize("value", [0, 1, 7, 2 ** 31, -5, "hot", (3, 1),
                                   np.int32(42), (np.int64(9), 2)])
def test_hash32_bit_identical(value):
    assert P.hash32(value) == R.hash32(value)


@pytest.mark.parametrize("workers,vnodes", [(8, 64), (16, 8), (128, 64)])
def test_ring_lookup_n_identical(workers, vnodes):
    rp = P.ConsistentHashRing(range(workers), virtual_nodes=vnodes)
    rr = R.ConsistentHashRing(range(workers), virtual_nodes=vnodes)
    assert rp._points == rr._points
    for k in range(0, 600, 7):
        for n in (1, 2, 5, workers):
            assert rp.lookup_n(k, n) == rr.lookup_n(k, n)
    for ring in (rp, rr):  # membership churn keeps them in step
        ring.remove_worker(3)
        ring.add_worker(workers + 1)
    assert rp._points == rr._points
    assert [rp.lookup(k) for k in range(200)] == \
        [rr.lookup(k) for k in range(200)]


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_bit_identical(seed):
    np.testing.assert_array_equal(
        PD.zipf_time_evolving(5_000, num_keys=1_000, z=1.2, seed=seed),
        RD.zipf_time_evolving(5_000, num_keys=1_000, z=1.2, seed=seed))
    np.testing.assert_array_equal(
        PD.piecewise_zipf(4_000, 500, phases=3, seed=seed),
        RD.piecewise_zipf(4_000, 500, phases=3, seed=seed))
    ids_p, voc_p = PD.intern_keys(["b", "a", "b", "c"])
    ids_r, voc_r = RD.intern_keys(["b", "a", "b", "c"])
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(voc_p, voc_r)


def test_chk_scalar_and_batch_identical():
    rng = np.random.default_rng(1)
    f = rng.random(200) * 0.3
    m = rng.integers(0, 40, 200)
    for num_workers in (8, 128):
        dp, mp = P.chk_num_workers_batch(f, 0.3, 0.25 / num_workers,
                                         num_workers, 2, m)
        dr, mr = chk_batch_ref(f, 0.3, 0.25 / num_workers, num_workers, 2,
                               m)
        np.testing.assert_array_equal(dp, dr)
        np.testing.assert_array_equal(mp, mr)
        for i in range(0, 200, 17):
            assert P.chk_num_workers(f[i], 0.3, 0.25 / num_workers,
                                     num_workers, 2, int(m[i])) == \
                R.chk_num_workers(f[i], 0.3, 0.25 / num_workers,
                                  num_workers, 2, int(m[i]))


def test_tracker_and_estimator_identical():
    keys = PD.zipf_time_evolving(6_000, num_keys=300, z=1.3, seed=2)
    tp = P.EpochFrequencyTracker(P.FishParams(k_max=50, epoch=500))
    tr = R.EpochFrequencyTracker(R.FishParams(k_max=50, epoch=500))
    tp.update_many(keys)
    tr.update_many(keys)
    assert tp.counts == tr.counts
    assert tp.epochs_completed == tr.epochs_completed
    caps = np.linspace(1e-3, 3e-3, 6)
    ep = P.WorkerStateEstimator(capacities=caps, interval=0.5)
    er = R.WorkerStateEstimator(capacities=caps, interval=0.5)
    for i in range(300):
        cands = [i % 6, (i * 5 + 1) % 6, (i * 7 + 2) % 6]
        assert ep.select(cands, now=i * 0.01) == er.select(cands,
                                                           now=i * 0.01)
    np.testing.assert_array_equal(ep.backlog, er.backlog)
    np.testing.assert_array_equal(
        P.greedy_allocate(np.array([3.0, 1.0, 2.0]), caps[:3], 50),
        greedy_ref(np.array([3.0, 1.0, 2.0]), caps[:3], 50))


def test_select_min_wait_matches_reference_ties():
    backlog = np.array([2.0, 1.0, 1.0, 3.0, 1.0], np.float32)
    cap = np.array([1.0, 2.0, 2.0, 1.0, 2.0], np.float32)
    mask = np.array([[True, True, True, True, True],
                     [True, False, True, True, True],
                     [False, False, False, True, False]])
    got = P.select_min_wait(torch.from_numpy(backlog), torch.from_numpy(cap),
                            torch.from_numpy(mask))
    want = np.asarray(rsel(backlog, cap, mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_grouper_assign_batch_identical(scheme):
    """All six groupers route identically on the host path, across chunks
    and through a scale-out / scale-in membership change."""
    keys = PD.zipf_time_evolving(4_000, num_keys=500, z=1.3, seed=4)
    gp = PC.config_for(scheme).build(8)
    gr = RC.config_for(scheme).build(8)
    for g in (gp, gr):
        for w in range(8):
            g.record_capacity_sample(w, 1e-3 * (1 + w % 3))
    for lo, hi, members in ((0, 1_500, None), (1_500, 2_600, range(10)),
                            (2_600, 4_000, range(1, 10))):
        if members is not None:
            gp.on_membership_change(list(members))
            gr.on_membership_change(list(members))
        wp = gp.assign_batch(keys[lo:hi], lo * 1e-4, 1e-4)
        wr = gr.assign_batch(keys[lo:hi], lo * 1e-4, 1e-4)
        np.testing.assert_array_equal(wp, wr)
    np.testing.assert_array_equal(gp.assigned_counts, gr.assigned_counts)
    assert gp.replicas == gr.replicas
    assert [gp.probe_route(k) for k in range(50)] == \
        [gr.probe_route(k) for k in range(50)]
    # the per-tuple oracle path, too
    assert [gp.assign(int(k), 1.0) for k in keys[:200]] == \
        [gr.assign(int(k), 1.0) for k in keys[:200]]
