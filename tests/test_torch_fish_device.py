"""The device form of FISH's Alg. 1 in the port against the JAX package.

The plain versions of ``fish_count`` (K1a) and ``fish_epoch_count`` (K1b)
meet the Pallas kernels (interpret mode) through both packages' ``ops``
wrappers, and the reference's oracles, on the same numpy-seeded inputs.
Counts are integers plus, for K1b, one decay multiply; flags are
booleans: all exact — with one documented exception.  The contract is
``fl(fl(counts·alpha) + delta)``, as ``ref.fish_epoch_count_ref`` rounds
it; the Pallas kernel in interpret mode is compiled by XLA's CPU backend,
which contracts that multiply-add into one FMA (a single rounding), so its
decayed counts may sit one float32 ulp away.  ``epoch_update`` on each of
its paths and ``classify_hot_keys`` then follow the reference epoch by
epoch over the JAX tests' own ZF stream: keys identical, counts
bit-identical (within that ulp against the interpret-mode kernel).  The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py``.

``fish_epoch_update`` (the whole epoch in one launch, ``epoch_fn=``) runs
its plain version here, the port's composition under one of the two tie
rules: "first" is held against the reference's fused path with its own
oracle as ``fused_fn`` (the arithmetic the port keeps), "key" against its
match path with the Pallas ``fish_count`` (integer counts, exact).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fish as rfish
from repro.data.synthetic import zipf_time_evolving
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.core import fish as pfish
from repro_torch.kernels import fish_count as pfc
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

import torch_helpers  # noqa: F401  (caps torch threads)

T = torch.from_numpy


def _table(k_slots, n_real, universe, seed):
    rng = np.random.default_rng(seed)
    table = np.full(k_slots, -1, np.int32)
    table[:n_real] = rng.choice(universe, n_real, replace=False)
    counts = np.zeros(k_slots, np.float32)
    counts[:n_real] = rng.gamma(2.0, 3.0, n_real).astype(np.float32)
    return table, counts


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _ulp1(port, ref, maxulp=1):
    """Decayed counts against the interpret-mode Pallas kernel (its
    multiply-add contracted into an FMA by XLA): one call is at most one
    ulp away.  Over many epochs each difference decays by alpha while the
    next epoch adds at most one more, and the table carries it on: the sum
    stays below 1/(1 - alpha) = 1.25 ulp before rounding, so within 2."""
    np.testing.assert_array_max_ulp(port.numpy(), np.asarray(ref),
                                    maxulp=maxulp)


@pytest.mark.parametrize("k_slots,n_keys", [(128, 512), (100, 3000),
                                            (1000, 1000), (1, 7)])
def test_fish_count_plain_matches_pallas(k_slots, n_keys):
    table, _ = _table(k_slots, k_slots * 3 // 4 or 1, 10_000, k_slots + n_keys)
    keys = np.random.default_rng(n_keys).integers(0, 12_000, n_keys).astype(
        np.int32)
    want = rops.fish_count(jnp.asarray(table), jnp.asarray(keys))
    got = pops.fish_count(T(table), T(keys))
    oracle = pref.fish_count_ref(T(table), T(keys))
    for g, w, o in zip(got, want, oracle):
        _eq(g, w)
        assert torch.equal(g, o)


@pytest.mark.parametrize("k_slots,n_keys,alpha", [(128, 1500, 0.2),
                                                  (1000, 1000, 0.2),
                                                  (300, 77, 0.5)])
def test_fish_epoch_count_plain_matches_pallas(k_slots, n_keys, alpha):
    table, counts = _table(k_slots, k_slots * 2 // 3, 4_000, k_slots)
    # a skewed epoch: repeated keys make the histogram and first flags bite
    keys = zipf_time_evolving(n_keys, num_keys=5_000, z=1.2,
                              seed=n_keys).astype(np.int32)
    keys[: n_keys // 4] = np.resize(table[: k_slots * 2 // 3], n_keys // 4)
    want = rops.fish_epoch_count(jnp.asarray(table), jnp.asarray(counts),
                                 jnp.asarray(keys), alpha=alpha)
    got = pops.fish_epoch_count(T(table), T(counts), T(keys), alpha=alpha)
    oracle = pref.fish_epoch_count_ref(T(table), T(counts), T(keys),
                                       alpha=alpha)
    ref_oracle = rref.fish_epoch_count_ref(
        jnp.asarray(table), jnp.asarray(counts), jnp.asarray(keys),
        alpha=alpha)
    for g, w, o, ro in zip(got, want, oracle, ref_oracle):
        assert torch.equal(g, o)
        _eq(o, ro)
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)
    _ulp1(got[0], want[0])


def test_fish_count_empty_table_and_epoch():
    table = torch.full((128,), -1, dtype=torch.int32)
    counts, matched = pops.fish_count(table, torch.arange(100,
                                                          dtype=torch.int32))
    assert int(counts.sum()) == 0 and not bool(matched.any())
    c, m, cand, first = pops.fish_epoch_count(
        table, torch.ones(128), torch.zeros(0, dtype=torch.int32), alpha=0.5)
    assert torch.equal(c, torch.full((128,), 0.5))
    assert m.shape == cand.shape == first.shape == (0,)


def test_fish_count_wrappers_reject_bad_input():
    with pytest.raises(TypeError, match="int32"):
        pfc.fish_count(torch.zeros(4, dtype=torch.int64),
                       torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        pfc.fish_epoch_count(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(5), torch.zeros(3,
                                                         dtype=torch.int32),
                             alpha=0.2)


ZF = dict(n=16_000, num_keys=2_000, z=1.4, seed=7)  # tests/test_fish.py:141


def _zf_keys():
    return zipf_time_evolving(ZF["n"], num_keys=ZF["num_keys"], z=ZF["z"],
                              seed=ZF["seed"]).astype(np.int32)


@pytest.mark.parametrize("path", ["plain", "match_fn", "fused_oracle",
                                  "fused_pallas"])
def test_epoch_update_follows_reference_bit_for_bit(path):
    """16 epochs of the JAX tests' ZF stream through both packages'
    ``epoch_update`` on the same path: after every epoch the table's keys
    are identical and its counts bit-identical (within one ulp against the
    interpret-mode Pallas K1b, see the module docstring);
    ``classify_hot_keys`` on the final table (with a carried CHK memory)
    agrees exactly.  ``fused_oracle`` runs the reference's fused path with
    its own oracle as ``fused_fn``, the arithmetic the port's K1b keeps."""
    p = pfish.FishParams(alpha=0.2, epoch=1000, k_max=256)
    keys = _zf_keys()
    ref_kw = {"plain": {}, "match_fn": {"match_fn": rops.fish_count},
              "fused_oracle": {"fused_fn": rref.fish_epoch_count_ref},
              "fused_pallas": {"fused_fn": rops.fish_epoch_count}}[path]
    port_kw = ({"fused_fn": pops.fish_epoch_count} if "fused" in path
               else {"match_fn": pops.fish_count} if path == "match_fn"
               else {})
    same = ((lambda a, b: _ulp1(a, b, maxulp=2)) if path == "fused_pallas"
            else _eq)
    rs = rfish.init_fish_state(p.k_max)
    ps = pfish.init_fish_state(p.k_max, device="cpu")
    for i in range(0, keys.shape[0], p.epoch):
        ep = keys[i:i + p.epoch]
        rs = rfish.epoch_update(rs, jnp.asarray(ep), alpha=p.alpha,
                                max_new=64, **ref_kw)
        ps = pfish.epoch_update(ps, T(ep), alpha=p.alpha, max_new=64,
                                **port_kw)
        _eq(ps["keys"], rs["keys"])
        same(ps["counts"], rs["counts"])
    if path == "fused_pallas":
        return  # CHK on ulp-apart counts is covered by the other paths
    m_ref = m_port = None
    for w in (128, 16):  # the second call carries the first's CHK memory
        theta = p.theta(w)
        d_r, hot_r, m_ref = rfish.classify_hot_keys(
            rs, num_workers=w, theta=theta, m_k=m_ref)
        d_p, hot_p, m_port = pfish.classify_hot_keys(
            ps, num_workers=w, theta=theta, m_k=m_port)
        for g, want in ((d_p, d_r), (hot_p, hot_r), (m_port, m_ref)):
            _eq(g, want)
        assert int(hot_p.sum()) > 0


def test_epoch_update_partial_epoch_smaller_than_max_new():
    state = pfish.init_fish_state(128, device="cpu")
    state = pfish.epoch_update(state, torch.arange(10, dtype=torch.int32),
                               alpha=0.2, max_new=64)
    state = pfish.epoch_update(state, torch.arange(5, 15, dtype=torch.int32),
                               alpha=0.2, max_new=64,
                               fused_fn=pops.fish_epoch_count)
    assert int((state["keys"] >= 0).sum()) == 15


def test_fish_state_from_reference_continues_the_stream():
    """A table started in the JAX package carries over through
    ``convert.fish_state_from_reference`` and goes on bit-identically."""
    keys = _zf_keys()
    rs = rfish.init_fish_state(256)
    for i in range(0, 8_000, 1000):
        rs = rfish.epoch_update(rs, jnp.asarray(keys[i:i + 1000]), alpha=0.2)
    ps = convert.fish_state_from_reference(
        {k: np.asarray(v) for k, v in rs.items()}, device="cpu")
    for i in range(8_000, 12_000, 1000):
        rs = rfish.epoch_update(rs, jnp.asarray(keys[i:i + 1000]), alpha=0.2)
        ps = pfish.epoch_update(ps, T(keys[i:i + 1000]), alpha=0.2)
    _eq(ps["keys"], rs["keys"])
    _eq(ps["counts"], rs["counts"])


def test_device_tracker_hot_set_tracks_sequential_oracle():
    """The port's fused device tracker follows the sequential Alg. 1
    tracker through the ZF flip (tests/test_batched_engine.py:273's
    bound)."""
    p = pfish.FishParams(alpha=0.2, epoch=1000, k_max=256)
    keys = _zf_keys()
    seq = pfish.EpochFrequencyTracker(p)
    seq.update_many(keys)
    st = pfish.init_fish_state(p.k_max, device="cpu")
    for i in range(0, keys.shape[0], p.epoch):
        st = pfish.epoch_update(st, T(keys[i:i + p.epoch]), alpha=p.alpha,
                                fused_fn=pops.fish_epoch_count)
    top_seq = set(sorted(seq.counts, key=seq.counts.get, reverse=True)[:20])
    order = torch.sort(st["counts"], descending=True, stable=True).indices
    top_dev = set(st["keys"][order[:20]].tolist())
    assert len(top_seq & top_dev) / len(top_seq | top_dev) >= 0.6


# -- the whole epoch in one launch (epoch_fn=) ----------------------------------

#: the reference's epoch_update path each tie rule follows
REF_PATH = {"first": {"fused_fn": rref.fish_epoch_count_ref},
            "key": {"match_fn": rops.fish_count}}


def _epoch_fn(ties):
    return functools.partial(pops.fish_epoch_update, ties=ties)


def _one_epoch_both(ties, table, counts, keys, max_new):
    """One epoch through the reference's path of ``ties`` and through the
    port's ``epoch_fn`` and plain version: keys equal, counts bit-equal.
    Returns the port's new keys."""
    rs = rfish.FishState(keys=jnp.asarray(table), counts=jnp.asarray(counts))
    rs = rfish.epoch_update(rs, jnp.asarray(keys), alpha=0.2,
                            max_new=max_new, **REF_PATH[ties])
    ps = pfish.epoch_update(pfish.FishState(T(table), T(counts)), T(keys),
                            alpha=0.2, max_new=max_new,
                            epoch_fn=_epoch_fn(ties))
    pk, pc = pfc.fish_epoch_update_plain(T(table), T(counts), T(keys),
                                         alpha=0.2, max_new=max_new,
                                         ties=ties)
    _eq(ps["keys"], rs["keys"])
    _eq(ps["counts"], rs["counts"])
    assert torch.equal(pk, ps["keys"]) and torch.equal(pc, ps["counts"])
    return ps["keys"]


@pytest.mark.parametrize("ties", ["first", "key"])
def test_epoch_fn_follows_reference_bit_for_bit(ties):
    """16 epochs of the ZF stream through ``epoch_update(epoch_fn=)``
    against the reference's path with the same tie rule: after every epoch
    the keys are identical and the counts bit-identical."""
    p = pfish.FishParams(alpha=0.2, epoch=1000, k_max=256)
    keys = _zf_keys()
    rs = rfish.init_fish_state(p.k_max)
    ps = pfish.init_fish_state(p.k_max, device="cpu")
    for i in range(0, keys.shape[0], p.epoch):
        ep = keys[i:i + p.epoch]
        rs = rfish.epoch_update(rs, jnp.asarray(ep), alpha=p.alpha,
                                max_new=64, **REF_PATH[ties])
        ps = pfish.epoch_update(ps, T(ep), alpha=p.alpha, max_new=64,
                                epoch_fn=_epoch_fn(ties))
        _eq(ps["keys"], rs["keys"])
        _eq(ps["counts"], rs["counts"])


def _tie_epoch():
    """Unmatched keys 30 and 20 both twice, 30 first in the epoch but 20
    the lower key; 10 once; 5 matched.  One insert (max_new 1)."""
    table = np.array([5, -1, 7, 9], np.int32)
    counts = np.array([3.0, 0.0, 0.5, 2.0], np.float32)
    keys = np.array([30, 20, 20, 30, 10, 5, 5, 7], np.int32)
    return table, counts, keys


@pytest.mark.parametrize("ties,want", [("first", 30), ("key", 20)])
def test_epoch_fn_tie_rules_pick_the_references_key(ties, want):
    table, counts, keys = _tie_epoch()
    got = _one_epoch_both(ties, table, counts, keys, max_new=1)
    assert want in got.tolist() and (50 - want) not in got.tolist()


def _edge_epoch(case):
    rng = np.random.default_rng(len(case))
    table, counts = _table(64, 40, 500, seed=3)
    if case == "few_candidates":  # 5 distinct unmatched keys < max_new
        keys = np.concatenate([np.resize(table[:40], 190),
                               np.repeat(np.arange(1000, 1005), 2)])
        return table, counts, rng.permutation(keys).astype(np.int32), 64
    if case == "all_matched":
        return table, counts, rng.choice(table[:40], 300).astype(np.int32), 16
    if case == "empty_table":
        keys = zipf_time_evolving(300, num_keys=200, z=1.2, seed=5)
        return (np.full(64, -1, np.int32), np.zeros(64, np.float32),
                keys.astype(np.int32), 16)
    # partial: a final epoch of 10 keys, shorter than max_new
    keys = np.concatenate([table[:3], [700, 701, 701, 702, 702, 702, 703]])
    return table, counts, keys.astype(np.int32), 64


@pytest.mark.parametrize("ties", ["first", "key"])
@pytest.mark.parametrize("case", ["few_candidates", "all_matched",
                                  "empty_table", "partial"])
def test_epoch_fn_edge_epochs_match_reference(case, ties):
    table, counts, keys, max_new = _edge_epoch(case)
    got = _one_epoch_both(ties, table, counts, keys, max_new)
    live = set(got[got >= 0].tolist())
    unmatched = set(keys.tolist()) - set(table[table >= 0].tolist())
    if case == "all_matched":
        assert torch.equal(got, T(table))
    elif case == "empty_table":  # more candidates than inserts
        assert len(live) == max_new
    else:  # fewer unmatched keys than inserts: every one lands
        assert unmatched <= live


@pytest.mark.parametrize("k,n,ok", [
    (4_480, 8_192, True),     # exactly the 232,448 B a block may use
    (4_481, 8_192, False),
    (1, 8_193, False),        # N' = 16,384: past the limit at any K
    (10_624, 1_000, True),    # a larger table beside a paper-sized epoch
    (0, 0, True)])
def test_epoch_update_size_limit(k, n, ok):
    """The one-block limit: a shape at the limit is taken, one past it on
    either axis is refused with the limit named, by the helper and by the
    wrapper on either device (no fallback)."""
    assert (pfc.epoch_smem_bytes(k, n) <= pfc.EPOCH_SMEM_LIMIT) == ok
    if ok:
        pfc.check_epoch_shape(k, n)
        keys, counts = pops.fish_epoch_update(
            torch.full((k,), -1, dtype=torch.int32), torch.zeros(k),
            torch.arange(n, dtype=torch.int32), alpha=0.2, max_new=64)
        assert keys.shape == counts.shape == (k,)
        assert int((keys >= 0).sum()) == min(64, k, n)
        return
    with pytest.raises(ValueError, match="one-block limit of 232,448 B"):
        pfc.check_epoch_shape(k, n)
    with pytest.raises(ValueError, match="one-block limit"):
        pops.fish_epoch_update(torch.full((k,), -1, dtype=torch.int32),
                               torch.zeros(k), torch.zeros(n,
                                                           dtype=torch.int32),
                               alpha=0.2)


@pytest.mark.parametrize("other", ["match_fn", "fused_fn"])
def test_epoch_fn_excludes_the_other_paths(other):
    st = pfish.init_fish_state(8, device="cpu")
    fn = {"match_fn": pops.fish_count,
          "fused_fn": pops.fish_epoch_count}[other]
    with pytest.raises(TypeError, match="epoch_fn"):
        pfish.epoch_update(st, torch.arange(4, dtype=torch.int32), alpha=0.2,
                           epoch_fn=pops.fish_epoch_update, **{other: fn})
    with pytest.raises(ValueError, match="ties"):
        pops.fish_epoch_update(st["keys"], st["counts"],
                               torch.arange(4, dtype=torch.int32), alpha=0.2,
                               ties="last")
