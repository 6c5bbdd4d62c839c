"""The port's keyed state against the JAX package's: the three store
backends, the device store's int32 young generation past 2^31, migration
under churn, and the merge oracle.  Integer aggregates must be exact."""

import numpy as np
import pytest

import repro.state as RS
import repro_torch.state as PS
from repro_torch.state.store import DeviceStateStore

from torch_helpers import CPU

INT32_MAX = 2 ** 31 - 1


def _fill(store, seed, rounds=2):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        store.update_batch(rng.integers(0, 300, 200), rng.integers(1, 99, 200))
    rng2 = np.random.default_rng(seed + 1)
    keys = np.unique(rng2.integers(0, 400, 50))
    store.merge_entries(keys, rng2.integers(1, 9, keys.shape[0]),
                        rng2.integers(1, 9, keys.shape[0]))


@pytest.mark.parametrize("backend", ["dict", "array", "device"])
def test_store_backends_match_reference(backend):
    mk_p = (lambda: DeviceStateStore(device=CPU)) if backend == "device" \
        else (lambda: PS.make_store(backend))
    sp, sr = mk_p(), RS.make_store(backend)
    _fill(sp, 3), _fill(sr, 3)
    for a, b in zip(sp.items(), sr.items()):
        np.testing.assert_array_equal(a, b)
    assert sp.num_entries == sr.num_entries
    assert sp.size_bytes() == sr.size_bytes()
    take = np.array([1, 5, 17], dtype=np.int64)
    take = take[np.isin(take, sr.items()[0])]
    for a, b in zip(sp.take(take), sr.take(take)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sp.items(), sr.items()):
        np.testing.assert_array_equal(a, b)


def test_device_store_young_generation_spills_past_int32():
    st = DeviceStateStore(device=CPU)
    chunk = 2 ** 30
    for _ in range(3):  # 3 * 2^30 > INT32_MAX: forces a spill
        st.merge_entries(np.array([3, 7]), np.array([chunk, chunk]),
                         np.array([chunk, chunk]))
    # key 1 sorts first: the rebuild must shift the spilled base with it
    st.merge_entries(np.array([1, 7]), np.array([5, chunk]),
                     np.array([1, chunk]))
    ks, vs, cs = st.items()
    assert ks.tolist() == [1, 3, 7]
    assert vs.tolist() == [5, 3 * chunk, 4 * chunk]
    assert cs.tolist() == [1, 3 * chunk, 4 * chunk]
    assert st._base_v.max() > INT32_MAX // 2
    vals, cnts = st.take(np.array([3]))
    assert vals.tolist() == [3 * chunk] and cnts.tolist() == [3 * chunk]
    with pytest.raises(ValueError, match="int32"):
        st.update_batch(np.array([2 ** 40]), np.array([1]))
    with pytest.raises(KeyError):
        st.take(np.array([999]))


def test_migration_under_churn_matches_reference():
    """A keyed-state manager fed the same routed chunks, with a scale-out
    and a scale-in in between, moves the same entries and bytes."""
    from repro.topology.configs import config_for as ref_config
    from repro_torch.topology.configs import config_for

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 200, 1_800)
    outs = []
    for S, cfg in ((PS, config_for), (RS, ref_config)):
        op = S.WindowOp(agg="sum", value="key", size=600, slide=300,
                        migration="migrate")
        mgr = S.KeyedStateManager(op)
        g = cfg("fg").build(6)
        for lo, members in ((0, None), (700, range(8)), (1_300, range(1, 8))):
            if members is not None:
                mgr.on_event("pre_membership", g)
                g.on_membership_change(list(members))
                mgr.on_event("post_membership", g)
            hi = {0: 700, 700: 1_300, 1_300: 1_800}[lo]
            mgr.feed(keys[lo:hi], g.assign_batch(keys[lo:hi]))
        outs.append(mgr.report("agg").summary())
    assert outs[0] == outs[1]
    assert outs[0]["migration_bytes"] > 0
    op = PS.WindowOp(agg="sum", value="key", size=600, slide=300)
    assert outs[0]["merged"] == PS.direct_aggregate(keys, op)


def test_direct_aggregate_and_topk_match_reference():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 50, 2_000)
    vals = rng.integers(1, 10, 2_000).astype(np.float64)
    for agg, value in (("sum", "payload"), ("count", "hashed"),
                       ("topk", "hashed")):
        op_p = PS.WindowOp(agg=agg, value=value, size=500, k=5)
        op_r = RS.WindowOp(agg=agg, value=value, size=500, k=5)
        assert PS.direct_aggregate(keys, op_p, values=vals) == \
            RS.direct_aggregate(keys, op_r, values=vals)


def test_merge_many_matches_per_store_merges():
    """One grouped merge over a pane — fresh and warm stores, a warm store
    meeting unseen keys, an empty chunk, and a store whose young
    generation spills past 2^31 — equals the reference package's device
    store fed one merge_entries per store."""
    rng = np.random.default_rng(11)
    big = 2 ** 30
    pre = {1: np.array([3, 9, 40]), 2: np.array([5, 6]), 4: np.array([7])}
    ours = {w: DeviceStateStore(device=CPU) for w in range(5)}
    refs = {w: RS.make_store("device") for w in range(5)}
    for w, ks in pre.items():  # warm stores
        v = np.full(ks.shape[0], big if w == 4 else 3)
        for st in (ours[w], refs[w]):
            st.merge_entries(ks, v, v)
    chunks = {0: np.array([2, 8, 11]),      # fresh
              1: np.array([3, 9, 40]),      # warm, all keys known
              2: np.array([1, 5, 70, 71]),  # warm, unseen keys
              3: np.array([], dtype=np.int64),  # empty chunk
              4: np.array([7])}             # 2^30 + 1.5 * 2^30: spills
    cols = {}
    for w, ks in chunks.items():
        n = ks.shape[0]
        v = (np.full(n, 3 * big // 2) if w == 4
             else rng.integers(-40, 40, n))
        c = np.full(n, 3 * big // 2) if w == 4 else rng.integers(1, 9, n)
        cols[w] = (ks, v, c)
    DeviceStateStore.merge_many([ours[w] for w in chunks],
                                [cols[w] for w in chunks])
    for w, (ks, v, c) in cols.items():
        refs[w].merge_entries(ks, v, c)
    for w in chunks:
        for a, b in zip(ours[w].items(), refs[w].items()):
            np.testing.assert_array_equal(a, b)
    assert ours[4].items()[1].tolist() == [5 * big // 2]
    assert ours[4]._base_v.max() > INT32_MAX // 2
    assert ours[3].num_entries == 0


#: the slab path's cases: workers, window slide (None: tumbling), and what
#: else happens — an empty chunk, a membership event between two syncs of
#: one pane, a young generation past 2^31 on a slab store
SLAB_CASES = {
    "tumbling_1": dict(workers=1),
    "tumbling_128": dict(workers=128),
    "tumbling_512": dict(workers=512),
    "sliding_128": dict(workers=128, slide=250),
    "empty_chunk": dict(workers=16, empty=3),
    "membership": dict(workers=16, event=True),
    "spill": dict(workers=16, spill=True),
}


def _sync_entries(rng, grouper, workers, start, span, empty=None, big=None):
    """One pane sync as the fused runner hands it over: per worker its
    sorted unique keys (routed by ``grouper``, else drawn for each worker),
    value and count sums, and its last stream index."""
    entries = []
    if grouper is not None:
        keys = np.unique(rng.integers(0, 5_000, 4 * len(workers)))
        owner = np.array([grouper.probe_route(int(k)) for k in keys])
        chosen = {w: keys[owner == w] for w in workers}
    for w in workers:
        if grouper is not None:
            ks = chosen[w]
        else:
            n = 0 if w == empty else int(rng.integers(1, 5))
            ks = np.sort(rng.choice(5_000, n, replace=False))
        cs = rng.integers(1, 9, ks.shape[0])
        vs = cs * rng.integers(1, 98, ks.shape[0])
        if big is not None and w == 0:
            ks, vs, cs = np.array([7]), np.array([big]), np.array([big])
        entries.append((w, ks.astype(np.int64), vs.astype(np.int64),
                        cs.astype(np.int64),
                        int(start + rng.integers(0, span))))
    return entries


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_slab_pane_syncs_match_per_store_merges(case):
    """A manager fed whole pane syncs — every store fresh, so on one slab,
    and each window read back one copy a slab — flushes the same partials
    as the reference package's device store fed one merge_entries a store:
    keys, values, counts and last index, partial for partial.  The event
    case takes keys off slab stores (``take``) and syncs the pane again
    around it; the spill case gives a slab store a young generation past
    2^31 in a pane's second sync."""
    from repro.topology.configs import config_for as ref_config
    from repro_torch.obs import Tracer
    from repro_torch.topology.configs import config_for

    cfg = SLAB_CASES[case]
    W, slide = cfg["workers"], cfg.get("slide")
    stride = slide or 1_000
    op = dict(agg="sum", size=1_000, slide=slide, backend="device")
    tracer = Tracer()
    ours = PS.KeyedStateManager(PS.WindowOp(**op), device=CPU, tracer=tracer)
    ref = RS.KeyedStateManager(RS.WindowOp(**op))
    groupers = ((config_for("fg").build(W), ref_config("fg").build(W))
                if cfg.get("event") else (None, None))
    rng = np.random.default_rng(W + stride)
    second = cfg.get("event") or cfg.get("spill")
    for pane in range(4):
        start = pane * stride
        cuts = [0, 400, stride] if pane == 1 and second else [0, stride]
        for j, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            if j and cfg.get("event"):
                for mgr, g in zip((ours, ref), groupers):
                    mgr.on_event("pre_membership", g)
                    g.on_membership_change(list(range(1, W + 2)))
                    mgr.on_event("post_membership", g)
            live = (sorted(groupers[0].active_workers)
                    if cfg.get("event") else range(W))
            big = (2 ** 30 + j * 2 ** 29 if cfg.get("spill") and pane == 1
                   else None)
            entries = _sync_entries(rng, groupers[0], live, start + lo,
                                    hi - lo, cfg.get("empty"), big)
            handed = (entries if cfg.get("empty") is not None
                      else PS.window.PaneEntries.of(entries))
            ours.feed_aggregated(hi - lo, handed)
            ref.feed_aggregated(hi - lo, entries)
    ours.finalize()
    ref.finalize()
    assert len(ours.partials) == len(ref.partials) > 0
    for a, b in zip(ours.partials, ref.partials):
        assert (a.window, a.worker, a.last_index) == \
            (b.window, b.worker, b.last_index)
        for x, y in ((a.keys, b.keys), (a.values, b.values),
                     (a.counts, b.counts)):
            np.testing.assert_array_equal(x, y)
    assert ours.migration.bytes_moved == ref.migration.bytes_moved
    merges = [s.args for s in tracer.spans if s.name == "state.merge_many"]
    fresh_syncs = merges if not second else merges[:2] + merges[3:]
    assert all(m["slab"] == m["stores"] > 0 for m in fresh_syncs)
    if second:  # the pane's second sync meets the first's stores warm
        assert merges[2]["slab"] < merges[2]["stores"]
    if cfg.get("event"):
        assert ours.migration.bytes_moved > 0
    if cfg.get("spill"):
        assert max(int(p.values.max()) for p in ours.partials) > INT32_MAX
