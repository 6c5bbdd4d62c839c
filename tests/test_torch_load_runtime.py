"""The port's runtime control plane and open-loop load subsystem
(``repro_torch.runtime``, ``repro_torch.load``) against the JAX package's
on the same seeds and inputs — host NumPy logic, so every comparison is
exact — plus the ``load/``-only cases of ``tests/test_load.py`` run on the
port."""

import numpy as np
import pytest

import repro.load as RL
import repro_torch.load as PL
from repro.runtime.elastic import ElasticPool as RPool
from repro.runtime.fault import HeartbeatMonitor as RMon
from repro.runtime.fault import RestartPolicy as RPolicy
from repro.runtime.stragglers import StragglerMitigator as RMit
from repro_torch.runtime.elastic import ElasticPool as PPool
from repro_torch.runtime.fault import HeartbeatMonitor as PMon
from repro_torch.runtime.fault import RestartPolicy as PPolicy
from repro_torch.runtime.stragglers import StragglerMitigator as PMit

STAGE = "worker"


# ---------------------------------------------------------------------------
# runtime/
# ---------------------------------------------------------------------------


def _pool_trace(Pool):
    keys = list(range(0, 4_000, 7))
    pool = Pool(range(8), virtual_nodes=32)
    out = [pool.hosts, [pool.owner(k) for k in keys]]
    out.append(pool.add_host(8, keys))
    out.append(pool.remove_host(3, keys))
    out.append(pool.add_host(9, keys))
    out += [pool.hosts, [pool.owner(k) for k in keys], pool.remap_log]
    return out


def test_elastic_pool_matches_reference():
    got, want = _pool_trace(PPool), _pool_trace(RPool)
    assert got == want
    # a single-host change moves a fraction of the keys, not all of them
    moved = got[2]
    assert 0 < moved < len(got[1]) // 2


def _fault_trace(Mon, Policy, max_lost_frac):
    mon = Mon(range(6), timeout=3.0)
    rescaled = []
    pol = Policy(6, max_lost_frac=max_lost_frac,
                 on_rescale=lambda alive: rescaled.append(list(alive)),
                 on_restart=lambda: 0)
    outcomes = []
    silent = {2: 4.0, 5: 7.0}  # host -> time it stops beating
    for t in np.arange(0.0, 16.0, 1.0):
        for h in range(6):
            if h not in silent or t < silent[h] or (h == 2 and t >= 12.0):
                mon.heartbeat(h, float(t))
        newly = mon.check(float(t))
        if newly:
            outcomes.append((float(t), newly, pol.handle(mon, float(t))))
    events = [(e.time, e.kind, e.host, e.detail) for e in mon.events]
    return (outcomes, events, mon.alive(), rescaled, pol.rescales,
            pol.restarts)


@pytest.mark.parametrize("max_lost_frac", [0.49, 0.2])
def test_heartbeat_and_restart_policy_match_reference(max_lost_frac):
    got = _fault_trace(PMon, PPolicy, max_lost_frac)
    assert got == _fault_trace(RMon, RPolicy, max_lost_frac)
    outcomes = got[0]
    assert outcomes  # hosts were declared dead
    assert {o for _, _, o in outcomes} <= {"rescaled", "restarted"}


def _straggler_trace(Mit):
    rng = np.random.default_rng(4)
    mit = Mit(4, interval=2.0)
    out = []
    for step in range(30):
        if step == 10:
            mit.ensure_hosts(6)
        n = 6 if step >= 10 else 4
        for h in range(n):
            slow = 4.0 if (h == 1 and 5 <= step < 20) else 1.0
            mit.record_step_time(h, slow * (1.0 + 0.05 * rng.random()))
            mit.record_assigned(h, int(rng.integers(5, 20)))
        mit.tick(float(step))
        out.append((mit.shares().tolist(), mit.waits().tolist(),
                    mit.slowest()))
    return out


def test_straggler_mitigator_matches_reference():
    got = _straggler_trace(PMit)
    assert got == _straggler_trace(RMit)
    assert any(s == 1 for _, _, s in got)  # the slow host is fingered


# ---------------------------------------------------------------------------
# load/arrivals: the same seed gives the same batches, bit for bit
# ---------------------------------------------------------------------------


def _process(L, kind, seed):
    rate = L.ConstantRate(1_500.0)
    keys = L.ZipfKeys(256, z=1.2)
    if kind == "diurnal":
        rate = rate * L.DiurnalRate(amplitude=0.6, period=2.0)
    elif kind == "flash":
        rate = rate * L.FlashCrowd(at=0.8, duration=0.6, magnitude=3.0,
                                   ramp=0.1)
    elif kind == "markov":
        rate = rate * L.MarkovModulatedRate(levels=(0.5, 2.0),
                                            mean_dwell=0.4, seed=seed)
    elif kind == "flip":
        keys = L.FlipZipfKeys(256, z=1.4, flip_time=1.0)
    elif kind == "drift":
        keys = L.ZipfKeys(256, z=1.2, drift_period=0.3, drift_step=5)
    return L.ArrivalProcess(rate, keys, tick=0.05, seed=seed)


@pytest.mark.parametrize("kind", ["constant", "diurnal", "flash", "markov",
                                  "flip", "drift"])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_match_reference_bit_for_bit(kind, seed):
    got = list(_process(PL, kind, seed).batches(0.0, 2.0))
    want = list(_process(RL, kind, seed).batches(0.0, 2.0))
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g.keys.dtype == w.keys.dtype
        np.testing.assert_array_equal(g.keys, w.keys)
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
    assert _process(PL, kind, seed).offered(0.0, 2.0) == \
        _process(RL, kind, seed).offered(0.0, 2.0)


def test_arrivals_deterministic_and_rate_accurate():
    ap = PL.ArrivalProcess(PL.ConstantRate(2_000.0), PL.ZipfKeys(256),
                           tick=0.05, seed=7)
    b1 = list(ap.batches(0.0, 2.0))
    b2 = list(PL.ArrivalProcess(PL.ConstantRate(2_000.0), PL.ZipfKeys(256),
                                tick=0.05, seed=7).batches(0.0, 2.0))
    assert len(b1) == len(b2) == 40
    for x, y in zip(b1, b2):
        np.testing.assert_array_equal(x.keys, y.keys)
        np.testing.assert_array_equal(x.timestamps, y.timestamps)
    n = sum(len(b) for b in b1)
    assert abs(n - 4_000) < 350  # Poisson(4000): 5 sigma ≈ 316
    for b in b1:
        assert np.all(np.diff(b.timestamps) >= 0)


def test_arrivals_timestamps_live_in_their_tick():
    ap = PL.ArrivalProcess(PL.ConstantRate(500.0), PL.ZipfKeys(64),
                           tick=0.1, seed=0)
    for i, b in enumerate(ap.batches(0.0, 1.0)):
        if len(b):
            assert b.timestamps.min() >= i * 0.1 - 1e-9
            assert b.timestamps.max() <= (i + 1) * 0.1 + 1e-9


def test_flash_crowd_multiplies_rate_inside_window():
    flash = PL.ConstantRate(1_000.0) * PL.FlashCrowd(
        at=10.0, duration=5.0, magnitude=4.0, ramp=0.0)
    assert flash(5.0) == pytest.approx(1_000.0)
    assert flash(12.0) == pytest.approx(4_000.0)
    assert flash(16.0) == pytest.approx(1_000.0)


def test_diurnal_rate_oscillates_and_stays_nonnegative():
    r = PL.ConstantRate(100.0) * PL.DiurnalRate(amplitude=1.0, period=10.0)
    vals = np.array([r(t) for t in np.linspace(0, 10, 101)])
    assert vals.min() == pytest.approx(0.0, abs=1e-9)
    assert vals.max() == pytest.approx(200.0, rel=0.01)
    assert r(0.0) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        PL.DiurnalRate(amplitude=1.5)


def test_markov_modulated_rate_is_deterministic_per_seed():
    r1 = PL.MarkovModulatedRate(levels=(0.5, 2.0), mean_dwell=1.0, seed=3)
    r2 = PL.MarkovModulatedRate(levels=(0.5, 2.0), mean_dwell=1.0, seed=3)
    ts = np.linspace(0, 20, 41)
    assert [r1(t) for t in ts] == [r2(t) for t in ts]
    assert {r1(t) for t in ts} <= {0.5, 2.0}


def test_flip_zipf_changes_hot_set_at_flip_time():
    fk = PL.FlipZipfKeys(128, z=1.5, flip_time=5.0)
    rng = np.random.default_rng(0)
    pre = fk.sample(4_000, 1.0, rng)
    post = fk.sample(4_000, 6.0, rng)
    assert np.bincount(pre, minlength=128).argmax() != \
        np.bincount(post, minlength=128).argmax()


# ---------------------------------------------------------------------------
# load/admission: offered == fed + shed + residual, at every step
# ---------------------------------------------------------------------------


def _queue_trace(L, policy):
    q = L.IngressQueue(capacity=150, policy=policy, seed=3)
    rng = np.random.default_rng(0)
    out = []
    for i in range(20):
        keys = rng.integers(0, 64, 100).astype(np.int32)
        q.offer(keys, np.full(100, float(i)))
        assert q.check_identity()
        if i % 3 == 2:
            k, ts, _ = q.pop(90)
            out.append((k.tolist(), ts.tolist()))
            assert q.check_identity()
    while len(q):
        k, ts, _ = q.pop(37)
        out.append((k.tolist(), ts.tolist()))
        assert q.check_identity()
    return out, q.stats.as_dict(), q.residual


@pytest.mark.parametrize("policy", sorted(PL.POLICIES))
def test_admission_matches_reference(policy):
    got = _queue_trace(PL, policy)
    assert got == _queue_trace(RL, policy)
    s = got[1]
    assert s["offered"] == 2_000
    assert s["offered"] == s["fed"] + s["shed"] + got[2]


def _offer_ticks(q, n_ticks=20, per_tick=100, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_ticks):
        keys = rng.integers(0, 64, per_tick).astype(np.int32)
        q.offer(keys, np.full(per_tick, float(i)))
        assert q.check_identity()


@pytest.mark.parametrize("policy", ["shed", "defer", "degrade"])
def test_admission_identity_holds_under_overload(policy):
    q = PL.IngressQueue(capacity=150, policy=policy)
    _offer_ticks(q)
    while len(q):
        q.pop(37)
        assert q.check_identity()
    s = q.stats
    assert s.offered == 2_000
    assert s.fed + s.shed == 2_000
    if policy == "defer":
        assert s.shed == 0 and s.deferred > 0
    else:
        assert s.shed > 0


@pytest.mark.parametrize("policy", ["shed", "degrade"])
def test_bounded_queue_never_exceeds_capacity(policy):
    q = PL.IngressQueue(capacity=150, policy=policy)
    _offer_ticks(q)
    assert len(q) <= 150
    assert q.stats.queue_depth_peak <= 150


def test_degrade_thins_uniformly():
    q = PL.IngressQueue(capacity=500, policy="degrade", seed=1)
    q.offer(np.arange(2_000, dtype=np.int32) % 64, np.zeros(2_000))
    got, _, _ = q.pop(500)
    assert got.shape[0] == 500
    assert np.unique(got).shape[0] > 50


def test_pop_is_fifo_and_returns_arrival_timestamps():
    q = PL.IngressQueue(capacity=10, policy="defer")
    q.offer(np.array([1, 2], dtype=np.int32), np.array([0.25, 0.5]))
    q.offer(np.array([3], dtype=np.int32), np.array([0.75]))
    keys, arrivals, _ = q.pop(3)
    np.testing.assert_array_equal(keys, [1, 2, 3])
    np.testing.assert_allclose(arrivals, [0.25, 0.5, 0.75])


# ---------------------------------------------------------------------------
# load/autoscale
# ---------------------------------------------------------------------------


class _Receipt:
    def __init__(self, lats):
        self.latencies = lats


def _scaler_trace(L):
    a = L.P99Autoscaler(STAGE, slo_p99=0.1, workers=range(3),
                        max_workers=7, window=1.0, cooldown=0.5,
                        min_samples=8, sample_keys=range(200))
    rng = np.random.default_rng(2)
    emitted = []
    for i in range(60):
        level = 0.3 if 10 <= i < 30 else 0.01
        evs = a.observe(0.1 * i, _Receipt(level * rng.random(16)))
        emitted += [(e.stage, e.event.workers, e.event.at_time)
                    for e in evs]
    return emitted, a.events, a.workers, a.pool.remap_log


def test_autoscaler_matches_reference():
    got = _scaler_trace(PL)
    assert got == _scaler_trace(RL)
    assert any(e["action"] == "scale_out" for e in got[1])
    assert any(e["action"] == "scale_in" for e in got[1])


def test_autoscaler_never_drops_below_initial_pool():
    a = PL.P99Autoscaler(STAGE, slo_p99=10.0, workers=range(4),
                         max_workers=8, window=1.0, cooldown=0.0,
                         min_samples=1)
    for i in range(50):
        a.observe(float(i), _Receipt(np.full(64, 1e-6)))
    assert a.workers == [0, 1, 2, 3]
    assert not a.events


def test_autoscaler_waits_for_min_samples_and_cooldown():
    a = PL.P99Autoscaler(STAGE, slo_p99=0.1, workers=range(2),
                         max_workers=8, window=100.0, cooldown=5.0,
                         min_samples=64)
    hot = _Receipt(np.full(10, 99.0))
    assert a.observe(0.0, hot) == []
    emitted = []
    for i in range(1, 8):
        emitted += a.observe(float(i) * 0.1, hot)
    assert len(emitted) == 1
    assert a.observe(0.8, hot) == []
    assert a.events[0]["action"] == "scale_out"


def test_autoscaler_new_worker_ids_are_never_reused():
    a = PL.P99Autoscaler(STAGE, slo_p99=0.1, workers=range(2),
                         max_workers=4, window=1.0, cooldown=0.0,
                         min_samples=1)
    hot, cold = _Receipt(np.full(8, 9.0)), _Receipt(np.full(8, 1e-9))
    a.observe(0.0, hot)
    a.observe(1.0, hot)
    a.observe(2.0, cold)
    a.observe(3.0, hot)
    assert [e["worker"] for e in a.events] == [2, 3, 3, 4]
    assert a.workers == [0, 1, 2, 4]


def test_autoscaler_scales_out_on_step_and_converges():
    """tests/test_load.py's step response, on the port's batched engine:
    scale-out on a sustained 1.5x step, then quiet and back under the SLO
    over the final quarter."""
    import repro_torch.topology as T

    horizon, slo = 14.0, 0.1
    rate = PL.ConstantRate(1_000.0) * PL.FlashCrowd(
        at=2.0, duration=horizon, magnitude=1.5, ramp=0.0)
    ap = PL.ArrivalProcess(rate, PL.ZipfKeys(256, z=1.2), tick=0.05, seed=0)
    topo = T.Topology(name="t",
                      stages=(T.Stage(STAGE, parallelism=4, cost=0.0028),),
                      edges=(T.Edge("source", STAGE, T.config_for("fish")),))
    sess = T.SimulatorEngine(mode="batched").open(topo, arrival_rate=1_000.0)
    scaler = PL.P99Autoscaler(STAGE, slo_p99=slo, workers=range(4),
                              max_workers=16, window=0.5, cooldown=1.0,
                              sample_keys=range(256))
    drv = PL.OpenLoopDriver(sess, PL.IngressQueue(10**6, policy="defer"),
                            autoscaler=scaler)
    drv.run(ap, 0.0, horizon, drain=True)
    events = scaler.events
    assert events and all(e["action"] == "scale_out" for e in events)
    assert events[0]["p99"] > slo
    assert 4 < len(scaler.workers) < 16
    assert all(e["t"] < 0.75 * horizon for e in events), events
    assert scaler.window_p99() is not None
    assert scaler.window_p99() <= slo


def test_fish_stream_config_matches_reference():
    import dataclasses

    from repro.configs.fish_stream import CONFIG as RCONFIG
    from repro_torch.configs.fish_stream import CONFIG

    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(RCONFIG)
    assert CONFIG.num_workers == 128 and CONFIG.virtual_nodes == 64
