"""The port's scenario suite (``repro_torch.scenarios``), serving adapter
and open-loop runs against the JAX package's on the same seeds.

Host engines (``batched``, ``serving``) are held exactly: the port's row
must equal the reference's.  The fused engine (``device="cpu"``: the
kernels' plain versions) is held against the reference's fused engine on
the JAX CPU backend by ``analysis.contracts.row_violations``: SG/PKG
exact with timing within ``F32_REL``, FISH within the DESIGN.md §6
bands; remap accounting and the keyed window state exactly.
"""

import dataclasses

import numpy as np
import pytest

import repro.scenarios as RS
import repro.state as RState
import repro.topology as RT
import repro_torch.scenarios as PS
import repro_torch.state as PState
import repro_torch.topology as PT
from repro_torch.analysis.contracts import F32_REL, SCHEMES, row_violations

N, KEYS, W = 3_000, 300, 6
SCENARIOS = [s.name for s in PS.default_scenarios()]


def _pair(name, n=N, keys=KEYS, workers=W):
    p = next(s for s in PS.default_scenarios(n, keys, workers)
             if s.name == name)
    r = next(s for s in RS.default_scenarios(n, keys, workers)
             if s.name == name)
    return p, r


# ---------------------------------------------------------------------------
# compilation and the default suite
# ---------------------------------------------------------------------------


def test_default_suites_match_reference():
    for p, r in zip(PS.default_scenarios(), RS.default_scenarios()):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for p, r in zip(PS.default_open_loop_scenarios(),
                    RS.default_open_loop_scenarios()):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("name", SCENARIOS)
def test_compile_events_and_keys_match_reference(name):
    p, r = _pair(name)
    np.testing.assert_array_equal(PS.build_keys(p.workload),
                                  RS.build_keys(r.workload))
    np.testing.assert_array_equal(PS.base_capacities(p),
                                  RS.base_capacities(r))
    ep, er = PS.compile_events(p, N), RS.compile_events(r, N)
    assert [(type(e).__name__, dataclasses.asdict(e)) for e in ep] == \
        [(type(e).__name__, dataclasses.asdict(e)) for e in er]


# ---------------------------------------------------------------------------
# DSPE scenario rows: batched (exact) and fused (contracts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_batched_scenario_row_matches_reference(name, scheme):
    p, r = _pair(name)
    got = PS.run_dspe_scenario(p, scheme, feeds=3,
                               window=PState.WindowOp("count", size=1_000))
    want = RS.run_dspe_scenario(r, scheme, feeds=3,
                                window=RState.WindowOp("count", size=1_000))
    assert got == want
    assert got["state"]["exact"]
    if p.churn:
        assert got["remap_events"]


def test_one_shot_run_matches_reference():
    p, r = _pair("churn_storm")
    assert PS.run_dspe_scenario(p, "fish") == RS.run_dspe_scenario(r, "fish")


def test_reference_engine_scenario_matches_reference():
    p, r = _pair("failure_elastic", 1_500, 200, 4)
    assert PS.run_dspe_scenario(p, "pkg", engine="reference") == \
        RS.run_dspe_scenario(r, "pkg", engine="reference")


@pytest.mark.parametrize("scheme", ["sg", "pkg", "fish"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_fused_scenario_row_meets_contract(name, scheme):
    p, r = _pair(name)
    got = PS.run_dspe_scenario(p, scheme, engine="fused", feeds=3,
                               device="cpu",
                               window=PState.WindowOp("count", size=1_000))
    want = RS.run_dspe_scenario(r, scheme, engine="fused", feeds=3,
                                window=RState.WindowOp("count", size=1_000))
    assert row_violations(scheme, got, want) == []
    assert got["remap_events"] == want["remap_events"]
    assert got["remap_frac_mean"] == want["remap_frac_mean"]
    assert got["state"] == want["state"]
    assert got["state"]["exact"]


def test_fused_runners_default_to_the_card():
    """``device=None`` means ``cuda``: without a card the fused scenario
    runners raise instead of running on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    p, _ = _pair("scale_out", 1_000, 100, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.run_dspe_scenario(p, "pkg", engine="fused")
    ol = PS.default_open_loop_scenarios(rate=200.0, horizon=0.2,
                                        workers=2, num_keys=32)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.run_open_loop_scenario(ol, "pkg", engine="fused")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.run_dspe_scenario(p, "pkg", window=PState.WindowOp(
            "count", size=100, backend="device"))


# ---------------------------------------------------------------------------
# serving: run_serving_scenario and the topology adapter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["straggler_recovery", "failure_elastic",
                                  "churn_storm"])
def test_serving_scenario_matches_reference(name):
    p, r = _pair(name)
    got = PS.run_serving_scenario(
        p, "fish", num_requests=48,
        window=PState.WindowOp("count", size=16))
    want = RS.run_serving_scenario(
        r, "fish", num_requests=48,
        window=RState.WindowOp("count", size=16))
    assert got == want
    assert got["completed"] == 48
    assert got["state"]["exact"]


def test_serving_failure_scenario_elastic_continue():
    p, _ = _pair("failure_elastic")
    out = PS.run_serving_scenario(p, "fish", num_requests=60)
    assert out["completed"] == out["submitted"] == 60
    assert "rescaled" in out["policy_outcomes"]
    assert out["remap_fracs"] and max(out["remap_fracs"]) < 0.6


def test_serving_straggler_scenario_detected():
    p, _ = _pair("straggler_recovery")
    out = PS.run_serving_scenario(p, "sg", num_requests=60)
    assert out["completed"] == 60
    assert out["straggler_detected"]


def _word_count(T, scheme, fanout=2):
    return T.Topology(
        name="wc",
        stages=(T.Stage("split", 4, transform=T.hashed_fanout(fanout,
                                                              vocab=500)),
                T.Stage("count", 8)),
        edges=(T.Edge("source", "split", T.config_for("sg")),
               T.Edge("split", "count", T.config_for(scheme))))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_serving_topology_engine_matches_reference(scheme):
    from repro_torch.data.synthetic import zipf_time_evolving

    keys = zipf_time_evolving(2_000, num_keys=400, z=1.2, seed=1)
    n_count = 48 * 2

    def run(T, C):
        events = [
            T.ScopedEvent("count", C.MembershipEvent(
                at=n_count // 3, workers=tuple(range(6)))),
            T.ScopedEvent("count", C.MembershipEvent(
                at=2 * n_count // 3, workers=tuple(range(6)) + (8,))),
            T.ScopedEvent("count", C.CapacityEvent(
                at=n_count // 2, capacities={0: 4e-3})),
        ]
        eng = T.ServingTopologyEngine(max_requests=48)
        sess = eng.open(_word_count(T, scheme))
        sess.advance(events)
        src = T.Source(keys, arrival_rate=2e4)
        for b in src.iter_batches(batch_size=1_000):
            sess.feed(b)
        return sess.close()

    import repro.core as RC
    import repro_torch.core as PC

    got, want = run(PT, PC), run(RT, RC)
    assert got.to_dict() == want.to_dict()
    er = got.edge("count")
    assert len(er.remap_events) == 2
    assert sum(e.dropped for e in got.edges) == 0


# ---------------------------------------------------------------------------
# open loop
# ---------------------------------------------------------------------------


def _ol_pair(i, **kw):
    p = PS.default_open_loop_scenarios(rate=600.0, horizon=1.0, workers=2,
                                       num_keys=64)[i]
    r = RS.default_open_loop_scenarios(rate=600.0, horizon=1.0, workers=2,
                                       num_keys=64)[i]
    return dataclasses.replace(p, **kw), dataclasses.replace(r, **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("i", [0, 1])
def test_open_loop_batched_row_matches_reference(i, scheme):
    p, r = _ol_pair(i, slo_p99=0.05, max_workers=6)
    got = PS.run_open_loop_scenario(p, scheme, engine="batched")
    want = RS.run_open_loop_scenario(r, scheme, engine="batched")
    assert got == want
    assert got["identity_ok"]
    assert got["residual"] == 0


@pytest.mark.parametrize("i", [0, 1])
def test_open_loop_serving_row_matches_reference(i):
    p, r = _ol_pair(i)
    kw = dict(engine="serving", ticks_per_second=200.0,
              max_queue_per_replica=8)
    got = PS.run_open_loop_scenario(p, "fish", **kw)
    want = RS.run_open_loop_scenario(r, "fish", **kw)
    assert got == want
    assert got["identity_ok"]


@pytest.mark.parametrize("i", [0, 1])
def test_open_loop_fused_meets_contract(i):
    """PKG on the fused engine (``device="cpu"``) through the open-loop
    driver with an armed autoscaler: the same admission and autoscale
    decisions as the port's batched engine (the window p99 that triggered
    each within ``F32_REL``), the row within its contract."""
    p, _ = _ol_pair(i, slo_p99=0.05, max_workers=6)
    got = PS.run_open_loop_scenario(p, "pkg", engine="fused", device="cpu")
    want = PS.run_open_loop_scenario(p, "pkg", engine="batched")
    assert got["identity_ok"]
    for k in ("offered", "fed", "shed", "residual", "workers_final"):
        assert got[k] == want[k], k
    ga, wa = got["autoscale_events"], want["autoscale_events"]
    assert [dict(e, p99=None) for e in ga] == [dict(e, p99=None) for e in wa]
    for e, f in zip(ga, wa):
        assert e["p99"] == pytest.approx(f["p99"], rel=F32_REL)
    assert row_violations("pkg", got, want) == []


# ---------------------------------------------------------------------------
# the OpenLoopScenario cases of tests/test_load.py, on the port
# ---------------------------------------------------------------------------


def test_driver_overload_sheds_and_accounting_closes():
    ol = PS.OpenLoopScenario("t", workers=4, rate=1_500.0, horizon=2.0,
                             utilization=0.8, flash=(0.8, 0.5, 3.0),
                             num_keys=256, queue_capacity=150, policy="shed",
                             backpressure=0.25)
    r = PS.run_open_loop_scenario(ol, "fish", engine="batched", drain=True)
    assert r["identity_ok"]
    assert r["offered"] == r["fed"] + r["shed_ingress"] + r["residual"]
    assert r["shed"] > 0
    assert r["residual"] == 0
    assert r["queue_depth_peak"] <= 150
    assert r["queue_delay_p99"] > 0.0
    assert r["total_latency_p99"] >= r["latency_p99"] - 1e-9


def test_driver_no_drain_reports_residual():
    ol = PS.OpenLoopScenario("t", workers=4, rate=1_500.0, horizon=1.0,
                             utilization=0.8, flash=(0.2, 0.8, 4.0),
                             num_keys=256, queue_capacity=10_000,
                             policy="defer", backpressure=0.05)
    r = PS.run_open_loop_scenario(ol, "fish", engine="batched", drain=False)
    assert r["identity_ok"]
    assert r["residual"] > 0
    assert r["offered"] == r["fed"] + r["residual"]


def test_open_loop_autoscale_bills_migration():
    ol = PS.OpenLoopScenario("t", workers=4, rate=1_400.0, horizon=4.0,
                             utilization=0.7, flash=(1.0, 2.0, 2.5),
                             num_keys=256, queue_capacity=10**6,
                             policy="defer", backpressure=None,
                             slo_p99=0.08, max_workers=12)
    r = PS.run_open_loop_scenario(ol, "fish", engine="batched", drain=True,
                                  migration_cost_per_byte=1e-5,
                                  window=PState.WindowOp("count", size=1_000))
    assert r["autoscale_events"]
    assert r["migration_stall"] > 0.0


def test_serving_open_loop_two_level_shed_accounting():
    ol = PS.OpenLoopScenario("t", workers=4, rate=800.0, horizon=1.5,
                             utilization=0.8, flash=(0.5, 0.5, 3.0),
                             num_keys=128, queue_capacity=200, policy="shed",
                             backpressure=0.25)
    r = PS.run_open_loop_scenario(ol, "fish", engine="serving", drain=True,
                                  ticks_per_second=200.0,
                                  max_queue_per_replica=8)
    assert r["identity_ok"]
    assert r["offered"] == r["fed"] + r["shed_ingress"] + r["residual"]
    assert r["shed"] == r["shed_ingress"] + r["shed_engine"]
    assert r["residual"] == 0
    assert r["total_latency_p99"] is None


def test_default_open_loop_scenarios_run_clean():
    for ol in PS.default_open_loop_scenarios(rate=600.0, horizon=1.0,
                                             workers=2, num_keys=64):
        r = PS.run_open_loop_scenario(ol, "fish", engine="batched",
                                      drain=True)
        assert r["identity_ok"], ol.name
        assert r["residual"] == 0, ol.name
