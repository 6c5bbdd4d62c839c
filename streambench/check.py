"""The comparison that decides ``correct``: what the timed path produced,
held against :mod:`reference`.

For each sampled feed the reference starts from the session's state before
the feed, as the program left it (the first feed of the first cycle starts
from the reference's own fresh state), routes and times the feed, and is
compared with the program's workers, finish times and state after the
feed.  The FISH estimator's capacities are worked out independently from
the stream position.  The first cycle's close report is compared with the
reference's windows (every window, every key), and with its imbalance,
makespan and memory overhead after the cycle's last feed.

Each number has a limit (``LIMITS``; a configuration may give its own
under ``"limits"``).  A number over its limit makes the run incorrect.
"""

from __future__ import annotations

import numpy as np

import reference as R

__all__ = ["LIMITS", "edge_model", "compare", "check_lines"]

#: the limit of each compared number: counts of disagreeing items are
#: exact (0); gaps are in seconds (clocks) or relative (tracker, estimator)
LIMITS = {
    "route_mismatch": 0,          # tuples whose worker differs
    "finish_gap_s": 1e-9,         # max |finish - reference|, s
    "busy_gap_s": 1e-9,           # max |worker busy-until - reference|, s
    "count_mismatch": 0,          # workers whose tuple count differs
    "feed_p99_gap_s": 1e-9,       # |feed receipt latency p99 - reference|
    "tracker_gap": 1e-6,          # max relative gap of a key's frequency
    "chk_mismatch": 0,            # keys whose CHK memory M differs
    "estimator_gap": 0,           # max relative gap of backlog / assigned
    "capacity_gap": 1e-12,        # max relative gap of sampled capacities
    "hot_set_diff": 0,            # keys in one hot set and not the other
    "window_mismatch": 0,         # (window, key) sums or counts that differ
    "imbalance_gap": 0,           # |report imbalance - reference|
    "makespan_gap_s": 1e-9,       # |report execution time - reference|
    "memory_overhead_diff": 0,    # |report memory overhead - reference|
}


def edge_model(config: dict, scheme: str, stream, ring: R.Ring,
               feed: int, precision: R.Precision = R.Precision()):
    if scheme not in ("fg", "fish"):
        raise ValueError(f"the reference routes fg and fish, not {scheme!r}")
    eng = config["engine"]
    g = config["groupings"][scheme]
    fish = {k: g[k] for k in ("alpha", "epoch", "theta_frac", "d_min",
                              "interval")} if scheme == "fish" else {}
    return R.EdgeModel(
        scheme=scheme, workers=int(config["workers"]), ring=ring,
        key_rows=int(config["stream"]["keys"]),
        rate=R.session_rate(stream.times[:feed],
                            float(config["stream"]["arrival_rate"])),
        utilization=float(eng["utilization"]),
        sample_every=int(eng["sample_every"]),
        sample_noise=float(eng["sample_noise"]),
        engine_seed=int(eng.get("seed", 0)),
        stride=int(config["window"]["size"]), precision=precision, **fish)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def _gap(a, b) -> float:
    """Max |a - b|; inf where the two differ in length."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _mismatch(a, b) -> int:
    """Entries that differ; every entry of the longer where the lengths
    differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def _state_numbers(out: dict, model, prog: dict, ref: dict) -> None:
    out["busy_gap_s"] = max(out["busy_gap_s"],
                            _gap(prog["busy"], ref["busy"]))
    out["count_mismatch"] += _mismatch(prog["counts"], ref["counts"])
    if model.scheme != "fish":
        return
    n = min(prog["trk"].shape[0], ref["trk"].shape[0])
    out["tracker_gap"] = max(out["tracker_gap"],
                             _rel(prog["trk"][:n], ref["trk"][:n]),
                             _rel(prog["carry"], ref["carry"]))
    out["chk_mismatch"] += _mismatch(prog["mk"][:n], ref["mk"][:n])
    out["estimator_gap"] = max(out["estimator_gap"],
                               _rel(prog["bl"], ref["bl"]),
                               _rel(prog["asn"], ref["asn"]),
                               float(prog["t_prior"] != ref["t_prior"]))
    hp = R.hot_set(prog["trk"], float(prog["carry"][0]), model.workers,
                   model.theta_frac)
    hr = R.hot_set(ref["trk"], float(ref["carry"][0]), model.workers,
                   model.theta_frac)
    out["hot_set_diff"] += int(np.setxor1d(hp, hr).shape[0])


def compare(config: dict, scheme: str, stream, rec: dict, feed: int,
            precision: R.Precision = R.Precision()) -> dict:
    """Every compared number of one run (see ``LIMITS``), and the number
    of feeds compared (``samples``).  ``precision`` below the stated one
    computes the control in the program's place."""
    ring = R.Ring(int(config["workers"]),
                  int(config["groupings"][scheme]["virtual_nodes"]))
    model = edge_model(config, scheme, stream, ring, feed)
    low = edge_model(config, scheme, stream, ring, feed, precision)
    out = {k: 0 * v for k, v in LIMITS.items()}  # ints stay ints
    out["samples"] = 0
    lowered = precision != R.Precision()
    last = None
    for s in rec["samples"]:
        lo = s["k"] * feed
        keys = stream.keys[lo:lo + feed]
        times = stream.times[lo:lo + feed]
        pre = s["pre"]
        if pre is None:
            pre = model.fresh()
        elif scheme == "fish":
            off = pre["offset"]
            ecap = low.estimator_capacities(off) if lowered else pre["ecap"]
            out["capacity_gap"] = max(
                out["capacity_gap"],
                _rel(ecap, model.estimator_capacities(off)))
        model.from_state(pre)
        workers, fin = model.feed(keys, times)
        s["ref_segments"] = model.segments
        if lowered:  # the control in the program's place
            low.from_state(pre)
            p_workers, p_fin = low.feed(keys, times)
            p_post = low.state
            p99 = float(np.percentile(p_fin - times, 99))
        else:
            p_workers, p_fin = s["workers"], times[0] + s["finish"]
            p_post = s["post"]
            p99 = s["latency_p99"]
        out["route_mismatch"] += _mismatch(p_workers, workers)
        out["finish_gap_s"] = max(out["finish_gap_s"], _gap(p_fin, fin))
        out["feed_p99_gap_s"] = max(
            out["feed_p99_gap_s"],
            abs(p99 - float(np.percentile(fin - times, 99))))
        _state_numbers(out, model, p_post, model.state)
        out["samples"] += 1
        if s["last"]:
            last = (s, model.state, workers, p_post, p_workers)
    rep = rec["report0"]
    if rep is None:
        return out
    out["window_mismatch"] = _windows(config, stream, rep, rec["partials0"])
    if last is None:
        return out
    s, ref, workers, p_post, p_workers = last
    lo = s["k"] * feed
    base = (s["pre"]["repl"] if s["pre"] is not None else
            np.zeros((int(config["stream"]["keys"]), int(config["workers"])),
                     bool))

    def pairs(w):  # replica pairs after the cycle's last feed
        repl = base.copy()
        repl[stream.keys[lo:lo + feed], w] = True
        return int(repl.sum())

    e = rep.edges[0]
    if lowered:  # the close report the control's state would give
        got = (R.imbalance(p_post["counts"]), float(p_post["busy"].max()),
               pairs(p_workers))
    else:
        got = (e.imbalance, e.execution_time, int(e.memory_overhead))
    out["imbalance_gap"] = abs(got[0] - R.imbalance(ref["counts"]))
    out["makespan_gap_s"] = abs(got[1] - float(ref["busy"].max()))
    out["memory_overhead_diff"] = abs(got[2] - pairs(workers))
    return out


def _windows(config, stream, rep, partials) -> int:
    """(window, key) entries whose sum or count differs from the
    reference's, or that one side lacks."""
    size = int(config["window"]["size"])
    ref = R.window_aggregates(stream.keys, stream.values, size)
    merged = rep.state["agg"]["merged"]
    counts = {}
    for p in partials:
        counts.setdefault(int(p.window), []).append(p)
    bad = 0
    for w, (rk, rs, rc) in ref.items():
        got = merged.get(w, {})
        pk = np.fromiter(got.keys(), np.int64, len(got))
        ps = np.fromiter(got.values(), np.int64, len(got))
        order = np.argsort(pk)
        pk, ps = pk[order], ps[order]
        parts = counts.get(w, [])
        ck = np.concatenate([p.keys for p in parts]) if parts else \
            np.empty(0, np.int64)
        cv = np.concatenate([p.counts for p in parts]) if parts else \
            np.empty(0, np.int64)
        uk, inv = np.unique(ck, return_inverse=True)
        pc = np.zeros(uk.shape[0], np.int64)
        np.add.at(pc, inv, cv)
        if pk.shape != rk.shape or uk.shape != rk.shape:
            bad += abs(pk.shape[0] - rk.shape[0]) + abs(uk.shape[0]
                                                        - rk.shape[0])
            continue
        bad += int(((pk != rk) | (ps != rs) | (uk != rk) | (pc != rc)).sum())
    bad += len(set(merged) - set(ref))
    return bad


def check_lines(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) in ``LIMITS`` order."""
    # JSON has no infinity: a gap that could not be taken reads 1e308
    table = {k: {"value": min(numbers[k], 1e308), "limit": limits[k]}
             for k in LIMITS}
    ok = numbers["samples"] > 0 and all(
        v["value"] <= v["limit"] for v in table.values())
    return ok, table
