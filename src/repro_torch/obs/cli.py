"""``python -m repro_torch.obs`` — summarize / diff / validate run traces.

Subcommands over the Chrome trace-event files this package writes:

* ``summarize FILE`` — per-span-name duration stats, counter-track
  ranges, and the embedded metrics snapshot;
* ``diff A B`` — side-by-side deltas between two traces of the *same*
  scenario (e.g. FISH vs W-Choices): span totals, counter extremes,
  metric counters;
* ``validate FILE`` — schema-check the trace (exit 1 on problems).

Zero dependencies; everything is stdlib json over the exported file.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from .export import validate_chrome_trace

__all__ = ["main", "summarize_trace", "diff_traces"]


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _span_stats(trace: Dict) -> Dict[str, Dict]:
    """name -> {count, total_ms, mean_ms, p50_ms, max_ms} over X events."""
    out: Dict[str, Dict] = {}
    durs: Dict[str, List[float]] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        s = out.setdefault(ev["name"], {"cat": ev.get("cat", ""),
                                        "count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
        d = ev.get("dur", 0.0) / 1e3
        durs.setdefault(ev["name"], []).append(d)
        s["count"] += 1
        s["total_ms"] += d
        if d > s["max_ms"]:
            s["max_ms"] = d
    for name, s in out.items():
        s["mean_ms"] = s["total_ms"] / s["count"]
        ds = sorted(durs[name])
        mid = len(ds) // 2
        s["p50_ms"] = (ds[mid] if len(ds) % 2
                       else 0.5 * (ds[mid - 1] + ds[mid]))
    return out


def _counter_stats(trace: Dict) -> Dict[str, Dict]:
    """name -> {points, min, max, last} over C events."""
    out: Dict[str, Dict] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "C":
            continue
        v = ev.get("args", {}).get("value")
        if v is None:
            continue
        s = out.get(ev["name"])
        if s is None:
            out[ev["name"]] = {"points": 1, "min": v, "max": v, "last": v}
        else:
            s["points"] += 1
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
            s["last"] = v
    return out


def summarize_trace(trace: Dict) -> Dict:
    other = trace.get("otherData", {})
    return {
        "label": other.get("label", ""),
        "n_events": len(trace.get("traceEvents", ())),
        "spans": _span_stats(trace),
        "counters": _counter_stats(trace),
        "metrics": other.get("metrics", {}),
        "instants": sum(1 for ev in trace.get("traceEvents", ())
                        if ev.get("ph") == "i"),
        "aborted": bool(other.get("aborted", False)),
    }


def _print_summary(s: Dict, out) -> None:
    head = f"trace: {s['label'] or '<unlabeled>'}"
    print(head, file=out)
    print(f"  events: {s['n_events']}  instants: {s['instants']}"
          + ("  [ABORTED RUN]" if s["aborted"] else ""), file=out)
    if s["spans"]:
        print("  spans (name: count, total ms, mean ms, p50 ms, max ms):",
              file=out)
        for name in sorted(s["spans"], key=lambda n: -s["spans"][n]["total_ms"]):
            sp = s["spans"][name]
            print(f"    {name:32s} {sp['count']:6d} {sp['total_ms']:10.2f} "
                  f"{sp['mean_ms']:9.3f} {sp['p50_ms']:9.3f} "
                  f"{sp['max_ms']:9.3f}", file=out)
    if s["counters"]:
        print("  counters (name: points, min, max, last):", file=out)
        for name in sorted(s["counters"]):
            c = s["counters"][name]
            print(f"    {name:32s} {c['points']:6d} {c['min']:10.3f} "
                  f"{c['max']:10.3f} {c['last']:10.3f}", file=out)
    if s["metrics"]:
        print("  metrics:", file=out)
        for name in sorted(s["metrics"]):
            m = s["metrics"][name]
            v = m.get("value", m.get("count"))
            print(f"    {name:40s} {v}", file=out)


def diff_traces(a: Dict, b: Dict) -> Dict:
    sa, sb = summarize_trace(a), summarize_trace(b)
    out: Dict = {"a": sa["label"], "b": sb["label"], "spans": {},
                 "counters": {}, "metrics": {}}
    for name in sorted(set(sa["spans"]) | set(sb["spans"])):
        ta = sa["spans"].get(name, {}).get("total_ms", 0.0)
        tb = sb["spans"].get(name, {}).get("total_ms", 0.0)
        out["spans"][name] = {"a_total_ms": ta, "b_total_ms": tb,
                              "delta_ms": tb - ta}
    for name in sorted(set(sa["counters"]) | set(sb["counters"])):
        ca = sa["counters"].get(name)
        cb = sb["counters"].get(name)
        out["counters"][name] = {
            "a_max": None if ca is None else ca["max"],
            "b_max": None if cb is None else cb["max"],
        }
    for name in sorted(set(sa["metrics"]) | set(sb["metrics"])):
        ma = sa["metrics"].get(name, {})
        mb = sb["metrics"].get(name, {})
        va, vb = ma.get("value"), mb.get("value")
        e = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            e["delta"] = vb - va
        out["metrics"][name] = e
    return out


def _print_diff(d: Dict, out) -> None:
    print(f"diff: a={d['a'] or '<unlabeled>'}  b={d['b'] or '<unlabeled>'}",
          file=out)
    if d["spans"]:
        print("  span totals (ms):  a, b, b-a", file=out)
        for name, e in d["spans"].items():
            print(f"    {name:32s} {e['a_total_ms']:10.2f} "
                  f"{e['b_total_ms']:10.2f} {e['delta_ms']:+10.2f}", file=out)
    if d["counters"]:
        print("  counter maxima:  a, b", file=out)
        for name, e in d["counters"].items():
            fa = "-" if e["a_max"] is None else f"{e['a_max']:.3f}"
            fb = "-" if e["b_max"] is None else f"{e['b_max']:.3f}"
            print(f"    {name:32s} {fa:>12s} {fb:>12s}", file=out)
    if d["metrics"]:
        print("  metrics:  a, b (delta)", file=out)
        for name, e in d["metrics"].items():
            extra = (f" ({e['delta']:+})" if "delta" in e else "")
            print(f"    {name:40s} {e['a']} -> {e['b']}{extra}", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize / diff / validate repro run traces")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summarize", help="per-span and counter summary")
    ps.add_argument("file")
    ps.add_argument("--json", action="store_true",
                    help="machine-readable output")
    pd = sub.add_parser("diff", help="delta between two traces")
    pd.add_argument("file_a")
    pd.add_argument("file_b")
    pd.add_argument("--json", action="store_true")
    pv = sub.add_parser("validate", help="trace-event schema check")
    pv.add_argument("file")
    args = ap.parse_args(argv)

    if args.cmd == "summarize":
        trace = _load(args.file)
        problems = validate_chrome_trace(trace)
        if problems:
            for p in problems:
                print(f"invalid trace: {p}", file=sys.stderr)
            return 1
        s = summarize_trace(trace)
        if args.json:
            print(json.dumps(s, indent=2, sort_keys=True))
        else:
            _print_summary(s, sys.stdout)
        return 0
    if args.cmd == "diff":
        d = diff_traces(_load(args.file_a), _load(args.file_b))
        if args.json:
            print(json.dumps(d, indent=2, sort_keys=True))
        else:
            _print_diff(d, sys.stdout)
        return 0
    # validate
    problems = validate_chrome_trace(_load(args.file))
    for p in problems:
        print(p, file=sys.stderr)
    print(f"{args.file}: " + ("INVALID" if problems else "ok"))
    return 1 if problems else 0
