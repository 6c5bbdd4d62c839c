"""Chrome trace-event JSON export (Perfetto-loadable) + streaming writer.

The export target is the `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
object form: ``{"traceEvents": [...], "otherData": {...}}``.  We emit

* ``M`` metadata events naming the process and one thread lane per span
  category (``fused``, ``session``, ``load``, …);
* ``X`` complete events for spans (``ts``/``dur`` in microseconds since
  trace start);
* ``i`` instant events (autoscaler actions, membership events, FISH
  decay);
* ``C`` counter events for every timeline series — each becomes a
  Perfetto counter track with a single ``value`` series.  The full
  ``(wall_time, engine_clock, feed_idx, epoch_idx)`` coordinates stay in
  the report timeline / ``repro_torch.obs summarize``; counter tracks stay
  clean.

:class:`TraceWriter` is the crash-safe file form: events stream into a
sibling ``.tmp`` and only an explicit ``close()``/``abort()`` renames the
finished, *valid* JSON into place — a benchmark that dies mid-run flushes
what it has instead of leaving a truncated file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ["chrome_trace", "validate_chrome_trace", "TraceWriter"]

PID = 1
_PHASES = frozenset("XBEiCM")


def chrome_trace(tel) -> Dict:
    """Render a :class:`~repro_torch.obs.telemetry.Telemetry` bundle as one
    Chrome trace-event object."""
    tr = tel.tracer
    events: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": f"repro {tel.label}".strip()},
    }]
    tids: Dict[str, int] = {}

    def tid_for(cat: str) -> int:
        t = tids.get(cat)
        if t is None:
            t = tids[cat] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": PID,
                           "tid": t, "args": {"name": cat}})
        return t

    for sp in tr.spans:
        ev = {"name": sp.name, "cat": sp.cat, "ph": "X",
              "ts": tr.rel_us(sp.t0), "dur": max((sp.t1 - sp.t0) * 1e6, 0.0),
              "pid": PID, "tid": tid_for(sp.cat)}
        if sp.args:
            ev["args"] = sp.args
        events.append(ev)
    for t, name, cat, args in tr.instants:
        ev = {"name": name, "cat": cat, "ph": "i", "ts": tr.rel_us(t),
              "pid": PID, "tid": tid_for(cat), "s": "p"}
        if args:
            ev["args"] = args
        events.append(ev)
    for name, pts in tel.timeline.series.items():
        for wall, _clock, _feed, _epoch, value in pts:
            events.append({"name": name, "cat": "timeline", "ph": "C",
                           "ts": wall * 1e6, "pid": PID,
                           "args": {"value": value}})
    events.sort(key=lambda e: (e.get("ts", -1.0), e["ph"] != "M"))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "label": tel.label,
            "trace_start_wall": getattr(tr, "wall0", 0.0),
            "metrics": tel.metrics.snapshot(),
            "timeline": tel.timeline.export(),
        },
    }


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for the export above (and anything Perfetto would
    choke on).  Returns a list of problems — empty means valid."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing 'traceEvents' list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"{where}: missing integer pid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"{where}: {ph}-event missing numeric ts")
            elif ts < 0:
                problems.append(f"{where}: negative ts {ts}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X-event needs dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"{where}: C-event needs non-empty args")
            elif not all(isinstance(v, (int, float))
                         for v in args.values()):
                problems.append(f"{where}: C-event args must be numeric")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    return problems


class TraceWriter:
    """Streaming trace-event file that is *always* valid JSON once closed.

    Events append to ``<path>.tmp``; ``close()`` seals the array, writes
    ``otherData``, and renames into place.  ``abort()`` is ``close()``
    with an ``aborted`` stamp — the failure path flushes instead of
    truncating.  Idempotent: double close/abort is a no-op.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._tmp = f"{path}.tmp"
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self._tmp, "w")
        self._f.write('{"traceEvents": [')
        self._n = 0
        self.closed = False

    def write_event(self, ev: Dict) -> None:
        if self.closed:
            raise ValueError(f"TraceWriter({self.path}) already closed")
        if self._n:
            self._f.write(",\n")
        json.dump(ev, self._f)
        self._n += 1

    def write_telemetry(self, tel) -> None:
        """Append a whole bundle's events (spans, instants, counters)."""
        for ev in chrome_trace(tel)["traceEvents"]:
            self.write_event(ev)

    def close(self, other_data: Optional[Dict] = None,
              aborted: bool = False) -> Optional[str]:
        if self.closed:
            return None
        self.closed = True
        other = dict(other_data or {})
        if aborted:
            other["aborted"] = True
        self._f.write('], "displayTimeUnit": "ms", "otherData": ')
        json.dump(other, self._f)
        self._f.write("}")
        self._f.flush()
        self._f.close()
        os.replace(self._tmp, self.path)
        return self.path

    def abort(self, reason: str = "") -> Optional[str]:
        """Seal whatever was written so far as valid JSON (failure path)."""
        return self.close({"abort_reason": reason} if reason else None,
                          aborted=True)

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is None:
            self.close()
        else:
            self.abort(reason=str(exc_type.__name__))
        return False
