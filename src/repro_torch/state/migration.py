"""State-migration protocol under membership churn.

When the live worker set changes mid-window, the keyed state held by
downstream operators must follow the keys:

* every entry on a worker that *left* the live set moves — to the key's
  new primary route (``grouper.probe_route``) for affinity schemes, or
  round-robin over the live set for schemes with no key affinity (SG);
* for affinity schemes, an entry held by the key's *old* primary moves to
  the new primary when the route changed (a consistent-hash ring only
  remaps keys on affected arcs, so this is a ~1/W slice per host event) —
  partials on non-primary holders (split hot keys) stay put, the
  downstream merge reconciles them.

Two policies, identical results, different cost model:

* ``migrate`` — the entry's bytes are shipped (``bytes_moved`` accounts
  ``entries × ENTRY_BYTES``);
* ``rebuild`` — the entry is discarded and its tuples replayed at the new
  owner (``tuples_replayed`` accounts the per-entry fold counts; replaying
  the same tuples reconstructs the same aggregate, so exactness holds).

Either way the moved aggregates are folded into the target worker's store,
so no contribution is lost or double counted — post-merge results stay
bit-identical to the no-churn oracle (enforced by tests/test_state.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .store import ENTRY_BYTES, make_store

__all__ = ["MigrationStats", "MigrationBiller", "apply_membership_change"]


@dataclasses.dataclass
class MigrationStats:
    """Cumulative migration cost across membership events.

    ``last_recv_entries`` / ``last_recv_replays`` are reset at the start of
    each :func:`apply_membership_change` call and record, per *target*
    worker, how many entries (migrate policy) or folded tuples (rebuild
    policy) that event shipped to it — the per-destination bill a
    :class:`MigrationBiller` converts into engine-clock stall time."""

    events: int = 0
    bytes_moved: int = 0
    entries_moved: int = 0
    tuples_replayed: int = 0
    last_recv_entries: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    last_recv_replays: Dict[int, int] = dataclasses.field(
        default_factory=dict)


class MigrationBiller:
    """Turns one membership event's migrated state into per-worker stall
    time on the engine clock (seconds for the DSPE simulator, scheduler
    ticks for the serving engine) — tick-billed migration.

    Chain :meth:`on_event` *after* the owning
    :class:`~repro_torch.state.window.KeyedStateManager`'s ``on_event`` in the
    engine's observer sequence: the manager runs the migration protocol at
    ``post_membership`` and leaves the per-target bill on
    ``stats.last_recv_*``; this observer converts it to pending charges.
    The engine interpreter then pops the charges and adds them to the
    destination workers' busy time at the event's stream position, so a
    scale-out's state transfer delays exactly the tuples that route to the
    new worker while it is still ingesting state.
    """

    def __init__(self, stats: MigrationStats, cost_per_byte: float,
                 cost_per_replay: float = 0.0):
        self.stats = stats
        self.cost_per_byte = float(cost_per_byte)
        self.cost_per_replay = float(cost_per_replay)
        self.billed_total = 0.0
        self._pending: Dict[int, float] = {}

    def on_event(self, kind: str, grouper, event=None) -> None:
        if kind != "post_membership":
            return
        for w, entries in self.stats.last_recv_entries.items():
            charge = entries * ENTRY_BYTES * self.cost_per_byte
            if charge > 0.0:
                self._pending[w] = self._pending.get(w, 0.0) + charge
        for w, replays in self.stats.last_recv_replays.items():
            charge = replays * self.cost_per_replay
            if charge > 0.0:
                self._pending[w] = self._pending.get(w, 0.0) + charge

    def pop_charges(self) -> Dict[int, float]:
        """Drain the per-worker stall accumulated since the last pop."""
        out = self._pending
        self._pending = {}
        self.billed_total += sum(out.values())
        return out


def apply_membership_change(open_windows, pre_routes: Dict[int, Optional[int]],
                            grouper, op, stats: MigrationStats,
                            device=None) -> None:
    """Run the migration protocol over every open window.

    ``pre_routes`` is the pre-event ``probe_route`` snapshot of every key
    resident in an open store; ``grouper`` has already applied the
    membership change (post-event routes and live set are read from it).
    ``device`` is where new "device"-backend target stores live.
    """
    live = sorted(grouper.active_workers)
    live_set = set(live)
    post_routes: Dict[int, Optional[int]] = {}
    rr = 0  # round-robin cursor for no-affinity (SG) entries
    stats.last_recv_entries = {}
    stats.last_recv_replays = {}
    for win in open_windows:
        for w in sorted(win.stores):
            st = win.stores[w]
            if st.num_entries == 0:
                continue
            ks, _, _ = st.items()
            if w not in live_set:
                moved_keys = ks
            else:
                sel = []
                for k in ks.tolist():
                    pre = pre_routes.get(k)
                    if pre != w:
                        continue  # this worker was not the key's primary
                    post = post_routes.get(k, _MISSING)
                    if post is _MISSING:
                        post = post_routes[k] = grouper.probe_route(k)
                    if post is not None and post != w:
                        sel.append(k)
                if not sel:
                    continue
                moved_keys = np.asarray(sel, dtype=np.int64)
            vals, cnts = st.take(moved_keys)
            targets = np.empty(moved_keys.shape[0], dtype=np.int64)
            for i, k in enumerate(moved_keys.tolist()):
                post = post_routes.get(k, _MISSING)
                if post is _MISSING:
                    post = post_routes[k] = grouper.probe_route(k)
                if post is None:  # no key affinity: spread round-robin
                    post = live[rr % len(live)]
                    rr += 1
                targets[i] = post
            for t in np.unique(targets).tolist():
                m = targets == t
                tgt = win.stores.get(t)
                if tgt is None:
                    tgt = win.stores[t] = make_store(op.backend, device)
                tgt.merge_entries(moved_keys[m], vals[m], cnts[m])
                last = win.last_idx.get(w, -1)
                if last > win.last_idx.get(t, -1):
                    win.last_idx[t] = last
                if op.migration == "migrate":
                    stats.last_recv_entries[t] = (
                        stats.last_recv_entries.get(t, 0) + int(m.sum()))
                else:
                    stats.last_recv_replays[t] = (
                        stats.last_recv_replays.get(t, 0)
                        + int(cnts[m].sum()))
            stats.entries_moved += int(moved_keys.shape[0])
            if op.migration == "migrate":
                stats.bytes_moved += int(moved_keys.shape[0]) * ENTRY_BYTES
            else:  # rebuild: discard + replay the folded tuples
                stats.tuples_replayed += int(cnts.sum())
    stats.events += 1


_MISSING = object()
