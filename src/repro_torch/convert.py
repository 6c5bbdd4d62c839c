"""Carry a stream started in the JAX package over into the port.

:func:`runner_from_reference` takes the live objects of a reference fused
edge — its ``FusedEdgeRunner``, grouper and ``EdgeState`` — reads them as
numpy (``np.asarray`` on a JAX array needs no JAX import here) and builds
the port's grouper, ``EdgeState`` and runner around the same state: the
device tracker, CHK memory, replica matrix and open pane (its dense
table's nonzero cells, inserted into the port's compact pane table), the
ring table and hash cache, per-worker counts, the round-robin cursor, the
estimator and the FIFO backlog.  :func:`manager_from_reference` does the
same for the edge's keyed window state (the host ``KeyedStateManager``
and its per-worker stores).  Feeding the returned state, and manager as
``state_sink``, to ``repro_torch.core.simulate_edge(mode="fused")``
continues the stream.

Two more carry state and weights over: :func:`fish_state_from_reference`
turns the reference's device ``FishState`` (the bounded epoch table) into
the port's, and :func:`model_params_from_reference` maps the reference's
model parameter pytree onto the port's modules, so that both packages
compute from the same weights.  :func:`opt_state_from_reference` and
:func:`train_state_from_reference` carry a whole train state: the
parameters, the AdamW ``OptState`` (step, m and v, a factored v's
``r``/``c`` included) and the MoE hotness.

Only attributes and numpy arrays are read: this module imports nothing of
the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .core.assignment import WorkerStateEstimator
from .core.baselines import (DChoices, FieldGrouping, FishGrouper,
                             PartialKeyGrouping, ShuffleGrouping, WChoices)
from .core.chash import ConsistentHashRing
from ._device import resolve_device
from .core.fish import EpochFrequencyTracker, FishParams, FishState
from .core.stream import EdgeState
from .kernels.feed_fused import (FusedEdgeRunner, _u32_bits,
                                 pane_capacity, pane_from_entries)
from .state.migration import MigrationStats
from .state.store import make_store
from .state.window import KeyedStateManager, WindowOp, WindowPartial, _Pane

__all__ = ["grouper_from_reference", "state_from_reference",
           "runner_from_reference", "manager_from_reference",
           "fish_state_from_reference", "model_params_from_reference",
           "opt_state_from_reference", "train_state_from_reference"]

_CLASSES = {"sg": ShuffleGrouping, "fg": FieldGrouping,
            "pkg": PartialKeyGrouping, "dc": DChoices, "wc": WChoices,
            "fish": FishGrouper}


def _ring(ref) -> ConsistentHashRing:
    ring = ConsistentHashRing((), virtual_nodes=ref.virtual_nodes)
    ring._points = list(ref._points)
    ring._owner = dict(ref._owner)
    ring._workers = {w: list(ps) for w, ps in ref._workers.items()}
    return ring


def _params(ref) -> FishParams:
    return FishParams(alpha=ref.alpha, epoch=ref.epoch, k_max=ref.k_max,
                      theta_frac=ref.theta_frac, d_min=ref.d_min)


def _tracker(ref) -> EpochFrequencyTracker:
    trk = EpochFrequencyTracker(_params(ref.params))
    trk.counts = dict(ref.counts)
    trk._tuples_in_epoch = ref._tuples_in_epoch
    trk.total_seen = ref.total_seen
    trk.epochs_completed = ref.epochs_completed
    return trk


def grouper_from_reference(ref):
    """A port grouper holding the reference grouper's routing state."""
    name = ref.name
    w = ref.num_workers
    if name == "sg":
        g = ShuffleGrouping(w)
        g._rr = int(ref._rr)
    elif name in ("fg", "pkg"):
        g = _CLASSES[name](w, virtual_nodes=ref.ring.virtual_nodes)
    elif name in ("dc", "wc"):
        g = _CLASSES[name](w, k_max=ref.tracker.params.k_max,
                           theta_frac=ref.theta_frac)
        g.tracker = _tracker(ref.tracker)
    elif name == "fish":
        est = ref.estimator
        g = FishGrouper(w, params=_params(ref.params),
                        capacities=np.asarray(est.capacities),
                        interval=est.interval,
                        virtual_nodes=ref.ring.virtual_nodes,
                        use_consistent_hash=ref.use_consistent_hash)
        g.tracker = _tracker(ref.tracker)
        g.m_k = dict(ref.m_k)
        g.estimator = WorkerStateEstimator(
            capacities=np.array(est.capacities, dtype=np.float64),
            interval=est.interval)
        g.estimator.backlog = np.array(est.backlog, dtype=np.float64)
        g.estimator.assigned = np.array(est.assigned, dtype=np.float64)
        g.estimator._t_prior = est._t_prior
        g._mod_cands = {k: list(v) for k, v in ref._mod_cands.items()}
    else:
        raise ValueError(f"no port grouper for scheme {name!r}")
    g.num_workers = w
    g.replicas = {k: set(v) for k, v in ref.replicas.items()}
    g.assigned_counts = np.array(ref.assigned_counts, dtype=np.int64)
    g._active = list(ref._active)
    if ref.ring is not None:
        g.ring = _ring(ref.ring)
    g._ring_order = {k: list(v) for k, v in ref._ring_order.items()}
    return g


def state_from_reference(ref) -> EdgeState:
    """The port's ``EdgeState`` for a reference one (device left unset):
    FIFO backlog, capacities, live set, the sampling rng's exact position
    and the stream offset."""
    rng = np.random.Generator(type(ref.rng.bit_generator)())
    rng.bit_generator.state = copy.deepcopy(ref.rng.bit_generator.state)
    return EdgeState(busy_until=np.array(ref.busy_until, dtype=np.float64),
                     capacities=np.array(ref.capacities, dtype=np.float64),
                     active=set(ref.active), rng=rng, offset=ref.offset)


def runner_from_reference(ref_runner, ref_grouper, ref_state, sink=None,
                          telemetry=None, device=None):
    """Rebuild a reference fused edge in the port.

    Returns ``(grouper, state)``; ``state.device`` is a port
    :class:`~repro_torch.kernels.feed_fused.FusedEdgeRunner` on ``device``
    (``None`` = ``"cuda"``) holding the reference runner's device tables.
    ``sink`` is the port-side keyed-state sink of the edge, if it has one
    (:func:`manager_from_reference` converts the reference's); the open
    device pane is carried."""
    grouper = grouper_from_reference(ref_grouper)
    state = state_from_reference(ref_state)
    run = FusedEdgeRunner(grouper, state, sink, telemetry=telemetry,
                          device=device)
    dev = run.device
    up = (lambda a: torch.from_numpy(np.array(a)).to(dev))
    run._kcap = int(ref_runner._kcap)
    run._w1 = int(ref_runner._w1)
    run.pane_fed = int(ref_runner.pane_fed)
    run._hash_arr = np.array(ref_runner._hash_arr, dtype=np.uint32)
    run._hash_ok = np.array(ref_runner._hash_ok, dtype=bool)
    run._hash_dirty = True
    run._prev_hot = set(ref_runner._prev_hot)
    run._fish_epoch_idx = ref_runner._fish_epoch_idx
    run._fish_epochs_crossed = ref_runner._fish_epochs_crossed
    run.refresh_membership(grouper, state)
    if ref_runner._pts is not None:
        # the reference's own table (same ring, so the same rows)
        run._pts = np.array(ref_runner._pts, dtype=np.uint32)
        run._cands = np.array(ref_runner._cands, dtype=np.int32)
        run._pts_dev = up(_u32_bits(run._pts))
        run._cands_dev = up(run._cands)
    trk = np.asarray(ref_runner.trk, dtype=np.float32)
    run.trk = up(trk)
    # the tracker's carried total (a float32 sum) and max
    run.trk_carry = up(np.asarray(
        [trk.sum(dtype=np.float32), trk.max(initial=0.0)], dtype=np.float32))
    run.m_k = up(np.asarray(ref_runner.m_k, dtype=np.int32))
    run.repl = up(np.asarray(ref_runner.repl, dtype=bool))
    run._repl_synced = up(np.asarray(ref_runner._repl_synced, dtype=bool))
    run._repl_dirty = bool(ref_runner._repl_dirty)
    if run.has_pane and run.pane_fed and ref_runner.pane_tab is not None:
        # the reference's dense worker-major (w1, kcap1, 2) pane: its
        # nonzero cells, inserted into a compact table with their value
        # and count
        tab = np.asarray(ref_runner.pane_tab, dtype=np.int32)
        ws, ks = np.nonzero(tab[:, :, 1])
        run.pane_keys, run.pane_vc = pane_from_entries(
            up((ws.astype(np.int64) << 32) | ks.astype(np.int64)),
            up(tab[ws, ks, 0]), up(tab[ws, ks, 1]),
            pane_capacity(run.pane_fed))
        run.pane_last = up(np.asarray(ref_runner.pane_last, dtype=np.int32))
    state.device = run
    return grouper, state


def manager_from_reference(ref, device=None) -> KeyedStateManager:
    """The port's ``KeyedStateManager`` holding a reference manager's
    keyed window state: open panes (each per-worker store refilled from
    its ``items()``, so any backend converts), flushed partials, migration
    totals and the byte/key bookkeeping.  ``device`` is where
    ``"device"``-backend stores live (``None`` = ``"cuda"``)."""
    mgr = KeyedStateManager(WindowOp(**dataclasses.asdict(ref.op)),
                            device=device)
    mgr.idx = ref.idx
    mgr.partials = [WindowPartial(
        window=p.window, worker=p.worker, keys=np.array(p.keys),
        values=np.array(p.values), counts=np.array(p.counts),
        last_index=p.last_index) for p in ref.partials]
    m = ref.migration
    mgr.migration = MigrationStats(
        events=m.events, bytes_moved=m.bytes_moved,
        entries_moved=m.entries_moved, tuples_replayed=m.tuples_replayed,
        last_recv_entries=dict(m.last_recv_entries),
        last_recv_replays=dict(m.last_recv_replays))
    mgr.state_bytes_peak = ref.state_bytes_peak
    mgr.state_bytes_final = ref.state_bytes_final
    mgr._per_worker_peak = dict(ref._per_worker_peak)
    for block, pane in ref._panes.items():
        new = mgr._panes[block] = _Pane(pane.start, pane.end)
        new.last_idx = dict(pane.last_idx)
        for w, st in pane.stores.items():
            ks, vs, cs = st.items()
            store = new.stores[w] = make_store(mgr.op.backend, device)
            store.merge_entries(np.array(ks), np.array(vs), np.array(cs))
    mgr._next_window = ref._next_window
    mgr._finalized = ref._finalized
    mgr._seen_keys = set(ref._seen_keys)
    mgr._seen_pending = [np.array(a) for a in ref._seen_pending]
    return mgr


def fish_state_from_reference(np_state, device=None) -> FishState:
    """The port's ``FishState`` holding a reference one, read as numpy
    (``{"keys": (k_max,) int32, "counts": (k_max,) float32}``), on
    ``device`` (``None`` = ``"cuda"``)."""
    dev = resolve_device(device)
    return FishState(
        keys=torch.from_numpy(np.array(np_state["keys"], dtype=np.int32)
                              ).to(dev),
        counts=torch.from_numpy(np.array(np_state["counts"],
                                         dtype=np.float32)).to(dev))


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 ones as ml_dtypes hands them over) as a CPU
    tensor of the same dtype and bits."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def model_params_from_reference(np_params, cfg, device=None):
    """The port's model (:class:`repro_torch.models.transformer.Model`)
    holding a reference parameter pytree, read as numpy arrays: ``embed``,
    ``final_norm``, ``head`` unless tied, and ``stack`` with every layer
    leaf stacked on a leading layer axis — two, ``(L // pat, pat)``, under
    a local/global pattern of ``pat`` layers, layer ``i`` at
    ``[i // pat, i % pat]`` — and an MoE model's ``prefix`` list of dense
    layers; Griffin's ``rec_stack`` ``(G, 2, …)`` (layer ``3g + j`` at
    ``[g, j]``), ``attn_stack`` ``(G, …)`` (layer ``3g + 2`` at ``[g]``)
    and ``rec_tail`` ``(tail, …)``; whisper's ``enc_stack`` ``(E, …)``
    (encoder layer ``i`` at ``[i]``; its decoder ``stack`` leaves include
    ``cross`` and ``ln_cross``) and ``enc_final_norm``.  The port's
    parameter names are the reference's paths (``layers.3.attn.wq`` ↔
    ``stack["attn"]["wq"][3]``,
    ``layers.3.moe.shared.w_up`` ↔ ``stack["moe"]["shared"]["w_up"][3]``,
    ``prefix.0.attn.kv_norm.scale`` ↔
    ``prefix[0]["attn"]["kv_norm"]["scale"]``; an empty norm dict, OLMo's,
    has no parameter).  Values and dtypes carry over bit for bit (the
    float32 MoE router and RG-LRU ``lambda`` too); ``device`` ``None`` =
    ``"cuda"``."""
    from .models.transformer import Model, _stack_index

    def leaf(tree, dotted):
        for part in dotted.split("."):
            tree = tree[part]
        return tree

    model = Model(cfg, device=resolve_device(device))
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.startswith("layers."):
                _, i, rest = name.split(".", 2)
                stack, idx = _stack_index(cfg, int(i))
                a = leaf(np_params[stack], rest)
                for j in idx:
                    a = a[j]
            elif name.startswith("enc_stack."):
                _, i, rest = name.split(".", 2)
                a = leaf(np_params["enc_stack"], rest)[int(i)]
            elif name.startswith("prefix."):
                _, j, rest = name.split(".", 2)
                a = leaf(np_params["prefix"][int(j)], rest)
            else:
                a = leaf(np_params, name)
            param.copy_(_tensor(a))
    return model


def _at(tree, path: str):
    """The node of a reference pytree (nested dicts and lists) at a
    ``/``-joined leaf path."""
    for part in path.split("/"):
        tree = tree[int(part) if isinstance(tree, (list, tuple)) else part]
    return tree


def opt_state_from_reference(np_opt, device=None):
    """The port's :class:`~repro_torch.optim.adamw.OptState` holding a
    reference ``OptState`` (``step``, ``m``, ``v``; arrays read as numpy):
    ``m`` and ``v`` keyed by the reference's leaf paths, each leaf in its
    stacked shape and dtype, a factored ``v``'s ``{"r", "c"}`` kept.
    ``device`` ``None`` = ``"cuda"``."""
    from .checkpointing.checkpoint import _paths
    from .optim.adamw import OptState

    dev = resolve_device(device)

    def up(a):
        return _tensor(a).to(dev)

    m, v = {}, {}
    for path, leaf in _paths(np_opt.m):
        m[path] = up(leaf)
        node = _at(np_opt.v, path)
        v[path] = ({"r": up(node["r"]), "c": up(node["c"])}
                   if isinstance(node, dict) else up(node))
    return OptState(step=up(np.asarray(np_opt.step, dtype=np.int32)), m=m,
                    v=v)


def train_state_from_reference(np_state, cfg, device=None):
    """A reference train state ``{"params", "opt", "hotness"}`` (the tree
    its ``TrainLoop`` checkpoints) as the port's (model, ``OptState``,
    hotness tensor or ``None``) on ``device`` (``None`` = ``"cuda"``)."""
    hot = np_state.get("hotness")
    return (model_params_from_reference(np_state["params"], cfg, device),
            opt_state_from_reference(np_state["opt"], device),
            None if hot is None else _tensor(hot).to(resolve_device(device)))
