"""Mixture-of-Experts with FISH load balancing, the port's copy of the JAX
package's ``models/moe.py``.

Token→expert routing is the paper's grouping problem: keys are the
router's expert choices, workers are experts, and expert hotness evolves
like the paper's time-evolving stream keys.  Three routing modes:

* ``fg``   — only each token's first choice, uniform capacity (FG analog);
* ``pkg``  — top-k claimed in gate order, uniform capacity (PKG analog);
* ``fish`` — Alg. 1 (``hotness ← α·hotness + counts``), Alg. 2 (CHK: the
  fixed dispatch budget split by decayed hotness, :func:`fish_capacities`)
  and Alg. 3 (each claim's place in its expert's buffer inferred from a
  cumsum over the routing tensor, :func:`_route`).

Dispatch and combine are GShard-style one-hot einsums
(``dispatch_impl="einsum"``) or a gather/scatter (``"scatter"``, what
deepseek-v2-lite and kimi-k2 use), both with static shapes.  The expert
FFN is a plain batched product, as the reference leaves it to XLA outside
any Pallas kernel.  The reference's ``shard()`` calls have no counterpart:
the port runs on one card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import MoEConfig
from .common import activation_fn

__all__ = ["MoE", "init_moe_params", "moe_ffn", "fish_capacities",
           "init_hotness", "capacity_plan", "CapacityPlan"]

_LN2 = math.log(2.0)


def init_hotness(num_experts: int, device=None) -> torch.Tensor:
    """Zero hotness (no history: CHK then splits the budget uniformly)."""
    return torch.zeros((num_experts,), dtype=torch.float32,
                       device=resolve_device(device))


# ---------------------------------------------------------------------------
# CHK: hotness -> per-expert capacity allocation (Alg. 2 analog)
# ---------------------------------------------------------------------------


def fish_capacities(hotness, *, budget: int, c_max: int,
                    theta_frac: float = 0.25, d_min: int = 2):
    """Split a fixed dispatch budget across experts by decayed hotness.

    Hot experts (f_e > θ = theta_frac/E) get a share d_e = E /
    2^⌊log2(f_top/f_e)⌋ clamped to [d_min, E]; the others the PKG share
    d_min.  Capacities are clipped to [1, c_max]; with no history (Σ
    hotness 0) the split is uniform.  Float32 throughout, in the
    reference's order: its ``jnp.log2`` is ``log(x) / log(2)`` in float32,
    which rounds differently from ``torch.log2`` just below powers of two,
    so the index is computed the reference's way.
    """
    e = hotness.shape[0]
    total = torch.clamp(hotness.sum(), min=1e-30)
    f = hotness / total
    f_top = torch.clamp(f.max(), min=1e-30)
    theta = theta_frac / e
    ratio = torch.clamp(f_top / torch.clamp(f, min=1e-30), min=1.0)
    index = torch.clamp(torch.floor(torch.log(ratio) / _LN2), 0, 30)
    d = torch.clamp(e / torch.exp2(index), d_min, e)
    share = torch.where(f > theta, d, float(d_min))
    cap = torch.floor(budget * share / torch.clamp(share.sum(), min=1e-30))
    uniform = torch.full((e,), float(budget) / e, dtype=torch.float32,
                         device=hotness.device)
    cap = torch.where(total > 1e-20, cap, uniform)
    return torch.clamp(cap, 1.0, float(c_max)).to(torch.int32)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class SharedExperts(nn.Module):
    """The always-on experts as one gated MLP of width F·shared_experts."""

    def __init__(self, d_model: int, width: int, dtype, device):
        super().__init__()
        self.w_gate = _param((d_model, width), dtype, device)
        self.w_up = _param((d_model, width), dtype, device)
        self.w_down = _param((width, d_model), dtype, device)


class MoE(nn.Module):
    """``router`` (D, E) in float32 whatever the model's dtype; expert
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D); ``shared``
    when the config has shared experts."""

    def __init__(self, d_model: int, moe: MoEConfig, dtype, device):
        super().__init__()
        e, f = moe.num_experts, moe.d_ff_expert
        self.router = _param((d_model, e), torch.float32, device)
        self.w_gate = _param((e, d_model, f), dtype, device)
        self.w_up = _param((e, d_model, f), dtype, device)
        self.w_down = _param((e, f, d_model), dtype, device)
        self.shared = (SharedExperts(d_model, f * moe.shared_experts, dtype,
                                     device)
                       if moe.shared_experts else None)


def init_moe_params(generator: torch.Generator, d_model: int,
                    moe: MoEConfig, dtype=torch.bfloat16,
                    device=None) -> MoE:
    """A randomly initialised MoE layer (the JAX package's distributions,
    drawn from ``generator``, which lives on ``device``)."""
    return _init_moe_(MoE(d_model, moe, dtype, device), generator)


@torch.no_grad()
def _init_moe_(m: MoE, generator: torch.Generator) -> MoE:
    """Draw ``m``'s parameters in place: the router N(0, 0.02²), expert
    inputs N(0, 1/D), outputs N(0, 1/F).  Expert tensors are drawn one
    expert at a time, so the float32 scratch is one expert's, not the
    whole (E, D, F) tensor's."""
    def normal(t, std):
        for row in (t if t.dim() == 3 else (t,)):
            row.copy_(torch.randn(row.shape, generator=generator,
                                  device=row.device,
                                  dtype=torch.float32) * std)

    d_model, f = m.w_gate.shape[1:]
    normal(m.router, 0.02)
    normal(m.w_gate, 1.0 / math.sqrt(d_model))
    normal(m.w_up, 1.0 / math.sqrt(d_model))
    normal(m.w_down, 1.0 / math.sqrt(f))
    if m.shared is not None:
        normal(m.shared.w_gate, 1.0 / math.sqrt(d_model))
        normal(m.shared.w_up, 1.0 / math.sqrt(d_model))
        normal(m.shared.w_down, 1.0 / math.sqrt(m.shared.w_down.shape[0]))
    return m


# ---------------------------------------------------------------------------
# Routing + capacity-bounded claim (slot by slot, fill inferred via cumsum)
# ---------------------------------------------------------------------------


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(gates, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (``torch.topk`` promises no tie order; a stable descending sort
    keeps equal gates in index order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(gates, moe: MoEConfig, capacities):
    """Claim buffer slots for each token's top-k choices.

    gates: (G, T, E) float32 softmax probabilities; capacities: (E,) int32.
    Returns ids (G,T,K), combine gates (G,T,K), keep (G,T,K) bool and pos
    (G,T,K) int32, the place in the target expert's buffer.  The running
    fill is inferred from the routing tensor (an exclusive cumsum of
    one-hots per choice, in float32: integer counts, so exact).
    """
    g, t, e = gates.shape
    top_gates, ids = _top_k(gates, moe.top_k)
    cap = capacities.to(torch.float32)
    fill = torch.zeros((g, e), dtype=torch.float32, device=gates.device)
    keeps, poss = [], []
    for j in range(moe.top_k):
        oh = _one_hot(ids[:, :, j], e, torch.float32)  # (G,T,E)
        pos_in_slot = torch.cumsum(oh, dim=1) - oh  # exclusive
        pos_t = (oh * (pos_in_slot + fill[:, None, :])).sum(-1)  # (G,T)
        keep_j = pos_t < cap[ids[:, :, j]]
        fill = fill + (oh * keep_j[..., None]).sum(1)
        keeps.append(keep_j)
        poss.append(pos_t.to(torch.int32))
    keep = torch.stack(keeps, dim=-1)
    pos = torch.stack(poss, dim=-1)

    # renormalise the gates over the surviving slots
    kept_gate = top_gates * keep.to(top_gates.dtype)
    denom = torch.clamp(kept_gate.sum(-1, keepdim=True), min=1e-9)
    return ids, kept_gate / denom, keep, pos


def _dispatch_einsum(x, ids, gates, keep, pos, e: int, c: int):
    """GShard one-hot dispatch/combine tensors.  x: (G, T, D); returns
    xin (G, E, C, D) and the combine ((G,E,C,D) -> (G,T,D))."""
    oh_e = _one_hot(ids, e, x.dtype)  # (G,T,K,E)
    oh_c = _one_hot(pos, c, x.dtype)  # (G,T,K,C): a dropped pos >= c is 0
    keep_f = keep.to(x.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh_e * keep_f[..., None],
                            oh_c)
    xin = torch.einsum("gtec,gtd->gecd", dispatch, x)

    def combine(yout):
        comb = torch.einsum("gtke,gtkc->gtec",
                            oh_e * (keep_f * gates.to(x.dtype))[..., None],
                            oh_c)
        return torch.einsum("gtec,gecd->gtd", comb, yout)

    return xin, combine


def _dispatch_scatter(x, ids, gates, keep, pos, e: int, c: int):
    """Gather/scatter dispatch: no one-hot products.  Each group's buffer
    has one spare row, ``e * c``, where dropped pairs go (the reference's
    out-of-range slot under ``mode="drop"``): written into and never
    read.  Kept slots are unique per (expert, pos), so the copy is
    deterministic.  The combine reads a dropped pair from its group's
    slot 0, where the reference's ``mode="fill"`` reads a zero, and
    weights it by 0 as the reference does."""
    g, t, d = x.shape
    k = ids.shape[-1]
    rows = e * c + 1
    slot = torch.where(keep, ids * c + pos, e * c)  # (G,T,K)
    base = torch.arange(g, device=x.device)[:, None, None]
    dst = (base * rows + slot).reshape(g * t, k)
    buf = x.new_zeros((g * rows, d))
    src = x.reshape(g * t, d)
    for j in range(k):
        buf.index_copy_(0, dst[:, j], src)
    xin = buf.view(g, rows, d)[:, :e * c].reshape(g, e, c, d)
    src_slot = (base * (e * c) + torch.where(keep, slot, 0)).reshape(-1)

    def combine(yout):
        per_choice = yout.reshape(g * e * c, d)[src_slot].reshape(g, t, k, d)
        w = (gates * keep.to(gates.dtype)).to(x.dtype)
        return torch.einsum("gtk,gtkd->gtd", w, per_choice)

    return xin, combine


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


class CapacityPlan(NamedTuple):
    """How ``moe_ffn`` cuts T tokens: ``groups`` of ``group_size``, each
    with a dispatch ``budget`` of claims, the uniform share ``c_avg`` and
    the buffer depth ``c_max`` per expert (Python ints, from shapes)."""
    groups: int
    group_size: int
    budget: int
    c_avg: int
    c_max: int


def capacity_plan(moe: MoEConfig, tokens: int) -> CapacityPlan:
    """Groups of ``min(tokens_per_group, T)`` tokens, which must divide T
    (the reference asserts it; here a ``ValueError``)."""
    tg = min(moe.tokens_per_group, tokens)
    if tokens % tg:
        raise ValueError(f"tokens {tokens} not divisible by group {tg}")
    budget = int(tg * moe.top_k * moe.capacity_factor)
    c_avg = max(budget // moe.num_experts, 1)
    c_max = max(int(c_avg * moe.hot_headroom), 4)
    c_max = -(-c_max // 4) * 4  # round up to a multiple of 4
    return CapacityPlan(tokens // tg, tg, budget, c_avg, c_max)


def moe_ffn(params: MoE, x, moe: MoEConfig, hotness
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """x: (T, D) tokens; hotness: (E,) float32 decayed demand counters.

    Returns (y (T, D), new_hotness, aux loss × ``router_aux_weight``,
    metrics): ``moe_drop_frac``, ``moe_load_max_over_mean``, ``moe_aux``,
    each a 0-d tensor left on the device.
    """
    t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    act = activation_fn("silu")
    g, tg, budget, c_avg, c_max = capacity_plan(moe, t)

    xg = x.reshape(g, tg, d)
    logits = xg.float() @ params.router  # (G, T, E) float32
    gates = torch.softmax(logits, dim=-1)

    # FISH state: intra-epoch count + inter-epoch decay (Alg. 1)
    _, topk_ids = _top_k(gates, k)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, topk_ids.reshape(-1),
                      torch.ones(topk_ids.numel(), device=x.device))
    new_hotness = moe.fish_alpha * hotness + counts

    mean_gate = gates.mean(dim=(0, 1))
    if moe.routing == "fish":
        capacities = fish_capacities(hotness, budget=budget, c_max=c_max,
                                     theta_frac=moe.fish_theta_frac)
        # time-aware balance loss: the recent load, not this batch's
        recent = new_hotness / torch.clamp(new_hotness.sum(), min=1e-30)
        aux = (recent * mean_gate).sum() * e
    elif moe.routing in ("fg", "pkg"):
        capacities = torch.full((e,), min(c_avg, c_max), dtype=torch.int32,
                                device=x.device)
        frac = counts / torch.clamp(counts.sum(), min=1e-30)
        aux = (frac * mean_gate).sum() * e
    else:
        raise ValueError(f"unknown moe routing {moe.routing!r}")

    ids, cgates, keep, pos = _route(gates, moe, capacities)
    if moe.routing == "fg":
        # only the first choice is used (hard key-affine routing)
        keep = keep & (torch.arange(k, device=x.device) == 0)
        cgates = torch.where(keep, 1.0, 0.0).to(cgates.dtype)

    dispatch = (_dispatch_scatter if moe.dispatch_impl == "scatter"
                else _dispatch_einsum)
    xin, combine = dispatch(xg, ids, cgates, keep, pos, e, c_max)

    # the expert FFN: E batched products
    h = act(torch.einsum("gecd,edf->gecf", xin, params.w_gate)) * \
        torch.einsum("gecd,edf->gecf", xin, params.w_up)
    yout = torch.einsum("gecf,efd->gecd", h, params.w_down)
    y = combine(yout).reshape(t, d)

    if params.shared is not None:
        sp = params.shared
        hs = act(x @ sp.w_gate) * (x @ sp.w_up)
        y = y + hs @ sp.w_down

    dropped = 1.0 - keep.float().mean()
    load = counts / torch.clamp(counts.sum(), min=1e-30)
    metrics = {
        "moe_drop_frac": dropped,
        "moe_load_max_over_mean": load.max() * e,
        "moe_aux": aux,
    }
    return y.to(x.dtype), new_hotness, aux * moe.router_aux_weight, metrics
