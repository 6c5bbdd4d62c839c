"""AdamW (with the optional Adafactor-style factored second moment),
gradient clipping and the cosine schedule: the port's copy of the JAX
package's ``optim/adamw.py``.

The reference keeps its state as pytrees of its stacked parameter leaves:
a per-layer tensor is row ``i`` of one leaf stacked over the layers (two
leading axes under a local/global pattern, and for Griffin's
``rec_stack``), the MoE model's ``prefix`` layers are a list of unstacked
leaves.  The port keeps the same state:
``m`` and ``v`` map each reference leaf path (``stack/attn/wq``,
:func:`repro_torch.models.transformer.reference_leaves`) to a tensor of
the stacked shape.  Two things depend on that layout:

* the decay mask goes by the reference's leaf paths (``_NO_DECAY``):
  ``stack/moe/router`` decays, ``stack/attn/kv_norm/scale`` does not,
  nor does ``rec_stack/rec/lambda``, while ``rec_stack/rec/conv_b``
  decays (no name of ``_NO_DECAY`` matches it);
* the factored second moment factors the stacked leaf (``ndim >= 2``):
  a per-layer vector (a norm scale, a bias) is an (L, D) leaf, whose
  column means ``c`` and whose mean of ``r`` run over the layers, so the
  layers' updates are coupled.  The port computes a factored leaf's update
  on the stacked leaf for that reason; every other leaf is elementwise, so
  it is updated one layer at a time, on views of the stacked state, in
  runs of rows of at most ``_PIECE`` elements: the update's float32
  temporaries stay small beside a large leaf (a tied embedding of 1 G
  elements would need ~8 × 4 GB of them at once), and each element's
  arithmetic is the same.

Parameters are updated in place; the state's ``m`` and ``v`` too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, NamedTuple, Tuple

import torch

from ..models.common import dtype_of
from ..models.transformer import Model, reference_leaves

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm", "decays"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"
    factored_v: bool = False


class OptState(NamedTuple):
    """``step`` a () int32 tensor; ``m`` and ``v`` map each reference leaf
    path to the leaf's state (``v``: a tensor, or ``{"r", "c"}`` float32
    when factored)."""
    step: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, Any]


def _is_factored(shape, cfg: AdamWConfig) -> bool:
    return cfg.factored_v and len(shape) >= 2


def _leaf_shapes(params: Model):
    """(path, member names, the stacked leaf's shape) per reference leaf."""
    named = dict(params.named_parameters())
    return [(path, names, lead + tuple(named[names[0]].shape))
            for path, names, lead in reference_leaves(params)]


def init_opt_state(params: Model, cfg: AdamWConfig) -> OptState:
    """Zero state on the parameters' device: ``m`` (and an unfactored
    ``v``) in ``cfg.state_dtype``, a factored ``v``'s ``r`` (the leaf's
    shape but its last axis) and ``c`` (but its second last) in float32."""
    dt = dtype_of(cfg.state_dtype)
    dev = params.embed.device
    m, v = {}, {}
    for path, _, shape in _leaf_shapes(params):
        m[path] = torch.zeros(shape, dtype=dt, device=dev)
        if _is_factored(shape, cfg):
            v[path] = {
                "r": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "c": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                 device=dev)}
        else:
            v[path] = torch.zeros(shape, dtype=dt, device=dev)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v)


def cosine_schedule(step, cfg: AdamWConfig):
    """Linear warmup, then a cosine decay to 0.1 × ``lr``; float32, in the
    reference's order.  ``step``: an int tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, each tensor's sum in float32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tensors]).sum())


_PIECE = 1 << 24  # elements an elementwise update takes at a time


def _pieces(*xs):
    """Equal runs of rows (views) of equally shaped tensors, each of at
    most ``_PIECE`` elements, one row at least."""
    row = xs[0][0].numel() if xs[0].dim() > 1 else 1
    rows = max(1, _PIECE // row)
    return zip(*(x.split(rows) for x in xs))


_NO_DECAY = ("scale", "bias", "a_log", "dt_bias", "d_skip", "lambda",
             "norm", "b_in", "b_out", "bq", "bk", "bv", "bo")


def decays(path: str) -> bool:
    """Whether weight decay applies to the reference leaf at ``path``."""
    return not any(path.endswith(s) or f"/{s}" in path for s in _NO_DECAY)


def _update(g, m, v, p, decay: bool, clip, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf's (or one layer's, unfactored) step: (new p, new m, new v)
    in the reference's arithmetic, float32, cast back to the stored
    dtypes."""
    sdt = m.dtype
    gf = g.float() * clip
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
    mhat = mf / b1c
    if isinstance(v, dict):
        g2 = gf.square() + 1e-30
        r = cfg.b2 * v["r"] + (1 - cfg.b2) * g2.mean(-1)
        c = cfg.b2 * v["c"] + (1 - cfg.b2) * g2.mean(-2)
        # Adafactor rank-1 reconstruction: V̂ = (R ⊗ C) / mean(R)
        rmean = r.mean(-1, keepdim=True)
        vhat = ((r / torch.clamp(rmean, min=1e-30))[..., None]
                * c[..., None, :])
        new_v = {"r": r, "c": c}
    else:
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf.square()
        vhat = vf / b2c
        new_v = vf.to(sdt)
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    newp = p.float() - lr * delta
    return newp.to(p.dtype), mf.to(sdt), new_v


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: OptState,
                 params: Model, cfg: AdamWConfig
                 ) -> Tuple[Model, OptState, dict]:
    """One AdamW / factored-AdamW step.  ``grads`` maps each parameter's
    name (``params.named_parameters()``) to its gradient.  Updates the
    parameters and the state's ``m``/``v`` in place; returns (params, the
    state with its step one on, {"grad_norm", "lr"})."""
    named = dict(params.named_parameters())
    gnorm = global_norm(grads[n] for n in named)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    hyper = (clip, lr, b1c, b2c, cfg)
    for path, names, shape in _leaf_shapes(params):
        decay, m, v = decays(path), state.m[path], state.v[path]
        ps = [named[n] for n in names]
        if isinstance(v, dict):  # factored: the whole stacked leaf
            g = torch.stack([grads[n] for n in names]).reshape(shape)
            p = torch.stack(ps).reshape(shape)
            newp, new_m, new_v = _update(g, m, v, p, decay, *hyper)
            m.copy_(new_m)
            v["r"].copy_(new_v["r"])
            v["c"].copy_(new_v["c"])
            for pm, row in zip(ps, newp.reshape(len(ps), *ps[0].shape)):
                pm.copy_(row)
            continue
        # elementwise: one layer at a time, on views of the stacked state,
        # in runs of rows
        rows = len(ps)
        for pm, n, m_i, v_i in zip(ps, names, m.view(rows, *ps[0].shape),
                                   v.view(rows, *ps[0].shape)):
            for g_r, m_r, v_r, p_r in _pieces(grads[n], m_i, v_i, pm):
                newp, new_m, new_v = _update(g_r, m_r, v_r, p_r, decay,
                                             *hyper)
                p_r.copy_(newp)
                m_r.copy_(new_m)
                v_r.copy_(new_v)
    return params, OptState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
