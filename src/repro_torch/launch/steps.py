"""The train step of the port: the JAX package's ``launch/steps.py``
``make_train_step``, on one card.

The reference's ``PartitionSpec``s, input specs and abstract states
belong to its dry run on a TPU mesh and have no counterpart here.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..optim.adamw import AdamWConfig, OptState, adamw_update

__all__ = ["make_train_step"]


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    """``n`` microbatches, each leaf's batch axis cut into ``n`` equal
    runs, in order: axis 0, but axis 1 of M-RoPE's (3, B, S)
    ``positions``, as the reference splits them."""
    axes = {k: 1 if k == "positions" else 0 for k in batch}
    for k, x in batch.items():
        if x.shape[axes[k]] % n:
            raise ValueError(f"batch {x.shape[axes[k]]} of {k!r} not "
                             f"divisible by grad_accum {n}")
    parts = {k: x.chunk(n, dim=axes[k]) for k, x in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, hotness, batch)`` with optional
    gradient accumulation (``cfg.grad_accum`` microbatches).

    The step takes the gradient of :func:`~repro_torch.models.transformer.
    forward_train` with respect to every parameter (turning gradients on
    for them), then applies :func:`~repro_torch.optim.adamw.adamw_update`,
    which updates the parameters in place.  With accumulation the FISH
    hotness epoch is the microbatch: each microbatch routes with the
    hotness the previous one produced, the gradients are summed in their
    dtype and divided by the count, as the reference's scan does.
    Returns (params, opt_state, new hotness, metrics); the metrics are
    0-d tensors left on the device."""
    n_micro = max(cfg.grad_accum, 1)

    def train_step(params: T.Model, opt_state: OptState, hotness,
                   batch: Dict[str, torch.Tensor]):
        params.requires_grad_(True)
        names, ps = zip(*params.named_parameters())

        def grad_of(mb, hot):
            loss, out = T.forward_train(params, mb, cfg, hot)
            grads = torch.autograd.grad(loss, ps, materialize_grads=True)
            return (loss.detach(), out["ce_loss"].detach(),
                    out["aux_loss"].detach(), out["new_hotness"], grads)

        if n_micro == 1:
            loss, ce, aux, hot_new, grads = grad_of(batch, hotness)
        else:
            gsum = [torch.zeros_like(p, requires_grad=False) for p in ps]
            hot_new = hotness
            loss = ce = aux = torch.zeros((), dtype=torch.float32,
                                          device=params.embed.device)
            for mb in _split_micro(batch, n_micro):
                l, c, a, hot, g = grad_of(mb, hot_new)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi.to(acc.dtype))
                if hot_new is not None:
                    hot_new = hot
                loss, ce, aux = loss + l, ce + c, aux + a
            grads = [g / n_micro for g in gsum]
            loss, ce, aux = loss / n_micro, ce / n_micro, aux / n_micro

        params, new_opt, om = adamw_update(dict(zip(names, grads)),
                                           opt_state, params, opt_cfg)
        metrics = {"loss": loss, "ce_loss": ce, "aux_loss": aux, **om}
        return params, new_opt, hot_new, metrics

    return train_step
