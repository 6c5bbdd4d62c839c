"""Model assembly of the port: the SSM (Mamba-2) family.

Entry points as in the JAX package's ``models/transformer.py``:

* :func:`init_params` — the model's parameters (an ``nn.Module``), drawn
  from a seeded ``torch.Generator`` on the device;
* :func:`prefill` — the full-sequence pass that also builds the decode
  cache, through the SSD chunk kernels;
* :func:`decode_step` — one token against the cache (the serving step);
* :func:`init_cache` — a zero decode cache.

The JAX package scans over layers stacked on a leading axis; here the
layers are an ``nn.ModuleList`` walked by a Python loop.  The decode
cache keeps the stacked layout (``conv`` (L, B, d_conv−1, C), ``ssm``
(L, B, H, N, P)).  Other families of the zoo are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import ssm as ssm_mod
from .common import apply_norm, dtype_of

__all__ = ["Model", "padded_vocab", "init_params", "prefill", "decode_step",
           "init_cache", "num_params"]


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rows padded to a multiple of 128 (Megatron-style); pad logits
    are masked to -1e30."""
    return -(-cfg.vocab_size // 128) * 128


def _check_family(cfg: ModelConfig) -> None:
    if cfg.ssm is None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the SSM (Mamba-2) family only")


class MambaLayer(nn.Module):
    """norm → Mamba-2 mixer → residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.mamba = ssm_mod.Mamba2(cfg.d_model, cfg.ssm, dtype, device)


class Model(nn.Module):
    """The parameters of an SSM-family model, in the JAX package's layout
    (``embed`` (PV, D), ``head`` (D, PV), layer ``i`` = its ``stack`` leaves'
    row ``i``).  Uninitialised: :func:`init_params` draws them, or
    :func:`repro_torch.convert.model_params_from_reference` copies them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_family(cfg)
        dtype = dtype_of(cfg.dtype)
        pv = padded_vocab(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.cfg = cfg
        self.embed = param(pv, cfg.d_model)
        self.final_norm = param(cfg.d_model)
        self.head = None if cfg.tie_embeddings else param(cfg.d_model, pv)
        self.layers = nn.ModuleList(MambaLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random-init parameters on ``device`` (``None`` = ``cuda``), drawn
    from ``torch.Generator(device).manual_seed(seed)``: not the JAX
    package's numbers (its PRNG differs), the same distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Model(cfg, device=dev)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev,
                            dtype=torch.float32) * std)

    with torch.no_grad():
        normal(model.embed, 0.02)
        model.final_norm.fill_(1.0)
        if model.head is not None:
            normal(model.head, 0.02)
        for layer in model.layers:
            layer.ln1.fill_(1.0)
            ssm_mod._init_mamba2_(layer.mamba, gen)
    return model


def num_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def _norm(cfg: ModelConfig, scale, x):
    return apply_norm(x, scale, cfg.norm, cfg.norm_eps)


def _embed(params: Model, batch, cfg: ModelConfig):
    h = params.embed[batch["tokens"].long()]
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


def _head_matrix(params: Model, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.head


def _masked_logits(h_last, params: Model, cfg: ModelConfig):
    logits = (h_last @ _head_matrix(params, cfg)).float()
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    pv = padded_vocab(cfg)
    if pv != cfg.vocab_size:
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


@torch.no_grad()
def prefill(params: Model, batch, cfg: ModelConfig):
    """Full-sequence pass building the decode cache.

    batch: ``{"tokens": (B, S) int}``.
    Returns (cache dict, last-token logits (B, PV) f32).
    """
    _check_family(cfg)
    return _mamba_prefill(params, _embed(params, batch, cfg), cfg)


def _mamba_prefill(params: Model, h, cfg: ModelConfig):
    convs, ssms = [], []
    for layer in params.layers:
        out, st = ssm_mod.mamba2_block(layer.mamba, _norm(cfg, layer.ln1, h),
                                       cfg.ssm)
        h = h + out
        convs.append(st["conv"])
        ssms.append(st["ssm"])
    h = _norm(cfg, params.final_norm, h)
    logits = _masked_logits(h[:, -1], params, cfg)
    cache = {"pos": h.shape[1] - 1,
             "layers": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}}
    return cache, logits


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict:
    """Zero decode cache (``max_seq`` is unused: the state is O(1))."""
    _check_family(cfg)
    dev = resolve_device(device)
    _, n_heads, conv_dim, _ = ssm_mod._mamba2_dims(cfg.d_model, cfg.ssm)
    L = cfg.num_layers
    return {
        "pos": 0,
        "layers": {
            "conv": torch.zeros((L, batch, cfg.ssm.d_conv - 1, conv_dim),
                                dtype=dtype_of(cfg.dtype), device=dev),
            "ssm": torch.zeros((L, batch, n_heads, cfg.ssm.d_state,
                                cfg.ssm.head_dim), dtype=torch.float32,
                               device=dev),
        },
    }


@torch.no_grad()
def decode_step(params: Model, cache: Dict, tokens, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) int.

    Returns (logits (B, PV) f32, new cache); the cache passed in is left
    as it was, as in the JAX package.
    """
    _check_family(cfg)
    h = params.embed[tokens.long()]
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    h, layers = _mamba_decode_stack(params, h, cache["layers"], cfg)
    h = _norm(cfg, params.final_norm, h)
    logits = _masked_logits(h[:, 0], params, cfg)
    return logits, {"pos": cache["pos"] + 1, "layers": layers}


def _mamba_decode_stack(params: Model, h, states, cfg: ModelConfig):
    conv, ssm = [], []
    for i, layer in enumerate(params.layers):
        st = {"conv": states["conv"][i], "ssm": states["ssm"][i]}
        out, new = ssm_mod.mamba2_decode(layer.mamba,
                                         _norm(cfg, layer.ln1, h), st,
                                         cfg.ssm)
        conv.append(new["conv"])
        ssm.append(new["ssm"])
        h = h + out
    return h, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
