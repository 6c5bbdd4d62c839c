"""Mamba-2 (SSD) sequence mixer of the port.

A full-sequence path (train/prefill, through the SSD chunk kernels of
:func:`repro_torch.kernels.ops.ssd_scan`) and an O(1)-state decode step.
Parameters keep the JAX package's layout (``x @ in_proj``; ``conv_w`` is
``(d_conv, channels)``), so its weights carry over unchanged
(:func:`repro_torch.convert.model_params_from_reference`).  The in/out
projections stay ``torch.matmul``: the JAX package leaves them to XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import SSMConfig
from ..kernels import ops as kops
from .common import rms_norm

__all__ = ["Mamba2", "init_mamba2_params", "mamba2_block", "mamba2_decode",
           "init_mamba2_state"]


def _mamba2_dims(d_model: int, ssm: SSMConfig):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.d_state
    d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Mamba2(nn.Module):
    """The parameters of one Mamba-2 mixer (left uninitialised here:
    :func:`init_mamba2_params` draws them, or a converter copies them)."""

    def __init__(self, d_model: int, ssm: SSMConfig,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        d_inner, n_heads, conv_dim, d_in_proj = _mamba2_dims(d_model, ssm)
        self.ssm = ssm
        f32 = torch.float32
        self.in_proj = _param((d_model, d_in_proj), dtype, device)
        self.conv_w = _param((ssm.d_conv, conv_dim), dtype, device)
        self.conv_b = _param((conv_dim,), dtype, device)
        self.a_log = _param((n_heads,), f32, device)
        self.dt_bias = _param((n_heads,), f32, device)
        self.d_skip = _param((n_heads,), f32, device)
        self.norm_scale = _param((d_inner,), dtype, device)
        self.out_proj = _param((d_inner, d_model), dtype, device)

    def forward(self, x):
        return mamba2_block(self, x, self.ssm)[0]


def init_mamba2_params(generator: torch.Generator, d_model: int,
                       ssm: SSMConfig, dtype=torch.bfloat16,
                       device=None) -> Mamba2:
    """A randomly initialised mixer (the JAX package's init, drawn from
    ``generator``, which lives on ``device``)."""
    return _init_mamba2_(Mamba2(d_model, ssm, dtype, device), generator)


@torch.no_grad()
def _init_mamba2_(m: Mamba2, generator: torch.Generator) -> Mamba2:
    """Draw ``m``'s parameters in place."""
    d_inner, d_model = m.out_proj.shape
    n_heads = m.a_log.shape[0]

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std)

    normal(m.in_proj, 1.0 / math.sqrt(d_model))
    normal(m.conv_w, 0.1)
    m.conv_b.zero_()
    m.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, n_heads)))
    m.dt_bias.zero_()
    m.d_skip.fill_(1.0)
    m.norm_scale.fill_(1.0)
    normal(m.out_proj, 1.0 / math.sqrt(d_inner))
    return m


def _mamba2_preproc(p: Mamba2, x, ssm: SSMConfig):
    """Shared in_proj + split for both the sequence and decode paths."""
    d_inner, n_heads, conv_dim, _ = _mamba2_dims(x.shape[-1], ssm)
    proj = x @ p.in_proj
    z, xbc, dt = torch.split(
        proj, [d_inner, conv_dim, proj.shape[-1] - d_inner - conv_dim],
        dim=-1)
    return z, xbc, dt, d_inner, n_heads


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv1d.  xbc: (B, S, C); conv_w: (K, C)."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, :s] * conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out + conv_b)


def mamba2_block(p: Mamba2, x, ssm: SSMConfig):
    """Full-sequence Mamba-2 mixer.  x: (B, S, D) → (out (B, S, D), the
    decode state after the last token ``{"conv", "ssm"}``).  (The JAX
    package's ``mamba2_block`` drops the state; its prefill recomputes the
    layer to keep it — here one function serves both.)"""
    b, s, _ = x.shape
    z, xbc, dt, d_inner, n_heads = _mamba2_preproc(p, x, ssm)
    xbc_c = _causal_conv(xbc, p.conv_w, p.conv_b)
    gn = ssm.n_groups * ssm.d_state
    xs, bm, cm = torch.split(xbc_c, [d_inner, gn, gn], dim=-1)
    dtp = F.softplus(dt.float() + p.dt_bias)  # (B, S, H)
    a = -torch.exp(p.a_log)
    xh = xs.reshape(b, s, n_heads, ssm.head_dim)
    y, final = kops.ssd_scan(
        xh.float() * dtp[..., None], a * dtp,
        bm.reshape(b, s, ssm.n_groups, ssm.d_state),
        cm.reshape(b, s, ssm.n_groups, ssm.d_state), chunk=ssm.chunk)
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = rms_norm(y.reshape(b, s, d_inner) * F.silu(z.float()), p.norm_scale)
    out = y.to(x.dtype) @ p.out_proj
    return out, {"conv": xbc[:, -(ssm.d_conv - 1):, :], "ssm": final}


def init_mamba2_state(d_model: int, ssm: SSMConfig, batch: int,
                      dtype=torch.float32, device=None) -> Dict:
    _, n_heads, conv_dim, _ = _mamba2_dims(d_model, ssm)
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, ssm.d_state, ssm.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p: Mamba2, x, state: Dict, ssm: SSMConfig):
    """Single-token recurrent step.  x: (B, 1, D) → (B, 1, D), new state."""
    b = x.shape[0]
    z, xbc, dt, d_inner, n_heads = _mamba2_preproc(p, x[:, 0], ssm)
    window = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None, :]], dim=1)
    xbc_t = F.silu((window * p.conv_w[None]).sum(1) + p.conv_b)
    gn = ssm.n_groups * ssm.d_state
    xs, bvec, cvec = torch.split(xbc_t, [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)  # (B, H)
    decay = torch.exp(-torch.exp(p.a_log) * dt)
    xh = xs.reshape(b, n_heads, ssm.head_dim).float()
    hpg = n_heads // ssm.n_groups
    bh = bvec.reshape(b, ssm.n_groups, ssm.d_state).repeat_interleave(hpg, 1)
    ch = cvec.reshape(b, ssm.n_groups, ssm.d_state).repeat_interleave(hpg, 1)
    new_ssm = state["ssm"] * decay[..., None, None] \
        + bh[..., :, None] * (xh * dt[..., None])[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), new_ssm)
    y = y + p.d_skip[None, :, None] * xh
    y = rms_norm(y.reshape(b, d_inner) * F.silu(z.float()), p.norm_scale)
    out = (y.to(x.dtype) @ p.out_proj)[:, None, :]
    return out, {"conv": window[:, 1:, :], "ssm": new_ssm}
