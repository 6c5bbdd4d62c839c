"""State-space sequence mixers of the port: Mamba-2 (SSD) and RG-LRU
(Griffin / RecurrentGemma).

Each has a full-sequence path (train/prefill) and an O(1)-state decode
step.  Mamba-2's runs through the SSD chunk kernels of
:func:`repro_torch.kernels.ops.ssd_scan`; the RG-LRU's linear recurrence
is a log-depth associative scan in plain tensor ops, as the JAX package
runs it on XLA (``lax.associative_scan``, no Pallas kernel).  Parameters
keep the JAX package's layout (``x @ in_proj``; ``conv_w`` is
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

from ..configs.base import RGLRUConfig, SSMConfig
from ..kernels import ops as kops
from .common import activation_fn, rms_norm

__all__ = ["Mamba2", "init_mamba2_params", "mamba2_block", "mamba2_decode",
           "init_mamba2_state", "RGLRU", "init_rglru_params", "rglru_block",
           "init_rglru_state", "rglru_decode"]


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


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_gelu = activation_fn("gelu_tanh")  # jax.nn.gelu's default, approximate=True


class RGLRU(nn.Module):
    """The parameters of one Griffin recurrent block: ``w_x``, ``w_gate``
    (D, W), ``conv_w`` (conv_width, W), ``conv_b`` (W,), the block-diagonal
    gates ``w_input_gate``, ``w_rec_gate`` (NB, W/NB, W/NB), ``lambda``
    (W,) float32 and ``w_out`` (W, D).  ``lambda`` is a Python keyword, so
    it is registered by name: read it with ``getattr(m, "lambda")``."""

    def __init__(self, d_model: int, rg: RGLRUConfig,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        width = rg.lru_width or d_model
        nb = rg.gate_blocks
        wb = width // nb
        self.w_x = _param((d_model, width), dtype, device)
        self.w_gate = _param((d_model, width), dtype, device)
        self.conv_w = _param((rg.conv_width, width), dtype, device)
        self.conv_b = _param((width,), dtype, device)
        self.w_input_gate = _param((nb, wb, wb), dtype, device)
        self.w_rec_gate = _param((nb, wb, wb), dtype, device)
        self.register_parameter("lambda",
                                _param((width,), torch.float32, device))
        self.w_out = _param((width, d_model), dtype, device)


def init_rglru_params(generator: torch.Generator, d_model: int,
                      rg: RGLRUConfig, dtype=torch.bfloat16,
                      device=None) -> RGLRU:
    """A randomly initialised block (the JAX package's init, drawn from
    ``generator``, which lives on ``device``)."""
    return _init_rglru_(RGLRU(d_model, rg, dtype, device), generator)


@torch.no_grad()
def _init_rglru_(m: RGLRU, generator: torch.Generator) -> RGLRU:
    """Draw ``m``'s parameters in place: every matrix N(0, 1/fan_in) (the
    gates' fan-in is a block's width), ``conv_w`` N(0, 0.01), ``conv_b``
    zero, and Λ so that a^c spans (0.9, 0.999) (Griffin's appendix)."""
    d_model, width = m.w_x.shape
    wb = m.w_input_gate.shape[-1]

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std)

    normal(m.w_x, 1.0 / math.sqrt(d_model))
    normal(m.w_gate, 1.0 / math.sqrt(d_model))
    normal(m.conv_w, 0.1)
    m.conv_b.zero_()
    normal(m.w_input_gate, 1.0 / math.sqrt(wb))
    normal(m.w_rec_gate, 1.0 / math.sqrt(wb))
    lam = getattr(m, "lambda")
    grid = torch.linspace(0.9, 0.999, width, device=lam.device)
    lam.copy_(torch.log(torch.expm1(-torch.log(grid) / _RGLRU_C)))
    normal(m.w_out, 1.0 / math.sqrt(width))
    return m


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _block_diag_apply(xf, w):
    """xf: (..., W); w: (NB, WB, WB) block-diagonal linear, in float32."""
    nb, wb = w.shape[0], w.shape[1]
    xb = xf.reshape(xf.shape[:-1] + (nb, wb))
    out = torch.einsum("...nw,nwv->...nv", xb, w.float())
    return out.reshape(xf.shape)


def _rglru_gates(p: RGLRU, xc):
    """The decay ``a`` and the gated input ``b`` of the recurrence, float32.
    xc: (..., W), the conv's output."""
    xf = xc.float()
    i_gate = torch.sigmoid(_block_diag_apply(xf, p.w_input_gate))
    r_gate = torch.sigmoid(_block_diag_apply(xf, p.w_rec_gate))
    log_a = -_RGLRU_C * _softplus(getattr(p, "lambda")) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i_gate * xf)


def _rglru_conv(xr, p: RGLRU):
    """Depthwise causal conv1d without activation, in ``xr``'s dtype: each
    tap's product and sum rounded there (bf16 at full width), as the
    reference's Python ``sum`` of the taps."""
    k, s = p.conv_w.shape[0], xr.shape[1]
    pad = F.pad(xr, (0, 0, k - 1, 0))
    out = pad[:, :s] * p.conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * p.conv_w[i]
    return out + p.conv_b


def _sl(x, axis: int, start, stop=None, step=None):
    """``x[start:stop:step]`` along ``axis`` (a view)."""
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(even, odd, axis: int):
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of ``axis``
    (``even`` is as long as ``odd`` or one longer)."""
    n = even.shape[axis] + odd.shape[axis]
    if odd.shape[axis] < even.shape[axis]:
        odd = torch.cat([odd, torch.zeros_like(_sl(even, axis, 0, 1))], axis)
    return torch.stack([even, odd], axis + 1).flatten(axis, axis + 1).narrow(
        axis, 0, n)


def _combine(left, right):
    """Two runs of the recurrence h ← a·h + b, ``left`` first, as one."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _associative_scan(a, b, axis: int):
    """The inclusive scan of ``(a, b)`` under :func:`_combine` along
    ``axis``: ``lax.associative_scan``'s odd/even recursion, op for op
    (pairs combined, the half scanned, the evens filled in), so its float32
    rounding is the reference's.  Log depth: ~2·log2(S) rounds of a few
    tensor ops each."""
    n = a.shape[axis]
    if n < 2:
        return a, b
    reduced = _combine((_sl(a, axis, 0, -1, 2), _sl(b, axis, 0, -1, 2)),
                       (_sl(a, axis, 1, None, 2), _sl(b, axis, 1, None, 2)))
    odd = _associative_scan(*reduced, axis)
    if n % 2 == 0:
        odd_prev = (_sl(odd[0], axis, 0, -1), _sl(odd[1], axis, 0, -1))
    else:
        odd_prev = odd
    even = _combine(odd_prev, (_sl(a, axis, 2, None, 2),
                               _sl(b, axis, 2, None, 2)))
    even = tuple(torch.cat([_sl(x, axis, 0, 1), e], axis)
                 for x, e in zip((a, b), even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _lru_scan(a, b, chunks: int = 16):
    """h_t = a_t·h_{t−1} + b_t from h_{−1} = 0.  a, b: (B, S, W) float32.

    As the reference: one associative scan over the whole sequence when
    ``S % chunks`` or ``S < 2·chunks``; else ``chunks`` chunk-local scans
    and a sequential combine of the chunks' carries (``chunks`` steps on
    (B, W) tensors, in the reference's order)."""
    bsz, s, w = a.shape
    if s % chunks or s < 2 * chunks:
        return _associative_scan(a, b, 1)[1]
    a_loc, h_loc = _associative_scan(a.reshape(bsz, chunks, s // chunks, w),
                                     b.reshape(bsz, chunks, s // chunks, w),
                                     2)
    carry = torch.zeros_like(a_loc[:, 0, -1])
    carry_in = []
    for i in range(chunks):  # the carry *into* chunk i
        carry_in.append(carry)
        carry = a_loc[:, i, -1] * carry + h_loc[:, i, -1]
    h = h_loc + a_loc * torch.stack(carry_in, 1)[:, :, None, :]
    return h.reshape(bsz, s, w)


def rglru_block(p: RGLRU, x, rg: RGLRUConfig):
    """Full-sequence Griffin recurrent block.  x: (B, S, D) → (out (B, S,
    D), the decode state after the last token ``{"conv": the last
    conv_width − 1 conv inputs (B, K−1, W) float32, "h": (B, W)
    float32}``).  (The JAX package's ``rglru_block`` drops the state; its
    prefill recomputes the block to keep it — here one function serves
    both.)"""
    gate = _gelu(x @ p.w_gate)
    xr = x @ p.w_x
    a, b = _rglru_gates(p, _rglru_conv(xr, p))
    h = _lru_scan(a, b)
    y = h.to(x.dtype) * gate  # h rounded to the activations' dtype first
    out = (y @ p.w_out).to(x.dtype)
    return out, {"conv": xr[:, -(rg.conv_width - 1):].float(),
                 "h": h[:, -1]}


def init_rglru_state(d_model: int, rg: RGLRUConfig, batch: int,
                     device=None) -> Dict:
    width = rg.lru_width or d_model
    return {
        "conv": torch.zeros((batch, rg.conv_width - 1, width),
                            dtype=torch.float32, device=device),
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
    }


def rglru_decode(p: RGLRU, x, state: Dict, rg: RGLRUConfig):
    """Single-token step.  x: (B, 1, D) → (B, 1, D), new state.  The conv
    sums its taps in float32 here (the reference's decode does; its prefill
    sums in the activations' dtype)."""
    gate = _gelu(x[:, 0] @ p.w_gate)
    xr = x[:, 0] @ p.w_x
    window = torch.cat([state["conv"], xr[:, None, :].float()], dim=1)
    xc = (window * p.conv_w[None].float()).sum(1) + p.conv_b.float()
    a, b = _rglru_gates(p, xc)
    h = a * state["h"] + b
    y = h.to(x.dtype) * gate
    out = (y @ p.w_out)[:, None, :]
    return out.to(x.dtype), {"conv": window[:, 1:, :], "h": h}
