"""Shared model building blocks of the port: norms, RoPE and Qwen2-VL's
multimodal RoPE, soft-capping and activations, as the JAX package's
``models/common.py`` has them."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "nonparametric_layer_norm",
           "apply_norm", "soft_cap", "rope_freqs", "apply_rope",
           "mrope_streams", "apply_mrope", "activation_fn", "dtype_of"]


def dtype_of(name: str) -> torch.dtype:
    """A config's ``dtype`` string (``"bfloat16"``, ``"float32"``, ...)."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, *, plus_one: bool = False):
    """RMS norm in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        s = scale.float()
        y = y * (1.0 + s if plus_one else s)
    return y.to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def nonparametric_layer_norm(x, eps: float = 1e-5):
    """OLMo-style LN without learnable scale/bias (arXiv:2402.00838)."""
    return layer_norm(x, None, None, eps)


def apply_norm(x, scale, kind: str, eps: float = 1e-6, bias=None):
    """Dispatch on the config's norm kind (``scale`` and ``bias`` are the
    norm's weights; the JAX package passes them as ``{"scale", "bias"}``)."""
    if kind == "rmsnorm":
        return rms_norm(x, scale, eps)
    if kind == "rmsnorm_plus_one":  # gemma convention: weight stored as w-1
        return rms_norm(x, scale, eps, plus_one=True)
    if kind == "layernorm":
        return layer_norm(x, scale, bias, eps)
    if kind == "nonparametric":
        return nonparametric_layer_norm(x, eps)
    raise ValueError(f"unknown norm kind {kind!r}")


def soft_cap(x, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def _rotate(x, sin, cos):
    """The split-half rotation: (x1, x2) → (x1·cos − x2·sin, x2·cos + x1·sin)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q, k, positions, *, theta: float = 10_000.0):
    """Standard RoPE over the whole head, in float32, cast back to the
    inputs' dtype.  q/k: (B, S, H, dh); positions: (B, S) int."""
    inv = rope_freqs(q.shape[-1], theta, device=q.device)  # (dh/2,)
    angles = positions[..., None].float() * inv  # (B, S, dh/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    return tuple(_rotate(x.float(), sin, cos).to(x.dtype) for x in (q, k))


def mrope_streams(sections: Sequence[int], half: int) -> List[int]:
    """The position stream (0 temporal, 1 height, 2 width) that drives each
    of the ``half`` frequency slots: ``sections[i]`` slots of stream ``i``
    in order, cut at ``half`` when they sum to more and padded with stream
    2 when they sum to less — the rule of the JAX package's
    ``jnp.repeat(arange(3), sections, total_repeat_length=half)``."""
    idx = [i for i, n in enumerate(sections) for _ in range(n)][:half]
    return idx + [2] * (half - len(idx))


def apply_mrope(q, k, positions, sections: Sequence[int], *,
                theta: float = 1_000_000.0):
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191), in float32, cast back
    to the inputs' dtype.

    q/k: (B, S, H, dh); positions: (3, B, S) int — the temporal, height
    and width position ids.  The rotary spectrum's dh/2 slots are split
    into ``sections`` (half-dim units, e.g. (16, 24, 24) at head_dim 128;
    :func:`mrope_streams`) and each slot takes its angle from its stream.
    """
    half = q.shape[-1] // 2
    inv = rope_freqs(q.shape[-1], theta, device=q.device)  # (dh/2,)
    angles = positions[..., None].float() * inv  # (3, B, S, dh/2)
    idx = torch.tensor(mrope_streams(sections, half), device=q.device)
    angles = angles.gather(0, idx.expand(1, *angles.shape[1:]))[0]
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    return tuple(_rotate(x.float(), sin, cos).to(x.dtype) for x in (q, k))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]
