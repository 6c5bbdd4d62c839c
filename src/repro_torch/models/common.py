"""Shared model building blocks of the port: what the Mamba-2 path uses
(the JAX package's ``models/common.py`` has the rest of the zoo's)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm", "apply_norm", "dtype_of"]


def dtype_of(name: str) -> torch.dtype:
    """A config's ``dtype`` string (``"bfloat16"``, ``"float32"``, ...)."""
    return getattr(torch, name)


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


def apply_norm(x, scale, kind: str, eps: float = 1e-6):
    """Dispatch on the config's norm kind (``scale`` is the norm's weight;
    the JAX package passes it as ``{"scale": ...}``)."""
    if kind == "rmsnorm":
        return rms_norm(x, scale, eps)
    if kind == "rmsnorm_plus_one":  # gemma convention: weight stored as w-1
        return rms_norm(x, scale, eps, plus_one=True)
    raise ValueError(f"norm kind {kind!r} is not ported (the SSM family "
                     "uses rmsnorm)")
