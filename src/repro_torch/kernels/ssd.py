"""Mamba-2 SSD chunk kernels: the hand-written CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device.

Replaces ``src/repro/kernels/ssd.py``: ``ssd_chunk_state`` (K4, each
chunk's own state ``S = Σᵢ exp(A_tot − a_cumᵢ)·bᵢ⊗xᵢ`` and ``A_tot``) and
``ssd_chunk_output`` (K5, the chunk-local quadratic part plus the carried
state's contribution, ``y = ((C·Bᵀ)∘L)·X + (C·exp(a_cum))·S_prev``).
:func:`repro_torch.kernels.ops.ssd_scan` runs them with the cross-chunk
combine between.

* **Kernels** (``csrc/ssd.cu``): every product on the tensor cores
  (``mma.sync`` m16n8k8, each float32 operand split into two TF32 parts,
  three passes, float32 accumulation), operands staged by ``cp.async``
  into double-buffered shared-memory tiles; K4 one block per (chunk,
  head), K5 one block per (chunk, 64 rows of y, up to 8 heads of one
  group, which share the scores C·Bᵀ).
* **Plain versions**: the same chunk algebra as einsums.

For a CUDA tensor a wrapper launches its kernel (or raises); only a CPU
tensor takes the plain version.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ssd_chunk_state", "ssd_chunk_output", "ssd_chunk_state_plain",
           "ssd_chunk_output_plain", "check_kernel_shape", "LAUNCHES",
           "MAX_Q", "MAX_N", "MAX_P"]

#: kernel launches, counted where the wrappers launch
LAUNCHES = {"ssd_chunk_state": 0, "ssd_chunk_output": 0}

#: the kernels' limits (``csrc/ssd.cu``): chunk, state size (a multiple
#: of 16: K4's warps own 16-row strips), head dim (a multiple of 8: the
#: MMA's column tile)
MAX_Q, MAX_N, MAX_P = 256, 128, 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "ssd_chunk_state": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "ssd_chunk_output": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                         _P),
}


def _check(name, x, b, a_cum, c=None, prev=None):
    bc, q, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    want = {"x": (x, (bc, q, h, p)), "b": (b, (bc, q, g, n)),
            "a_cum": (a_cum, (bc, q, h))}
    if c is not None:
        want["c"] = (c, (bc, q, g, n))
    if prev is not None:
        want["prev_states"] = (prev, (bc, h, n, p))
    for arg, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: {arg} must be float32 {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors on one device")
    if g < 1 or h % g:
        raise ValueError(f"{name}: {h} heads do not split into {g} groups")
    if x.device.type == "cuda":
        check_kernel_shape(name, q, n, p)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return bc, q, h, p, g, n


def check_kernel_shape(name, q, n, p):
    """Raise unless the CUDA kernels take chunk ``q``, state size ``n`` and
    head dim ``p``."""
    if not (1 <= q <= MAX_Q and 16 <= n <= MAX_N and n % 16 == 0
            and 8 <= p <= MAX_P and p % 8 == 0):
        raise ValueError(f"{name}: the kernel takes 1 <= chunk <= {MAX_Q}, "
                         f"d_state a multiple of 16 up to {MAX_N} and a head"
                         f" dim a multiple of 8 up to {MAX_P}; got Q={q} "
                         f"N={n} P={p}")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels stage rows by
    16-byte copies); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _per_head(t, h):
    """(BC, Q, G, N) → (BC, Q, H, N): head h reads group h // (H/G)."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_chunk_state_plain(x, b, a_cum):
    a_tot = a_cum[:, -1, :]
    decay = torch.exp(a_tot[:, None, :] - a_cum)  # (BC, Q, H)
    bw = _per_head(b, x.shape[2]) * decay[..., None]
    states = torch.einsum("bqhn,bqhp->bhnp", bw, x)
    return states, a_tot.contiguous()


def ssd_chunk_output_plain(x, b, c, a_cum, prev_states):
    q, h = x.shape[1], x.shape[2]
    bh, ch = _per_head(b, h), _per_head(c, h)
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    rel = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # (BC, Q, Q, H)
    # exp only where i >= j: above the diagonal it would overflow to inf
    l_mat = torch.where(mask[None, :, :, None],
                        torch.exp(rel.masked_fill(~mask[None, :, :, None],
                                                  0.0)), 0.0)
    scores = torch.einsum("bihn,bjhn->bijh", ch, bh)
    y_diag = torch.einsum("bijh,bjhp->bihp", scores * l_mat, x)
    c_decayed = ch * torch.exp(a_cum)[..., None]
    y_off = torch.einsum("bihn,bhnp->bihp", c_decayed, prev_states)
    return y_diag + y_off


def ssd_chunk_state(x, b, a_cum):
    """Per-chunk SSD states (K4).

    x:     (BC, Q, H, P) chunked inputs, batch·chunks leading
    b:     (BC, Q, G, N) input projections; heads share groups
    a_cum: (BC, Q, H)    inclusive within-chunk cumsum of the log decay
    returns states (BC, H, N, P) and a_total (BC, H), float32.
    """
    bc, q, h, p, g, n = _check("ssd_chunk_state", x, b, a_cum)
    if x.device.type == "cpu":
        return ssd_chunk_state_plain(x, b, a_cum)
    x, b, a_cum = _aligned(x), _aligned(b), a_cum.contiguous()
    states = torch.empty((bc, h, n, p), dtype=torch.float32, device=x.device)
    a_tot = torch.empty((bc, h), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd", _SIGS)
    err = lib.ssd_chunk_state(x.data_ptr(), b.data_ptr(), a_cum.data_ptr(),
                              bc, q, h, p, g, n, states.data_ptr(),
                              a_tot.data_ptr(), _build.stream_ptr(x.device))
    _build.check(err, "ssd_chunk_state")
    LAUNCHES["ssd_chunk_state"] += 1
    return states, a_tot


def ssd_chunk_output(x, b, c, a_cum, prev_states):
    """Chunk-local output plus the carried state's contribution (K5).

    x: (BC, Q, H, P); b, c: (BC, Q, G, N); a_cum: (BC, Q, H);
    prev_states: (BC, H, N, P), the state entering each chunk.
    returns y (BC, Q, H, P) float32.
    """
    bc, q, h, p, g, n = _check("ssd_chunk_output", x, b, a_cum, c,
                               prev_states)
    if x.device.type == "cpu":
        return ssd_chunk_output_plain(x, b, c, a_cum, prev_states)
    x, b, c = _aligned(x), _aligned(b), _aligned(c)
    a_cum, prev_states = a_cum.contiguous(), _aligned(prev_states)
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd", _SIGS)
    err = lib.ssd_chunk_output(x.data_ptr(), b.data_ptr(), c.data_ptr(),
                               a_cum.data_ptr(), prev_states.data_ptr(), bc,
                               q, h, p, g, n, y.data_ptr(),
                               _build.stream_ptr(x.device))
    _build.check(err, "ssd_chunk_output")
    LAUNCHES["ssd_chunk_output"] += 1
    return y
