"""The port's SSD scan (K4/K5 plain versions + the cross-chunk combine)
against the JAX package.

On the CPU ``ops.ssd_scan`` runs the plain versions of ``ssd_chunk_state``
and ``ssd_chunk_output``; here it meets the reference's ``ops.ssd_scan``
with the Pallas kernels (interpret mode) and the sequential oracle
``ssd_ref`` on the same numpy-seeded inputs, within 3e-4
(``tests/test_kernels.py``'s bound: the chunked form sums in another order
than the recurrence).  The CUDA kernels are held against the plain versions
on the card by ``tests/test_torch_cuda.py``; here their arithmetic (split
TF32 on the tensor cores) is held against float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ssd as rssd
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import ssd as pssd

import torch_helpers  # noqa: F401  (caps torch threads)

TOL = dict(rtol=3e-4, atol=3e-4)


def _inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, s, h))) * 0.1).astype(np.float32)
    bb = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    cc = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(b, h, n, p)) * 0.5).astype(np.float32)
    return x, a, bb, cc, s0


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,carry", [
    (1, 64, 2, 16, 1, 16, 16, False),
    (2, 128, 4, 32, 2, 32, 32, True),
    (1, 100, 4, 16, 1, 16, 32, True),   # ragged: padded to a chunk multiple
    (1, 128, 8, 64, 4, 32, 128, False),  # chunk == seq
])
def test_ssd_scan_matches_pallas_and_sequential(b, s, h, p, g, n, chunk,
                                                carry):
    x, a, bb, cc, s0 = _inputs(b, s, h, p, g, n, seed=s + h)
    init = s0 if carry else None
    y_k, f_k = rops.ssd_scan(*map(jnp.asarray, (x, a, bb, cc)), chunk=chunk,
                             impl="pallas",
                             initial_state=None if init is None
                             else jnp.asarray(init))
    y_r, f_r = jax_ssd_ref(*map(jnp.asarray, (x, a, bb, cc)),
                           initial_state=None if init is None
                           else jnp.asarray(init))
    args = [torch.from_numpy(t) for t in (x, a, bb, cc)]
    y, f = pops.ssd_scan(*args, chunk=chunk,
                         initial_state=None if init is None
                         else torch.from_numpy(init))
    for port, want in ((y, y_k), (f, f_k), (y, y_r), (f, f_r)):
        _close(port, want)
    # the port's own oracles agree with the reference's
    y_s, f_s = pref.ssd_ref(*args, initial_state=None if init is None
                            else torch.from_numpy(init))
    _close(y_s, y_r)
    _close(f_s, f_r)
    if s % chunk == 0:
        y_c, f_c = pref.ssd_chunked_ref(*args, chunk, initial_state=None
                                        if init is None
                                        else torch.from_numpy(init))
        _close(y_c, y_r)
        _close(f_c, f_r)


def test_ssd_chunk_kernels_plain_match_pallas():
    """Each chunk kernel's plain version against its Pallas kernel on the
    same chunked inputs (grouped heads: H = 4 over G = 2)."""
    rng = np.random.default_rng(11)
    bc, q, h, p, g, n = 3, 32, 4, 16, 2, 16
    x = rng.normal(size=(bc, q, h, p)).astype(np.float32)
    b = (rng.normal(size=(bc, q, g, n)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(bc, q, g, n)) * 0.3).astype(np.float32)
    a_cum = np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.1,
                      axis=1).astype(np.float32)
    prev = rng.normal(size=(bc, h, n, p)).astype(np.float32)
    st_k, at_k = rssd.ssd_chunk_state(*map(jnp.asarray, (x, b, a_cum)),
                                      interpret=True)
    y_k = rssd.ssd_chunk_output(*map(jnp.asarray, (x, b, c, a_cum, prev)),
                                interpret=True)
    T = torch.from_numpy
    st, at = pssd.ssd_chunk_state(T(x), T(b), T(a_cum))
    y = pssd.ssd_chunk_output(T(x), T(b), T(c), T(a_cum), T(prev))
    for port, want in ((st, st_k), (at, at_k), (y, y_k)):
        _close(port, want)
    assert pssd.LAUNCHES == {"ssd_chunk_state": 0, "ssd_chunk_output": 0}


def test_ssd_bf16_inputs_follow_f32():
    x, a, bb, cc, _ = _inputs(1, 64, 2, 16, 1, 16, seed=5)
    T = torch.from_numpy
    y32, _ = pops.ssd_scan(T(x), T(a), T(bb), T(cc), chunk=16)
    y16, _ = pops.ssd_scan(T(x).bfloat16(), T(a), T(bb).bfloat16(),
                           T(cc).bfloat16(), chunk=16)
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_ssd_wrappers_reject_bad_input():
    x = torch.zeros(2, 16, 4, 8)
    b = torch.zeros(2, 16, 3, 8)  # 4 heads do not split into 3 groups
    with pytest.raises(ValueError, match="groups"):
        pssd.ssd_chunk_state(x, b, torch.zeros(2, 16, 4))
    with pytest.raises(TypeError, match="float32"):
        pssd.ssd_chunk_state(x.double(), b, torch.zeros(2, 16, 4))


# -- the CUDA kernels' arithmetic: 3xTF32 on the tensor cores -----------------


def _tf32(v):
    """float32 → TF32 as the kernels make it: the low 13 mantissa bits
    cleared."""
    bits = np.asarray(v, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)  # v - hi is exact in float32


def _mma(acc, a, b, passes):
    """acc (..., M, P) float32 += a (..., M, K) @ b (..., K, P) as the
    kernels' m16n8k8 MMAs do it: K in steps of 8, each step's TF32 products
    summed exactly and added to the float32 accumulator, for each pass
    (three: lo·hi, hi·lo, hi·hi; or one: hi·hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k in range(0, a.shape[-1], 8):
        for u, v in terms:
            part = (u[..., k:k + 8].astype(np.float64)
                    @ v[..., k:k + 8, :].astype(np.float64))
            acc = (acc + part).astype(np.float32)
    return acc


def _tc_state(x, b, a_cum, passes):
    """K4 on the tensor cores (states) and in float64."""
    h, g = x.shape[2], b.shape[2]
    w = np.exp(a_cum[:, -1:, :] - a_cum).astype(np.float32)
    bw = (np.repeat(b, h // g, axis=2) * w[..., None]).astype(np.float32)
    lhs = bw.transpose(0, 2, 3, 1)   # (BC, H, N, Q)
    rhs = x.transpose(0, 2, 1, 3)    # (BC, H, Q, P)
    want = lhs.astype(np.float64) @ rhs.astype(np.float64)
    got = _mma(np.zeros(want.shape, np.float32), lhs, rhs, passes)
    return got, want


def _tc_output(x, b, c, a_cum, prev, passes):
    """K5 on the tensor cores (y, in the kernel's order: the carried state,
    then the masked, decayed scores times x) and in float64."""
    q, h, g = x.shape[1], x.shape[2], b.shape[2]
    bh = np.repeat(b, h // g, axis=2).transpose(0, 2, 1, 3)  # (BC, H, Q, N)
    ch = np.repeat(c, h // g, axis=2).transpose(0, 2, 1, 3)
    at = a_cum.transpose(0, 2, 1)                             # (BC, H, Q)
    mask = np.tril(np.ones((q, q), bool))
    rel = np.where(mask, at[..., :, None] - at[..., None, :], 0.0)
    l_mat = np.where(mask, np.exp(rel.astype(np.float32)), 0.0).astype(
        np.float32)
    c_dec = (ch * np.exp(at)[..., None]).astype(np.float32)
    xt = x.transpose(0, 2, 1, 3)
    scores = ch.astype(np.float64) @ bh.astype(np.float64).swapaxes(-1, -2)
    want = ((scores * l_mat) @ xt
            + c_dec.astype(np.float64) @ prev.astype(np.float64))
    got = _mma(np.zeros(want.shape, np.float32), c_dec, prev, passes)
    s = _mma(np.zeros(scores.shape, np.float32), ch,
             np.ascontiguousarray(bh.swapaxes(-1, -2)), passes)
    got = _mma(got, (s * l_mat).astype(np.float32), xt, passes)
    return got, want


def _worst(got, want):
    """Largest |got - want| over its allowance atol + rtol·|want|."""
    gap = np.abs(got.astype(np.float64) - want)
    return float((gap / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


@pytest.mark.parametrize("bc,q,h,p,g,n", [
    (2, 128, 48, 64, 1, 128),   # mamba2-780m's tile
    (3, 32, 4, 16, 2, 16),      # a small one, grouped heads
])
def test_split_tf32_products_hold_the_ssd_bound(bc, q, h, p, g, n):
    """The CUDA kernels' arithmetic: each float32 operand split into TF32
    hi and lo parts, three tensor-core passes, float32 accumulation.

    On the inputs of ``test_cuda_ssd_chunk_kernels_match_plain`` (same
    shapes and seeds) that stays within rtol = atol = 3e-4 of float64 at
    about 1 % of the allowance.  A single TF32 pass does not: K4 and K5
    miss by 4.7x and 12.5x at mamba2-780m's tile (2.8x and 5.4x at the
    small one).  That is why the kernels pay for three passes."""
    rng = np.random.default_rng(q + h)
    f32 = (lambda a: a.astype(np.float32))
    x = f32(rng.normal(size=(bc, q, h, p)))
    b = f32(rng.normal(size=(bc, q, g, n)) * 0.3)
    c = f32(rng.normal(size=(bc, q, g, n)) * 0.3)
    a_cum = f32(np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.5,
                          axis=1))
    prev = f32(rng.normal(size=(bc, h, n, p)))
    for passes, holds in ((3, True), (1, False)):
        worst_state = _worst(*_tc_state(x, b, a_cum, passes))
        worst_out = _worst(*_tc_output(x, b, c, a_cum, prev, passes))
        if holds:
            assert worst_state < 0.05 and worst_out < 0.05
        else:
            assert worst_state > 1.0 and worst_out > 1.0
    # the plain version (float32 einsums) sits inside the bound too
    st, _ = pssd.ssd_chunk_state_plain(*map(torch.from_numpy, (x, b, a_cum)))
    assert _worst(st.numpy(), _tc_state(x, b, a_cum, 3)[1]) < 1.0


@pytest.mark.parametrize("q,n,p", [
    (128, 128, 72),   # head dim past 64
    (128, 136, 64),   # state past 128
    (128, 24, 64),    # state not a multiple of 16
    (128, 128, 12),   # head dim not a multiple of 8
    (257, 128, 64),   # chunk past 256
])
def test_ssd_kernel_shape_limits(q, n, p):
    """The shapes the CUDA kernels refuse raise before any launch; every
    shape the port runs passes: each config's chunk, state size and head
    dim, full and reduced, and the card tests' cases."""
    with pytest.raises(ValueError, match="kernel takes"):
        pssd.check_kernel_shape("ssd_chunk_state", q, n, p)
    runs = {(128, 128, 64), (16, 16, 16), (32, 16, 16), (48, 32, 32),
            (100, 32, 32), (1, 16, 8), (256, 128, 64)}
    for arch in list_archs():
        for cfg in (get_config(arch), reduced_config(get_config(arch))):
            if cfg.ssm is not None:
                runs.add((cfg.ssm.chunk, cfg.ssm.d_state, cfg.ssm.head_dim))
    for shape in sorted(runs):
        pssd.check_kernel_shape("ssd_chunk_state", *shape)
