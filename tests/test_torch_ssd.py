"""The port's SSD scan (K4/K5 plain versions + the cross-chunk combine)
against the JAX package.

On the CPU ``ops.ssd_scan`` runs the plain versions of ``ssd_chunk_state``
and ``ssd_chunk_output``; here it meets the reference's ``ops.ssd_scan``
with the Pallas kernels (interpret mode) and the sequential oracle
``ssd_ref`` on the same numpy-seeded inputs, within 3e-4
(``tests/test_kernels.py``'s bound: the chunked form sums in another order
than the recurrence).  The CUDA kernels are held against the plain versions
on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ssd as rssd
from repro.kernels.ref import ssd_ref as jax_ssd_ref
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
