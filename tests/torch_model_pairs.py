"""Model pairs for the port's MoE/MLA parity tests: one set of weights in
both packages, the reference's routing recorded beside the port's, and a
prefill-then-decode run held against the JAX package.

The weights are drawn by the port (``init_params``, a seeded
``torch.Generator``) and written into the reference's parameter pytree,
whose structure comes from ``jax.eval_shape`` of its ``init_params``: no
JAX init is compiled.  ``convert.model_params_from_reference`` (the other
direction) is held by the tests that draw with the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=0.08, atol=0.35)}
B, S, STEPS = 2, 64, 4


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, dtype=np.float32))


def cfgs(arch, dtype, **kw):
    """The reduced config in both packages (equal field for field)."""
    ref = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype,
                              **kw)
    port = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype,
                               **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def leaf_name(path):
    """A reference pytree path as its ``/``-joined name."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def reference_params(params, rcfg):
    """The reference pytree (numpy leaves of its dtypes) holding the port
    model's values: ``PT.param_tree`` names every leaf by its reference
    path (``stack`` leaves stacked over the layers, ``(L // pat, pat)``
    under a local/global pattern); the tree's structure is the reference's
    ``init_params`` under ``jax.eval_shape``."""
    flat = PT.param_tree(params)
    shapes = jax.eval_shape(lambda k: RT.init_params(rcfg, k),
                            jax.random.PRNGKey(0))

    def leaf(path, shape):
        a = flat.pop(leaf_name(path)).float().numpy().astype(shape.dtype)
        assert a.shape == shape.shape
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    assert not flat
    return tree


def model_pair(arch, dtype, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params) on one set
    of weights, the port's draw."""
    rcfg, cfg = cfgs(arch, dtype, **kw)
    params = PT.init_params(cfg, seed=seed, device="cpu")
    rparams = reference_params(params, rcfg)
    assert PT.num_params(params) == RT.num_params(rparams)
    return rcfg, cfg, rparams, params


class RouteRecorder:
    """Records every ``_route`` call's (ids, keep, pos) in both packages:
    the port's by wrapping it, the reference's through an ordered
    ``jax.debug.callback`` (it runs under ``jit`` and ``lax.scan``)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        real_r, real_p = RM._route, PM._route

        def ref_route(gates, moe, caps):
            out = real_r(gates, moe, caps)
            ids, _, keep, pos = out
            jax.debug.callback(lambda *a: self.ref.append(
                tuple(np.asarray(x) for x in a)), ids, keep, pos,
                ordered=True)
            return out

        def port_route(gates, moe, caps):
            out = real_p(gates, moe, caps)
            self.port.append(tuple(out[i].numpy() for i in (0, 2, 3)))
            return out

        monkeypatch.setattr(RM, "_route", ref_route)
        monkeypatch.setattr(PM, "_route", port_route)

    def assert_equal(self):
        """Every call so far routed alike in both; then forget them."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        for r, p in zip(self.ref, self.port):
            for name, a, b in zip(("ids", "keep", "pos"), r, p):
                np.testing.assert_array_equal(b, a, err_msg=name)
        self.ref.clear()
        self.port.clear()


def tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def pad_cache(cache, cfg, extra):
    """The reference's prefill cache zero-padded by ``extra`` positions
    along the layout's position axis (what ``grow_cache`` does)."""
    axis = -2 if cfg.mla is not None else -3

    def pad(x):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, extra)
        return jnp.pad(x, widths)

    out = {"pos": cache["pos"],
           "layers": tuple(pad(x) for x in cache["layers"])}
    if "prefix" in cache:
        out["prefix"] = [tuple(pad(x) for x in e) for e in cache["prefix"]]
    return out


def cache_tensors(cache):
    """The stack's tensors, then the prefix's."""
    return list(cache["layers"]) + [x for e in cache.get("prefix", [])
                                    for x in e]


def run_prefill_and_decode(arch, dtype, monkeypatch=None, **kw):
    """Prefill of 2 × 64 tokens (two dispatch groups at the reduced
    ``tokens_per_group`` of 64), then 4 decode steps (one group of 2) on
    the prefill's cache zero-padded to 68 positions.  With
    ``monkeypatch`` each MoE layer's routing is held equal first."""
    rcfg, cfg, rparams, params = model_pair(arch, dtype, **kw)
    rec = RouteRecorder(monkeypatch) if monkeypatch is not None else None
    toks = tokens(cfg, S + STEPS)
    tol, vocab = TOL[dtype], cfg.vocab_size
    rprefill = jax.jit(lambda p, b: RT.prefill(p, b, rcfg))
    rcache, rlogits = rprefill(rparams, {"tokens": jnp.asarray(toks[:, :S])})
    cache, logits = PT.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg)
    if rec:
        rec.assert_equal()
    assert cache["pos"] == int(rcache["pos"]) == S - 1
    np.testing.assert_allclose(as_np(logits[:, :vocab]),
                               as_np(rlogits[:, :vocab]), **tol)
    rcache = pad_cache(rcache, cfg, STEPS)
    cache = PT.grow_cache(cfg, cache, S + STEPS)
    rstep = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rcfg))
    for i in range(S, S + STEPS):
        t = toks[:, i:i + 1]
        rlogits, rcache = rstep(rparams, rcache, jnp.asarray(t))
        logits, cache = PT.decode_step(params, cache, torch.from_numpy(t),
                                       cfg)
        if rec:
            rec.assert_equal()
        np.testing.assert_allclose(as_np(logits[:, :vocab]),
                                   as_np(rlogits[:, :vocab]), **tol)
        assert cache["pos"] == int(rcache["pos"]) == i
    for a, b in zip(cache_tensors(cache), cache_tensors(rcache)):
        assert a.shape == b.shape and a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_np(a), as_np(b), **tol)


# ---------------------------------------------------------------------------
# Training: the port's gradients and optimizer state beside the reference's
# ---------------------------------------------------------------------------


def t(a):
    return torch.from_numpy(np.asarray(a))


def flat_ref(tree):
    """A reference pytree as ``{path: numpy array}``."""
    return {leaf_name(path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def stacked(params, per_name):
    """``{name: tensor}`` of the port's parameters as the reference's
    leaves, ``{path: numpy array}``."""
    named = dict(params.named_parameters())
    out = {}
    for path, names, lead in PT.reference_leaves(params):
        rows = [per_name[n].detach().float() for n in names]
        out[path] = (torch.stack(rows).reshape(lead + named[names[0]].shape)
                     if lead else rows[0]).numpy()
    return out


def close_to_leaf(got, want, rel, what=""):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of the leaf's max > {rel}"


def batch_np(cfg, seed=3, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return {"tokens": toks, "labels": labels}


def hotness_np(cfg, seed=4):
    if cfg.moe is None:
        return None
    rows = cfg.num_layers - cfg.moe.first_dense_layers
    return (np.random.default_rng(seed).random(
        (rows, cfg.moe.num_experts)) * 50).astype(np.float32)


def assert_hotness(got, want, hot, cfg):
    """The port's new hotness is ``α·hotness + counts`` in float32, each
    operation rounded, with the reference's counts (whole numbers: the
    reference's value rounded recovers them); the reference's own value
    comes from ``jit``, where XLA fuses the two operations on the CPU and
    may land one ulp off."""
    alpha = np.float32(cfg.moe.fish_alpha)
    want = np.asarray(want)
    counts = np.rint(want - alpha * hot).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), alpha * hot + counts)
    np.testing.assert_array_max_ulp(got.numpy(), want, 1)


def assert_same_leaves(got, want):
    """Two trees' leaves ({path: array}) equal bit for bit."""
    assert list(got) == list(want)
    for path in want:
        a, b = np.asarray(got[path]), np.asarray(want[path])
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a.reshape(-1).view(np.uint8),
                              b.reshape(-1).view(np.uint8)), path


def as_numpy(x):
    """A tensor or array as numpy, bfloat16 as its bits (int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_adam_step_close(got_p, want_p, want_m, lr):
    """Parameters after one Adam step from gradients that agree within
    float32 rounding: within 1e-4 of the leaf's largest magnitude wherever
    the reference's m (a multiple of the gradient) exceeds 1e-3 of its
    leaf's largest; elsewhere within 2·lr.  Adam's first step moves an
    element by lr·g/(|g| + eps), so a rounding of a near-zero gradient can
    move it by up to ±lr whatever the gradients' agreement."""
    for path, want in want_p.items():
        got, m = got_p[path], np.abs(want_m[path])
        scale = max(float(np.abs(want).max()), 1e-30)
        err = np.abs(got - want)
        stable = m > 1e-3 * m.max()
        assert float(err[stable].max(initial=0.0)) <= 1e-4 * scale, path
        assert float(err.max()) <= 2 * lr + 1e-4 * scale, path
