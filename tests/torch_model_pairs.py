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


def reference_params(params, rcfg):
    """The reference pytree (numpy leaves of its dtypes) holding the port
    model's values: ``layers.<i>.<path>`` → ``stack[path][i]``,
    ``prefix.<j>.<path>`` → ``prefix[j][path]``, the rest by path."""
    shapes = jax.eval_shape(lambda k: RT.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    for name, p in params.named_parameters():
        head, *rest = name.split(".")
        if head == "layers":
            node, index, path = tree["stack"], int(rest[0]), rest[1:]
        elif head == "prefix":
            node, index, path = tree["prefix"][int(rest[0])], None, rest[1:]
        else:
            node, index, path = tree, None, [head, *rest]
        for part in path[:-1]:
            node = node[part]
        leaf = node[path[-1]]
        value = p.detach().float().numpy().astype(leaf.dtype)
        if index is None:
            node[path[-1]] = value
        else:
            leaf[index] = value
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
