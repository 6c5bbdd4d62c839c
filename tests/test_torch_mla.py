"""DeepSeek-V2 multi-head latent attention (MLA) and the deepseek-v2-lite
model in the port against the JAX package: ``mla_expand``,
``mla_decode_scores``, ``_mla_block``, the model at ``reduced_config``
(prefill then 4 decode steps), its caches (``grow_cache`` on the MLA
layout, the decode clamp past a cache's end), ``convert`` on an MoE
model, the MoE/MLA init's distributions and ``serve()``.

Inputs are made with numpy from a seed; the port runs on
``device="cpu"``.  Tolerances: the MLA functions in float32 within 1e-5
(the same products summed in another order); the model in float32 within
1e-3 after its routing is held equal, in bfloat16 within
``tests/test_models_smoke.py``'s 0.08 / 0.35.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as pserve
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT

import torch_helpers  # noqa: F401  (caps torch threads)
import torch_model_pairs as pairs

TOL = pairs.TOL
MLA_TOL = dict(rtol=1e-5, atol=1e-5)
DEEPSEEK = "deepseek-v2-lite-16b"
# compiled once: the position is traced, the scale static
REF_DECODE_SCORES = jax.jit(RA.mla_decode_scores, static_argnames="scale")


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mla_weights(seed, r=32, h=4, dn=16, dv=24):
    rng = np.random.default_rng(seed)
    return (_randn(rng, r, h, dn, scale=r ** -0.5),
            _randn(rng, r, h, dv, scale=r ** -0.5))


def test_mla_expand_matches_reference():
    w_uk, w_uv = _mla_weights(0)
    c_kv = _randn(np.random.default_rng(1), 2, 40, 32)
    want = RA.mla_expand(jnp.asarray(c_kv), jnp.asarray(w_uk),
                         jnp.asarray(w_uv))
    got = PA.mla_expand(*map(torch.from_numpy, (c_kv, w_uk, w_uv)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MLA_TOL)


@pytest.mark.parametrize("cur", [0, 23, 39])
def test_mla_decode_scores_match_reference(cur):
    """Weight-absorbed decode against a 40-slot latent cache whose slots
    past ``cur`` hold values that must be masked away."""
    w_uk, w_uv = _mla_weights(2)
    rng = np.random.default_rng(3)
    q_nope, q_rope = _randn(rng, 2, 4, 16), _randn(rng, 2, 4, 8)
    ckv, krope = _randn(rng, 2, 40, 32), _randn(rng, 2, 40, 8)
    args = (q_nope, q_rope, ckv, krope, w_uk, w_uv)
    scale = 1.0 / math.sqrt(16 + 8)
    want = REF_DECODE_SCORES(*map(jnp.asarray, args), jnp.int32(cur),
                             scale=scale)
    got = PA.mla_decode_scores(*map(torch.from_numpy, args), cur_pos=cur,
                               scale=scale)
    assert got.shape == (2, 1, 4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLA_TOL)


def test_mla_block_matches_reference():
    """The expanded (prefill) MLA of the reduced deepseek, its output and
    its compressed cache entries (c_kv, k_rope)."""
    rcfg, cfg = pairs.cfgs(DEEPSEEK, "float32")
    params = PT.init_params(cfg, seed=3, device="cpu")
    rparams = pairs.reference_params(params, rcfg)
    h = _randn(np.random.default_rng(4), 2, 40, cfg.d_model)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    block = jax.jit(lambda p, x: RT._mla_block(p, x, rcfg, positions=pos))
    want = block(rparams["prefix"][0]["attn"], jnp.asarray(h))
    got = PT._mla_block(params.prefix[0].attn, torch.from_numpy(h), cfg,
                        positions=torch.from_numpy(pos.copy()))
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MLA_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_prefill_and_decode_match_reference(dtype, monkeypatch):
    """deepseek-v2-lite reduced: an MLA dense prefix layer, then an MLA +
    MoE layer; the routing held equal first in float32."""
    pairs.run_prefill_and_decode(
        DEEPSEEK, dtype, monkeypatch if dtype == "float32" else None)


def test_grow_cache_keeps_the_mla_layout():
    """Three MLA + MoE layers at batch 2: the stacked latent cache is
    (3, 2, S, R), so a batch read off the GQA layout's axis would take
    the layer count; the prefill's cache lands at the head of the grown
    one, zeros after it, the prefix's too."""
    _, cfg = pairs.cfgs(DEEPSEEK, "float32", num_layers=4)
    params = PT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(pairs.tokens(cfg, 32))
    cache, _ = PT.prefill(params, {"tokens": toks}, cfg)
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
    assert [tuple(t.shape) for t in cache["layers"]] == [(3, 2, 32, r),
                                                          (3, 2, 32, dr)]
    big = PT.grow_cache(cfg, cache, 40)
    assert big["pos"] == cache["pos"] == 31
    for src, dst in zip(pairs.cache_tensors(cache),
                        pairs.cache_tensors(big)):
        assert dst.shape[:-2] == src.shape[:-2]
        assert dst.shape[-2:] == (40, src.shape[-1])
        assert torch.equal(dst[..., :32, :], src)
        assert not dst[..., 32:, :].any()


def test_mla_decode_past_the_cache_end_keeps_the_reference_clamp():
    """A cache of 6 positions, 10 decode steps from ``pos = -1``: from
    step 6 on both packages overwrite slot 5 of the latent cache and mask
    no slot."""
    rcfg, cfg, rparams, params = pairs.model_pair(DEEPSEEK, "float32",
                                                  seed=3)
    toks = pairs.tokens(cfg, 10, seed=4)
    rcache = RT.init_cache(rcfg, pairs.B, 6)
    rcache["pos"] = jnp.int32(-1)
    cache = PT.init_cache(cfg, pairs.B, 6, device="cpu")
    cache["pos"] = -1
    rstep = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rcfg))
    for i in range(10):
        t = toks[:, i:i + 1]
        rlogits, rcache = rstep(rparams, rcache, jnp.asarray(t))
        logits, cache = PT.decode_step(params, cache, torch.from_numpy(t),
                                       cfg)
        np.testing.assert_allclose(
            pairs.as_np(logits[:, :cfg.vocab_size]),
            pairs.as_np(rlogits[:, :cfg.vocab_size]), **TOL["float32"])
    assert cache["pos"] == 9
    for got, want in zip(pairs.cache_tensors(cache),
                         pairs.cache_tensors(rcache)):
        np.testing.assert_allclose(pairs.as_np(got), pairs.as_np(want),
                                   **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_an_moe_model_bit_for_bit(dtype):
    """Port weights → the reference pytree → ``convert`` → the port again:
    every leaf equal, the prefix list and the float32 router included."""
    rcfg, cfg = pairs.cfgs(DEEPSEEK, dtype)
    params = PT.init_params(cfg, seed=2, device="cpu")
    back = convert.model_params_from_reference(
        pairs.reference_params(params, rcfg), cfg, device="cpu")
    got = dict(back.named_parameters())
    names = [n for n, _ in params.named_parameters()]
    assert "prefix.0.attn.kv_norm.scale" in names
    assert "layers.0.moe.shared.w_down" in names
    for name, want in params.named_parameters():
        assert got[name].dtype == want.dtype, name
        assert torch.equal(got[name], want), name
    assert got["layers.0.moe.router"].dtype == torch.float32


def test_moe_and_mla_init_draw_the_reference_distributions():
    """The reduced deepseek's MoE and MLA leaves (the experts' 3-D
    tensors and the latent up-projections have their own draws: std
    1/√fan_in of their first axis, the router 0.02) against the
    reference's ``init_moe_params`` and ``_init_mla``: other PRNGs, the
    same distributions; norms exactly."""
    rcfg, cfg = pairs.cfgs(DEEPSEEK, "float32")
    layer = PT.init_params(cfg, seed=7, device="cpu").layers[0]
    init_moe = jax.jit(lambda k: RM.init_moe_params(k, cfg.d_model,
                                                    rcfg.moe, jnp.float32))
    init_mla = jax.jit(lambda k: RT._init_mla(k, rcfg, jnp.float32))
    key = jax.random.PRNGKey(7)
    ref = {"moe": init_moe(key), "attn": init_mla(key)}
    for name, got in layer.named_parameters():
        if name.startswith(("ln1", "ln2")):
            continue
        want = ref
        for part in name.split("."):
            want = want[part]
        want = torch.from_numpy(np.asarray(want))
        assert got.shape == want.shape, name
        if want.std() == 0:
            assert torch.equal(got, want), name
        else:
            assert abs(got.std() / want.std() - 1) < 0.1, name
            assert abs(got.mean()) < 0.1 * want.std(), name


def test_serve_runs_the_reduced_deepseek_on_the_cpu():
    cfg = reduced_config(get_config(DEEPSEEK))
    params = PT.init_params(cfg, seed=0, device="cpu")
    eng, reps = pserve.serve(cfg, params, replicas=2, slots=4, requests=12,
                             device="cpu")
    assert len(eng.done) == 12
    m = eng.metrics()
    assert m.throughput_tokens > 0 and m.latency_p99 >= m.latency_p50
    for r in reps:
        assert r.cache["pos"] + 1 == r.tokens_generated // 4
        assert all(torch.isfinite(t).all()
                   for t in pairs.cache_tensors(r.cache))


def test_the_moe_archs_are_registered():
    for arch in (DEEPSEEK, "kimi-k2-1t-a32b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config(arch))
