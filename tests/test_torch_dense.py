"""The dense decoder family (qwen1.5-0.5b, starcoder2-3b, olmo-1b,
gemma2-2b) in the port against the JAX package.

Inputs are made with numpy from a seed; model weights are the reference's
parameter pytree carried over by ``convert.model_params_from_reference``;
the port runs on ``device="cpu"``.  Tolerances:

* ``flash_attention`` and ``decode_attention`` in float32 within 1e-5
  (both sum the same float32 products, in another order);
* the models at ``reduced_config``: float32 within 1e-3, bfloat16 within
  ``tests/test_models_smoke.py``'s 0.08 / 0.35 (the two frameworks round
  bf16 at other places), as ``tests/test_torch_mamba.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced
from repro.launch import serve as ref_serve
from repro.models import attention as RA
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as pserve
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT

import torch_helpers  # noqa: F401  (caps torch threads)

DENSE = ("qwen1.5-0.5b", "starcoder2-3b", "olmo-1b", "gemma2-2b")
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=0.08, atol=0.35)}
B, S, STEPS = 2, 40, 4


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(rep, seed, s=S, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, hkv * rep, dh)).astype(np.float32)
    k = rng.standard_normal((B, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, s, hkv, dh)).astype(np.float32)
    return q, k, v


MASKS = {"causal": {}, "window_softcap": dict(window=12, softcap=1.5,
                                              scale=0.3)}


@pytest.mark.parametrize("masking", list(MASKS))
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_flash_attention_matches_reference(rep, masking):
    """block_k 16 over 40 positions: the online softmax spans three
    blocks and pads the tail; GQA groups of ``rep`` query heads."""
    q, k, v = _qkv(rep, seed=rep)
    kw = MASKS[masking]
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, block_k=16, **kw)
    got = PA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_k=16, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("masking", list(MASKS))
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_decode_attention_matches_reference(rep, masking):
    """Slots past ``cur_pos`` hold values that must be masked away."""
    q, k, v = _qkv(rep, seed=10 + rep)
    q = q[:, :1]
    kw = MASKS[masking]
    for cur in (0, 29, S - 1):
        want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), cur, **kw)
        got = PA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), cur, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTN_TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype):
    ref = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype)
    port = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _pair(arch, dtype, seed=0):
    rcfg, cfg = _cfgs(arch, dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    assert PT.num_params(params) == RT.num_params(rparams)
    return rcfg, cfg, rparams, params


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in DENSE] + [
    ("qwen1.5-0.5b", "bfloat16"), ("gemma2-2b", "bfloat16")])
def test_dense_prefill_and_decode_match_reference(arch, dtype):
    """Prefill of 40 tokens (past gemma2's reduced window of 32), then 4
    decode steps on the prefill's cache zero-padded to 44 positions."""
    rcfg, cfg, rparams, params = _pair(arch, dtype)
    toks = _tokens(cfg, S + STEPS)
    tol, vocab = TOL[dtype], cfg.vocab_size

    rprefill = jax.jit(lambda p, b: RT.prefill(p, b, rcfg))
    rcache, rlogits = rprefill(rparams, {"tokens": jnp.asarray(toks[:, :S])})
    cache, logits = PT.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg)
    assert logits.shape == (B, PT.padded_vocab(cfg))
    assert cache["pos"] == int(rcache["pos"]) == S - 1
    np.testing.assert_allclose(_np(logits[:, :vocab]),
                               _np(rlogits[:, :vocab]), **tol)
    for got, want in zip(cache["layers"], rcache["layers"]):
        assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    pad = [(0, 0)] * rcache["layers"][0].ndim
    pad[-3] = (0, STEPS)
    rcache = {"pos": rcache["pos"], "layers": tuple(
        jnp.pad(x, pad) for x in rcache["layers"])}
    cache = PT.grow_cache(cfg, cache, S + STEPS)
    rstep = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rcfg))
    for i in range(S, S + STEPS):
        t = toks[:, i:i + 1]
        rlogits, rcache = rstep(rparams, rcache, jnp.asarray(t))
        logits, cache = PT.decode_step(params, cache, torch.from_numpy(t),
                                       cfg)
        np.testing.assert_allclose(_np(logits[:, :vocab]),
                                   _np(rlogits[:, :vocab]), **tol)
        assert cache["pos"] == int(rcache["pos"]) == i
    for got, want in zip(cache["layers"], rcache["layers"]):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("arch", ("mamba2-780m",) + DENSE)
def test_num_params_at_full_width_match_reference(arch):
    """The published widths, counted on the meta device against the
    reference's ``eval_shape``d pytree: no weight is made."""
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: RT.init_params(ref_get_config(arch), k),
                            jax.random.PRNGKey(0))
    model = PT.Model(cfg, device="meta")
    assert PT.num_params(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    names = {n for n, _ in model.named_parameters()}
    assert ("head" in names) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_draws_the_reference_distributions(arch):
    """Each parameter's mean and spread against the reference init's same
    leaf (other PRNGs: the same distributions, not the same numbers);
    norms and biases exactly."""
    rcfg, cfg = _cfgs(arch, "float32")
    ref = convert.model_params_from_reference(jax.tree_util.tree_map(
        np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(7))), cfg,
        device="cpu")
    port = dict(PT.init_params(cfg, seed=7, device="cpu").named_parameters())
    for name, want in ref.named_parameters():
        got = port[name]
        if want.std() == 0:
            assert torch.equal(got, want), name
        else:
            assert abs(got.std() / want.std() - 1) < 0.05, name
            assert abs(got.mean()) < 0.05 * want.std(), name


def test_dense_decode_past_the_cache_end_keeps_the_reference_clamp():
    """A cache of 6 positions, 10 decode steps from ``pos = -1``: from
    step 6 on both packages overwrite slot 5 and mask no slot (gemma2's
    window of 32 cuts nothing here)."""
    for arch in ("qwen1.5-0.5b", "gemma2-2b"):
        rcfg, cfg, rparams, params = _pair(arch, "float32", seed=3)
        toks = _tokens(cfg, 10, seed=4)
        rcache = RT.init_cache(rcfg, B, 6)
        rcache["pos"] = jnp.int32(-1)
        cache = PT.init_cache(cfg, B, 6, device="cpu")
        cache["pos"] = -1
        rstep = jax.jit(lambda p, c, t, rcfg=rcfg: RT.decode_step(p, c, t,
                                                                  rcfg))
        for i in range(10):
            t = toks[:, i:i + 1]
            rlogits, rcache = rstep(rparams, rcache, jnp.asarray(t))
            logits, cache = PT.decode_step(params, cache,
                                           torch.from_numpy(t), cfg)
            np.testing.assert_allclose(
                _np(logits[:, :cfg.vocab_size]),
                _np(rlogits[:, :cfg.vocab_size]), **TOL["float32"])
        assert cache["pos"] == 9
        for got, want in zip(cache["layers"], rcache["layers"]):
            np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_dense_decode_writes_the_cache_in_place():
    cfg = reduced_config(get_config("olmo-1b"))
    params = PT.init_params(cfg, seed=5, device="cpu")
    cache = PT.init_cache(cfg, B, 8, device="cpu")
    kept = [t.clone() for t in cache["layers"]]
    logits, after = PT.decode_step(params, cache, torch.zeros(
        (B, 1), dtype=torch.int32), cfg)
    assert after["pos"] == 1 and cache["pos"] == 0
    for old, t, new in zip(kept, cache["layers"], after["layers"]):
        assert new is t and not torch.equal(t, old)
        assert torch.equal(t[:, :, 2:], old[:, :, 2:])  # only slot 1 moved


def test_gemma2_softcaps_bound_logits():
    """tests/test_models_smoke.py:130-137, on the port."""
    cfg = reduced_config(get_config("gemma2-2b"))
    params = PT.init_params(cfg, seed=4, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 48, seed=6))
    cache, logits = PT.prefill(params, {"tokens": toks}, cfg)
    real = logits[:, :cfg.vocab_size]
    assert real.abs().max() <= cfg.logit_softcap + 1e-3
    cache = PT.grow_cache(cfg, cache, 52)
    for _ in range(4):
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        logits, cache = PT.decode_step(params, cache, tok, cfg)
        assert logits[:, :cfg.vocab_size].abs().max() <= \
            cfg.logit_softcap + 1e-3


def test_serve_runs_the_reduced_dense_model_on_the_cpu():
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    params = PT.init_params(cfg, seed=0, device="cpu")
    eng, reps = pserve.serve(cfg, params, replicas=2, slots=4, requests=12,
                             device="cpu")
    assert len(eng.done) == 12
    m = eng.metrics()
    assert m.throughput_tokens > 0 and m.latency_p99 >= m.latency_p50
    for r in reps:
        assert r.cache["pos"] + 1 == r.tokens_generated // 4
        assert all(torch.isfinite(t).all() for t in r.cache["layers"])


def test_unported_families_raise_with_the_reason(monkeypatch):
    """The frontend-stub archs run in the model (``tests/
    test_torch_frontends.py``), but the serving driver refuses them, at
    the reduced and the published widths, as the reference's ``main``
    does, with its words: it drives token-input decoders only."""
    for arch in ("whisper-large-v3", "qwen2-vl-2b"):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit) as ref:
            ref_serve.main()
        assert str(ref.value).startswith(f"{arch}: serving driver supports "
                                         "token-input decoders")
        for full in ([], ["--full"]):
            with pytest.raises(SystemExit) as port:
                pserve.main(["--arch", arch, "--device", "cpu", *full])
            assert str(port.value) == str(ref.value)


TRAINING_MODULES = (
    "repro_torch.models.transformer", "repro_torch.optim.adamw",
    "repro_torch.checkpointing.checkpoint", "repro_torch.data.pipeline",
    "repro_torch.launch.steps", "repro_torch.launch.train",
    "repro_torch.convert", "repro_torch.runtime.stragglers",
    "repro_torch.runtime.elastic", "repro_torch.runtime.fault")
FRONTEND_MODULES = ("repro_torch.configs.whisper_large_v3",
                    "repro_torch.configs.qwen2_vl_2b")


def test_the_port_imports_neither_jax_nor_the_reference():
    """Every module of ``repro_torch``, the training path's and the
    frontend-stub configs among them, imported in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.') if not m.name.endswith('__main__')]\n"
        # named too: the training path, and the runtime modules (no
        # __init__.py there, so the walk does not list them)
        f"assert set({FRONTEND_MODULES!r}) <= set(mods), mods\n"
        f"for m in mods + list({TRAINING_MODULES + FRONTEND_MODULES!r}):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 66
