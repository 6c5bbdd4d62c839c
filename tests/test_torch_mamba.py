"""mamba2-780m serving in the port against the JAX package.

The reduced config (2 layers, narrow widths) runs in both packages from the
same weights — the reference's parameter pytree carried over by
``convert.model_params_from_reference`` — on the same numpy-seeded tokens:
prefill logits and four decode steps after it.  float32 agrees within
1e-3 (the chunked scan and the matmuls sum in another order); bfloat16
within ``tests/test_models_smoke.py``'s 0.08 / 0.35 (the two frameworks
round bf16 at other places).  The serving engine, in pure simulation,
gives the reference's ``EngineMetrics`` exactly, and the port's serve
entry point runs the reduced model end to end on the plain kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import reduced_config as ref_reduced
from repro.models import transformer as RT
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.kernels import ssd as pssd
from repro_torch.launch import serve as pserve
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Request, ServingEngine

import torch_helpers  # noqa: F401  (caps torch threads)

B, S, STEPS = 2, 40, 4
TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=0.08, atol=0.35)}


def _cfgs(dtype):
    ref = dataclasses.replace(ref_reduced(ref_get_config("mamba2-780m")),
                              dtype=dtype)
    port = dataclasses.replace(reduced_config(get_config("mamba2-780m")),
                               dtype=dtype)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_and_decode_match_reference(dtype):
    rcfg, cfg = _cfgs(dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = convert.model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    assert PT.num_params(params) == sum(
        x.size for x in jax.tree_util.tree_leaves(rparams))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    tol = TOL[dtype]
    vocab = cfg.vocab_size

    rprefill = jax.jit(lambda p, b: RT.prefill(p, b, rcfg))
    rcache, rlogits = rprefill(rparams, {"tokens": jnp.asarray(toks[:, :S])})
    cache, logits = PT.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg)
    assert logits.shape == (B, PT.padded_vocab(cfg))
    np.testing.assert_allclose(logits[:, :vocab].numpy(),
                               np.asarray(rlogits[:, :vocab]), **tol)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(
            cache["layers"][key].float().numpy(),
            np.asarray(rcache["layers"][key], dtype=np.float32), **tol)

    rstep = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rcfg))
    for i in range(S, S + STEPS):
        t = toks[:, i:i + 1]
        rlogits, rcache = rstep(rparams, rcache, jnp.asarray(t))
        logits, cache = PT.decode_step(params, cache, torch.from_numpy(t),
                                       cfg)
        np.testing.assert_allclose(logits[:, :vocab].numpy(),
                                   np.asarray(rlogits[:, :vocab]), **tol)
        assert cache["pos"] == int(rcache["pos"])


def test_prefill_then_decode_continues_the_prefill():
    """Decoding token S after a prefill of S-1 tokens gives the prefill of
    S tokens (tests/test_models_smoke.py:98-102), on the plain kernels."""
    cfg = reduced_config(get_config("mamba2-780m"))
    params = PT.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32))
    _, full = PT.prefill(params, {"tokens": toks}, cfg)
    cache, _ = PT.prefill(params, {"tokens": toks[:, :15]}, cfg)
    kept = {k: v.clone() for k, v in cache["layers"].items()}
    step, after = PT.decode_step(params, cache, toks[:, 15:16], cfg)
    # decode_step is functional, as the reference's: the old cache stays
    assert after["pos"] == cache["pos"] + 1
    for k, v in kept.items():
        assert torch.equal(cache["layers"][k], v)
        assert not torch.equal(after["layers"][k], v)
    np.testing.assert_allclose(step[0, :cfg.vocab_size].float().numpy(),
                               full[0, :cfg.vocab_size].float().numpy(),
                               rtol=0.08, atol=0.35)
    # every arch of the JAX package's registry, in its order
    assert list_archs() == ["mamba2-780m", "qwen1.5-0.5b", "starcoder2-3b",
                            "olmo-1b", "gemma2-2b", "recurrentgemma-9b",
                            "kimi-k2-1t-a32b", "deepseek-v2-lite-16b",
                            "qwen2-vl-2b", "whisper-large-v3"]
    assert list_archs() == ref_list_archs()
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def _requests(mk, n=48, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sess = (f"hot{rng.integers(0, 3)}" if rng.random() < 0.7
                else f"cold{rng.integers(0, 50)}")
        out.append(mk(i, sess, arrival=float(i) * 0.25,
                      target_tokens=int(rng.integers(4, 16))))
    return out


@pytest.mark.parametrize("grouping", ["fish", "pkg", "sg"])
def test_serving_engine_simulation_matches_reference(grouping):
    """Pure simulation (no model): same requests, same metrics, a replica
    failure and a scale-out on the way."""
    runs = []
    for eng_cls, req_cls in ((RefEngine, RefRequest),
                             (ServingEngine, Request)):
        eng = eng_cls(num_replicas=4, slots_per_replica=3,
                      tokens_per_tick=np.array([1.0, 2.0, 1.0, 0.5]),
                      grouping=grouping)
        reqs = _requests(req_cls)
        for r in reqs[:30]:
            eng.submit(r)
        for _ in range(20):
            eng.tick()
        eng.fail_replica(1)
        eng.add_replica(speed=1.5, slots=3)
        for r in reqs[30:]:
            eng.submit(r)
        eng.run(until_done=len(reqs))
        runs.append((dataclasses.asdict(eng.metrics()), eng.now,
                     [(r.request_id, r.replica, r.finished)
                      for r in eng.done]))
    assert runs[0] == runs[1]


def test_serve_main_runs_the_reduced_model_on_the_plain_kernels():
    cfg = reduced_config(get_config("mamba2-780m"))
    params = PT.init_params(cfg, seed=0, device="cpu")
    before = dict(pssd.LAUNCHES)
    eng, reps = pserve.serve(cfg, params, replicas=2, slots=4, requests=12,
                             device="cpu")
    assert len(eng.done) == 12
    m = eng.metrics()
    assert m.throughput_tokens > 0 and m.latency_p99 >= m.latency_p50
    assert sum(r.tokens_generated for r in reps) > 0
    for r in reps:
        assert r.cache["pos"] + 1 == r.tokens_generated // 4
        assert torch.isfinite(r.cache["layers"]["ssm"]).all()
    assert pssd.LAUNCHES == before  # CPU tensors never reach a kernel
