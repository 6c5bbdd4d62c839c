"""The port's model training against the JAX package's: ``flash_attention``
under autograd, ``forward_train``, the SSM family's refusal, and AdamW
(the decay mask, the factored and bf16 state).  The train step, the data
pipeline, checkpoints and ``TrainLoop`` are in
``test_torch_train_loop.py``.

Inputs are made with numpy from a seed; the models' weights are the
port's draw written into the reference's pytree (``torch_model_pairs``).
The port runs on ``device="cpu"``.  Tolerances:

* ``flash_attention``'s gradients: within 1e-5 (the same float32 products
  summed in another order);
* ``forward_train`` in float32: the loss within 1e-5, every gradient
  within 1e-4 of its reference leaf's largest magnitude, ``new_hotness``
  equal to ``α·hotness + counts`` with the reference's counts
  (``assert_hotness``);
* AdamW: float32 state and parameters within 1e-6 of the leaf's largest
  magnitude (the same elementwise float32 operations; the factored means
  and the global norm sum in another order), bfloat16 state within one
  bfloat16 ulp (2^-7 relative) of the reference's (under ``jit`` XLA
  fuses ``b1·m + (1 − b1)·g`` on the CPU, so its float32 m can be an ulp
  off before the bfloat16 rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import transformer as RT
from repro.optim import adamw as RO
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PO

import torch_helpers  # noqa: F401  (caps torch threads)
import torch_model_pairs as pairs
from torch_model_pairs import (assert_hotness, batch_np, close_to_leaf,
                               flat_ref, hotness_np, stacked, t)

ARCHS = ("qwen1.5-0.5b", "olmo-1b", "gemma2-2b", "deepseek-v2-lite-16b",
         "kimi-k2-1t-a32b")


# ---------------------------------------------------------------------------
# flash_attention under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,dh,dv,window,softcap", [
    (4, 4, 16, 16, None, None),
    (4, 2, 16, 16, 24, None),       # windows empty whole rows of a block
    (4, 1, 16, 16, None, 20.0),
    (4, 2, 16, 16, 24, 20.0),
    (4, 4, 24, 16, None, None),     # MLA: dv != dh
])
def test_flash_attention_gradients_match_jax_grad(hq, hkv, dh, dv, window,
                                                  softcap):
    """Three KV blocks of 32 over 80 keys (the tail padded); the window of
    24 leaves rows of the first block fully masked for the later queries,
    so the ``torch.where`` guards are crossed under autograd."""
    rng = np.random.default_rng(hq * 7 + hkv + dh)
    b, s = 2, 80
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    ct = rng.standard_normal((b, s, hq, dv)).astype(np.float32)
    kw = dict(window=window, softcap=softcap, block_k=32)

    def ref(q, k, v):
        return jnp.sum(RA.flash_attention(q, k, v, **kw) * ct)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    xs = [t(x).requires_grad_(True) for x in (q, k, v)]
    (PA.flash_attention(*xs, **kw) * t(ct)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        assert torch.isfinite(x.grad).all(), name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------


def ref_value_and_grad(rcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b, h: RT.forward_train(p, b, rcfg, h), has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    """Loss, every gradient and the new hotness at ``reduced_config`` in
    float32 (gemma2: the local/global pattern and both softcaps; the MoE
    archs from a carried hotness)."""
    rcfg, cfg, rparams, params = pairs.model_pair(arch, "float32")
    bn, hot = batch_np(cfg), hotness_np(cfg)
    (rloss, rout), rgrads = ref_value_and_grad(rcfg)(
        rparams, {k: jnp.asarray(v) for k, v in bn.items()},
        None if hot is None else jnp.asarray(hot))
    params.requires_grad_(True)
    loss, out = PT.forward_train(params, {k: t(v) for k, v in bn.items()},
                                 cfg, None if hot is None else t(hot))
    names, ps = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(out["ce_loss"].detach()),
                               float(rout["ce_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["aux_loss"].detach()),
                               float(rout["aux_loss"]), rtol=1e-5, atol=1e-7)
    want = flat_ref(rgrads)
    got = stacked(params, dict(zip(names, grads)))
    assert got.keys() == want.keys()
    for path in want:
        close_to_leaf(got[path], want[path], 1e-4, path)
    if hot is None:
        assert out["new_hotness"] is None and rout["new_hotness"] is None
    else:
        assert_hotness(out["new_hotness"], rout["new_hotness"], hot, cfg)


def test_ssm_training_raises_with_the_reason():
    cfg = reduced_config(get_config("mamba2-780m"))
    params = PT.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="backward"):
        PT.forward_train(params, {"tokens": toks, "labels": toks}, cfg)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

# the reference's update, compiled once per tree and config (a frozen
# dataclass, so static)
REF_ADAMW = jax.jit(RO.adamw_update, static_argnums=3)

ADAMW_CASES = {
    # (arch, layers, state dtype, factored, clip_norm); float32 weights.
    # The clipped cases scale the gradient by clip_norm / the global norm,
    # which sums in another order (within 1e-6): an ulp off there can flip
    # a bfloat16 rounding of m, so the bfloat16 case runs unclipped.
    "qwen-f32": ("qwen1.5-0.5b", 2, "float32", False, 1.0),
    # the pattern's (L/pat, pat, D) vectors factor within a group
    "gemma2-factored": ("gemma2-2b", 4, "float32", True, 1.0),
    # kimi-k2's own state: bf16 m, factored v; 3 layers, so the stack of
    # 2 MoE layers couples its vectors across layers (the prefix alone)
    "kimi-3-layers": ("kimi-k2-1t-a32b", 3, "bfloat16", True, 1e9),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_update_and_decay_mask_match_reference(case):
    arch, layers, sdt, factored, clip = ADAMW_CASES[case]
    rcfg, cfg, rparams, params = pairs.model_pair(arch, "float32",
                                                  num_layers=layers)
    ocfg = PO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          clip_norm=clip, state_dtype=sdt,
                          factored_v=factored)
    rocfg = RO.AdamWConfig(**dataclasses.asdict(ocfg))
    # the decay mask, leaf by leaf, from the reference's paths
    want_mask = flat_ref(RO._decay_mask(rparams))
    leaves = PT.reference_leaves(params)
    assert sorted(p for p, _, _ in leaves) == sorted(want_mask)
    assert {p: PO.decays(p) for p, _, _ in leaves} == {
        p: bool(m) for p, m in want_mask.items()}
    assert not PO.decays("stack/attn/kv_norm/scale")

    rstate, state = RO.init_opt_state(rparams, rocfg), \
        PO.init_opt_state(params, ocfg)
    rng = np.random.default_rng(5)
    for _ in range(2):  # the second step starts from nonzero m and v
        gflat = {p: (rng.standard_normal(np.shape(a)) * 0.1).astype(
            np.asarray(a).dtype) for p, a in flat_ref(rparams).items()}
        rgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(rparams), list(gflat.values()))
        rparams, rstate, rm = REF_ADAMW(rgrads, rstate, rparams, rocfg)
        grads = {}
        named = dict(params.named_parameters())
        for path, names, lead in leaves:
            rows = t(gflat[path]).reshape(-1, *named[names[0]].shape)
            grads.update(zip(names, rows))
        params, state, m = PO.adamw_update(grads, state, params, ocfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert int(state.step) == int(rstate.step) == 2
    want_p = flat_ref(rparams)
    got_p = stacked(params, dict(params.named_parameters()))
    for path in want_p:
        close_to_leaf(got_p[path], want_p[path], 1e-6, path)
    rv = flat_ref(rstate.v)
    for path, want in flat_ref(rstate.m).items():
        got = state.m[path]
        assert got.dtype == getattr(torch, sdt)
        bf16 = sdt == "bfloat16"
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32),
                                   rtol=2 ** -7 if bf16 else 0,
                                   atol=0 if bf16 else 1e-6 * max(
                                       float(np.abs(want).max()), 1e-30),
                                   err_msg=path)
        v = state.v[path]
        if isinstance(v, dict):  # factored: r and c, float32
            for part in ("r", "c"):
                close_to_leaf(v[part].numpy(), rv[f"{path}/{part}"], 1e-6,
                              f"{path}/{part}")
        else:
            close_to_leaf(v.float().numpy(), rv[path], 1e-6, path)
    if factored:  # a per-layer vector is one factored leaf of the stack
        lead = dict((p, ld) for p, _, ld in leaves)["stack/ln1/scale"]
        assert state.v["stack/ln1/scale"]["r"].shape == lead
