"""The frontend-stub families in the port against the JAX package:
whisper-large-v3 (an encoder-decoder: a non-causal encoder over stubbed
frame embeddings, cross attention, no positional signal) and qwen2-vl-2b
(embedding input, M-RoPE over (3, B, S) positions).

The configs are ``reduced_config`` (whisper: 2 encoder and 2 decoder
layers over 32 frames; qwen2-vl: 2 layers at head_dim 32, where the
published sections (16, 24, 24) truncate to 16 temporal slots), and
qwen2-vl again with sections (4, 6, 6) so that all three streams act.
Weights are the port's draw written into the reference's pytree, every
bias and norm weight then moved off its init (so that each one counts),
and carried back by ``convert.model_params_from_reference``; inputs are
made with numpy from a seed; qwen2-vl's positions follow Qwen2-VL's rule
(arXiv:2409.12191 §2.1: a text prefix on equal streams, an image's merged
patches at one temporal index with height and width offsets, then text
from the largest position + 1).  The port runs on ``device="cpu"``.  The
reference's compiled functions are shared across cases.  Tolerances:

* ``apply_mrope`` within 1e-5 (float32 sin/cos of equal angles), its
  stream per slot equal to the reference's ``jnp.repeat``;
* ``flash_attention`` (non-causal, a padded tail block) within 1e-5;
* the models in float32: logits within atol 1e-4, caches within 1e-5,
  the loss within 1e-5, gradients within 1e-4 of each reference leaf's
  largest magnitude (``close_to_leaf``); bfloat16 within
  ``tests/test_torch_dense.py``'s 0.08 / 0.35;
* the train step as ``tests/test_torch_train_loop.py``: losses and the
  gradient norm within 1e-5, m and v within 1e-4 of the leaf's max, the
  parameters by ``assert_adam_step_close``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as RS
from repro.models import attention as RA
from repro.models import common as RCM
from repro.models import transformer as RT
from repro.optim import adamw as RO
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import steps as PS
from repro_torch.models import attention as PA
from repro_torch.models import common as PCM
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PO

from torch_helpers import mrope_positions  # (also caps torch threads)
import torch_model_pairs as pairs
from torch_model_pairs import (as_np, assert_adam_step_close, close_to_leaf,
                               flat_ref, leaf_name, stacked, t)

B, S, STEPS = 2, 16, 4
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=0.08, atol=0.35)
VARIANTS = {"whisper": ("whisper-large-v3", {}),
            "qwen2-vl": ("qwen2-vl-2b", {}),
            "qwen2-vl-466": ("qwen2-vl-2b", {"mrope_sections": (4, 6, 6)})}
FULL = {"whisper-large-v3": 1_602_237_440, "qwen2-vl-2b": 1_777_088_000}

# the reference's functions, compiled once (configs are static)
REF_PREFILL = jax.jit(RT.prefill, static_argnums=2)
REF_DECODE = jax.jit(RT.decode_step, static_argnums=3)
REF_GRAD = jax.jit(jax.value_and_grad(RT.forward_train, has_aux=True),
                   static_argnums=2)
REF_MROPE = jax.jit(RCM.apply_mrope, static_argnums=3)


def perturbed(rparams, seed=7):
    """The reference pytree with every bias and norm weight moved off its
    init (zeros and ones) by N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        name = leaf_name(path).split("/")[-1]
        x = np.asarray(x)
        if name in ("bq", "bk", "bv", "b_in", "b_out", "bias", "scale"):
            x = (x.astype(np.float32) + 0.1 * rng.standard_normal(
                x.shape).astype(np.float32)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(move, rparams)


def make_pair(variant, dtype="float32", seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params) on one set
    of weights, carried into the port by ``convert``."""
    arch, vkw = VARIANTS[variant]
    rcfg, cfg = pairs.cfgs(arch, dtype, **vkw, **kw)
    drawn = PT.init_params(cfg, seed=seed, device="cpu")
    rparams = perturbed(pairs.reference_params(drawn, rcfg))
    params = convert.model_params_from_reference(rparams, cfg, device="cpu")
    assert PT.num_params(params) == RT.num_params(rparams)
    return rcfg, cfg, rparams, params


_PAIRS = {}


def pair(variant):
    """``make_pair(variant)`` in float32, made once."""
    if variant not in _PAIRS:
        _PAIRS[variant] = make_pair(variant)
    return _PAIRS[variant]


def batch_np(cfg, s=S, b=B, seed=3, labels=False):
    """A prefill (or, with ``labels``, train) batch of ``s`` positions."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeds_input:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
        out["positions"] = mrope_positions([3] * b, 2, 3, s)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        lab[0, :3] = -1  # ignored positions
        out["labels"] = lab
    return out


def typed(cfg, bn, jnp_arrays=False):
    """A numpy batch as the model's inputs: float arrays in its dtype."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for k, v in bn.items():
        x = torch.from_numpy(v)
        out[k] = x.to(dt) if x.is_floating_point() else x
    if jnp_arrays:
        return {k: jnp.asarray(x.float().numpy()).astype(cfg.dtype)
                if x.is_floating_point() else jnp.asarray(x.numpy())
                for k, x in out.items()}
    return out


def cache_leaves(cache):
    return jax.tree_util.tree_leaves(cache["layers"])


def padded(rcache, cfg, extra):
    """The reference's prefill cache with its self-attention part
    zero-padded by ``extra`` positions (what ``grow_cache`` does)."""
    def pad(x):
        return jnp.pad(x, [(0, 0)] * (x.ndim - 3) + [(0, extra), (0, 0),
                                                      (0, 0)])

    if cfg.encoder_layers:
        (k, v), cross = rcache["layers"]
        layers = ((pad(k), pad(v)), cross)
    else:
        layers = tuple(pad(x) for x in rcache["layers"])
    return {"pos": rcache["pos"], "layers": layers}


def assert_caches_close(got, want, tol):
    assert got["pos"] == int(want["pos"])
    for a, b in zip(cache_leaves(got), cache_leaves(want), strict=True):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(as_np(a), as_np(b), **tol)


def decode_inputs(cfg, i, seed=5):
    """Decode step ``i``'s token (B, 1) and, for an embedding-input config
    on even steps, its embedding (B, 1, D) (odd steps go by the token)."""
    rng = np.random.default_rng(seed + i)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    emb = None
    if cfg.embeds_input and i % 2 == 0:
        emb = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    return tok, emb


# ---------------------------------------------------------------------------
# The pieces: M-RoPE, the non-causal attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,dh", [
    ((16, 24, 24), 128),   # the published split: 64 slots, all three act
    ((16, 24, 24), 32),    # the reduced head: cut to 16 temporal slots
    ((2, 3, 3), 32),       # 8 of 16 slots: padded with stream 2
    ((4, 4, 0), 32),       # padded with stream 2, not the last used
    ((4, 6, 6), 32)])      # the reduced head, all three act
def test_apply_mrope_matches_reference(sections, dh):
    half = dh // 2
    want = np.asarray(jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                                 total_repeat_length=half))
    assert PCM.mrope_streams(sections, half) == want.tolist()
    rng = np.random.default_rng(dh)
    q = rng.standard_normal((B, S, 4, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, dh)).astype(np.float32)
    pos = mrope_positions([3] * B, 2, 3, S)
    pos[1:, 1] += 7  # streams that differ per batch row too
    rq, rk = REF_MROPE(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                       sections)
    pq, pk = PCM.apply_mrope(t(q), t(k), t(pos), sections)
    np.testing.assert_allclose(pq.numpy(), np.asarray(rq), **ROPE_TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), **ROPE_TOL)


@pytest.mark.parametrize("sq,skv,rep", [(37, 37, 2),   # the encoder's
                                        (12, 37, 1)])  # cross attention
def test_noncausal_flash_attention_matches_reference(sq, skv, rep):
    """37 keys in blocks of 16: the tail block is padded and masked; every
    query sees every key."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((B, sq, 2 * rep, 16)).astype(np.float32)
    k = rng.standard_normal((B, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, skv, 2, 16)).astype(np.float32)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, block_k=16)
    got = PA.flash_attention(t(q), t(k), t(v), causal=False, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    causal = PA.flash_attention(t(q), t(k), t(v), block_k=16)
    assert not np.allclose(causal.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# The models: prefill, decode, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_matches_reference(variant):
    rcfg, cfg, rparams, params = pair(variant)
    bn = batch_np(cfg)
    rcache, rlogits = REF_PREFILL(rparams, typed(cfg, bn, True), rcfg)
    cache, logits = PT.prefill(params, typed(cfg, bn), cfg)
    v = cfg.vocab_size
    np.testing.assert_allclose(as_np(logits[:, :v]), as_np(rlogits[:, :v]),
                               **LOGIT_TOL)
    assert_caches_close(cache, rcache, CACHE_TOL)
    if cfg.encoder_layers:  # the cross part: (L, B, encoder_seq, H, dh)
        assert tuple(cache["layers"][1][0].shape) == (
            cfg.num_layers, B, cfg.encoder_seq, cfg.num_heads, cfg.head_dim)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_reference(variant):
    """A prefill of 16, its cache grown to 20 positions, then 4 decode
    steps (qwen2-vl: by embedding and by token in turn); whisper's cross
    part is the prefill's, unchanged."""
    rcfg, cfg, rparams, params = pair(variant)
    bn = batch_np(cfg)
    rcache, _ = REF_PREFILL(rparams, typed(cfg, bn, True), rcfg)
    cache, _ = PT.prefill(params, typed(cfg, bn), cfg)
    rcache = padded(rcache, cfg, STEPS)
    cache = PT.grow_cache(cfg, cache, S + STEPS)
    cross = cache["layers"][1] if cfg.encoder_layers else None
    kept = [x.clone() for x in cross] if cross else None
    v = cfg.vocab_size
    for i in range(STEPS):
        tok, emb = decode_inputs(cfg, i)
        rlogits, rcache = REF_DECODE(
            rparams, rcache, jnp.asarray(tok), rcfg,
            embeds=None if emb is None else jnp.asarray(emb))
        logits, cache = PT.decode_step(
            params, cache, t(tok), cfg, embeds=None if emb is None else t(emb))
        np.testing.assert_allclose(as_np(logits[:, :v]),
                                   as_np(rlogits[:, :v]), **LOGIT_TOL)
    assert_caches_close(cache, rcache, CACHE_TOL)
    if cross:
        assert cache["layers"][1] is cross
        assert all(torch.equal(a, b) for a, b in zip(cross, kept))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_then_decode_continues_a_longer_prefill(variant):
    """A decode at position S after a prefill of S equals the prefill of
    S + 1 whose last input sits at the reference's decode position: (S, S,
    S) on the three M-RoPE streams; whisper has no position at all."""
    _, cfg, _, params = pair(variant)
    bn = batch_np(cfg, s=S + 1)
    tok, emb = decode_inputs(cfg, 0)
    if cfg.embeds_input:
        bn["embeds"][:, S:] = emb
        bn["positions"][:, :, S] = S
    else:
        bn["tokens"][:, S:] = tok
    full = typed(cfg, bn)
    short = {k: (x[:, :, :S] if k == "positions" else
                 x if k == "enc_embeds" else x[:, :S])
             for k, x in full.items()}
    _, want = PT.prefill(params, full, cfg)
    cache, _ = PT.prefill(params, short, cfg)
    cache = PT.grow_cache(cfg, cache, S + 1)
    got, _ = PT.decode_step(params, cache, t(tok), cfg,
                            embeds=None if emb is None else t(emb))
    v = cfg.vocab_size
    np.testing.assert_allclose(got[:, :v].numpy(), want[:, :v].numpy(),
                               **LOGIT_TOL)


def zero_gradient(cfg, path):
    """Whether the leaf's gradient is zero in exact arithmetic: a key bias
    that no rotation follows (whisper) adds one constant to a query's
    every score, which the softmax takes out."""
    return cfg.rope_kind == "none" and path.endswith("/bk")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_train_gradients_match_reference(variant):
    """The loss and every leaf's gradient; a leaf whose gradient is zero in
    exact arithmetic (:func:`zero_gradient`) has no scale of its own: both
    packages' values must be within 1e-4 of its query bias's largest
    gradient."""
    rcfg, cfg, rparams, params = pair(variant)
    bn = batch_np(cfg, labels=True, seed=4)
    (rloss, rout), rgrads = REF_GRAD(rparams, typed(cfg, bn, True), rcfg)
    params.requires_grad_(True)
    try:
        loss, out = PT.forward_train(params, typed(cfg, bn), cfg)
        names, ps = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, ps, materialize_grads=True)
    finally:
        params.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(out["ce_loss"].detach()),
                               float(rout["ce_loss"]), rtol=1e-5)
    assert out["new_hotness"] is None and rout["new_hotness"] is None
    got = stacked(params, dict(zip(names, grads)))
    want = flat_ref(rgrads)
    assert set(got) == set(want)
    for path, w in want.items():
        if zero_gradient(cfg, path):
            # both at rounding noise against the query bias's gradient
            scale = float(np.abs(want[path[:-1] + "q"]).max())
            for g in (got[path], w):
                assert float(np.abs(g).max()) <= 1e-4 * scale, path
        else:
            close_to_leaf(got[path], w, 1e-4, path)


@pytest.mark.parametrize("variant", ["whisper", "qwen2-vl-466"])
def test_bf16_prefill_and_decode_match_reference(variant):
    rcfg, cfg, rparams, params = make_pair(variant, "bfloat16")
    bn = batch_np(cfg)
    rcache, rlogits = REF_PREFILL(rparams, typed(cfg, bn, True), rcfg)
    cache, logits = PT.prefill(params, typed(cfg, bn), cfg)
    v = cfg.vocab_size
    np.testing.assert_allclose(as_np(logits[:, :v]), as_np(rlogits[:, :v]),
                               **BF16_TOL)
    rcache = padded(rcache, cfg, 2)
    cache = PT.grow_cache(cfg, cache, S + 2)
    for i in range(2):
        tok, emb = decode_inputs(cfg, i)
        rlogits, rcache = REF_DECODE(
            rparams, rcache, jnp.asarray(tok), rcfg,
            embeds=None if emb is None else jnp.asarray(emb, jnp.bfloat16))
        logits, cache = PT.decode_step(
            params, cache, t(tok), cfg,
            embeds=None if emb is None else t(emb).to(torch.bfloat16))
        np.testing.assert_allclose(as_np(logits[:, :v]),
                                   as_np(rlogits[:, :v]), **BF16_TOL)
    assert_caches_close(cache, rcache, BF16_TOL)


# ---------------------------------------------------------------------------
# Layout: parameters, the cache, convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(FULL))
def test_num_params_at_full_width_match_reference(arch):
    """The published widths on the meta device against the reference's
    ``init_params`` under ``jax.eval_shape``: every leaf's shape and dtype,
    and the count (whisper ~1.60 B, qwen2-vl ~1.78 B)."""
    cfg = get_config(arch)
    model = PT.Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda k: RT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    want = {leaf_name(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    named = dict(model.named_parameters())
    got = {}
    for path, names, lead in PT.reference_leaves(model):
        got[path] = (lead + tuple(named[names[0]].shape),
                     str(named[names[0]].dtype).split(".")[-1])
    assert got == {k: (x.shape, str(x.dtype)) for k, x in want.items()}
    assert PT.num_params(model) == RT.num_params(shapes) == FULL[arch]


@pytest.mark.parametrize("arch", list(FULL))
def test_init_cache_matches_reference(arch):
    rcfg, cfg = pairs.cfgs(arch, "bfloat16")
    want = jax.eval_shape(lambda: RT.init_cache(rcfg, 3, 24))
    got = PT.init_cache(cfg, 3, 24, device="cpu")
    assert got["pos"] == 0
    leaves = cache_leaves(got)
    assert [(tuple(x.shape), x.dtype) for x in leaves] == [
        (x.shape, torch.bfloat16) for x in cache_leaves(want)]
    assert all(not bool(x.any()) for x in leaves)


@pytest.mark.parametrize("variant", ["whisper", "qwen2-vl"])
def test_param_tree_round_trips_the_reference_leaves(variant):
    """``convert`` into the port, then ``param_tree`` back: every reference
    leaf (``enc_stack``, ``enc_final_norm``, ``cross``, ``ln_cross``
    among them) bit for bit."""
    _, _, rparams, params = pair(variant)
    want = flat_ref(rparams)
    got = {k: x.numpy() for k, x in PT.param_tree(params).items()}
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w), \
            path


# ---------------------------------------------------------------------------
# The train step: microbatches of an M-RoPE batch
# ---------------------------------------------------------------------------


def test_split_micro_cuts_positions_on_axis_1():
    """The (3, B, S) positions are cut along B, as the reference's
    ``_split_micro`` does; every other leaf along axis 0."""
    cfg = pair("qwen2-vl-466")[1]
    bn = batch_np(cfg, b=4, labels=True)
    bn["positions"][:, 2:] += 5  # the halves differ
    ref = RS._split_micro({k: jnp.asarray(v) for k, v in bn.items()}, 2)
    got = PS._split_micro({k: t(v) for k, v in bn.items()}, 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        assert set(mb) == set(bn)
        for k, x in mb.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(ref[k][i]))
    assert tuple(got[1]["positions"].shape) == (3, 2, S)


def test_make_train_step_with_accumulation_matches_reference():
    """qwen2-vl (sections (4, 6, 6)), float32, grad_accum 2 over a batch
    of 4: the two microbatches' positions are the batch's halves."""
    rcfg, cfg, rparams, params = make_pair("qwen2-vl-466", grad_accum=2)
    ocfg = PO.AdamWConfig(lr=1e-3, warmup_steps=0)
    rocfg = RO.AdamWConfig(**dataclasses.asdict(ocfg))
    bn = batch_np(cfg, b=4, labels=True, seed=6)
    bn["positions"][:, 2:] += 5
    rstep = jax.jit(RS.make_train_step(rcfg, rocfg, None))
    rparams, rstate, _, rm = rstep(rparams, RO.init_opt_state(rparams, rocfg),
                                   None, typed(cfg, bn, True))
    step = PS.make_train_step(cfg, ocfg)
    params, state, hot, m = step(params, PO.init_opt_state(params, ocfg),
                                 None, typed(cfg, bn))
    assert hot is None
    for key in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5,
                                   err_msg=key)
    want_m = flat_ref(rstate.m)
    for path, want in want_m.items():
        close_to_leaf(state.m[path].numpy(), want, 1e-4, f"m {path}")
    for path, want in flat_ref(rstate.v).items():
        close_to_leaf(state.v[path].numpy(), want, 1e-4, f"v {path}")
    assert_adam_step_close(stacked(params, dict(params.named_parameters())),
                           flat_ref(rparams), want_m, ocfg.lr)
