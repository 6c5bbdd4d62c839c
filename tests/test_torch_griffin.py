"""The Griffin family (recurrentgemma-9b: RG-LRU blocks and local MQA with a
ring-buffer decode cache) in the port against the JAX package.

The config is ``reduced_config`` with 5 layers — one (rec, rec, attn)
group and a tail of 2, so an attention layer runs (the reduced config's 2
layers are the tail alone) — and a local window of 8, so that prompts
cross it.  Weights are the port's draw written into the reference's
pytree and carried back by ``convert.model_params_from_reference``;
inputs are made with numpy from a seed; the port runs on ``device="cpu"``.
The reference's compiled prefill and decode are shared across cases.
Tolerances:

* ``_rglru_gates``, ``_rglru_conv``, ``rglru_block``, ``_lru_scan`` and
  ``rglru_decode`` in float32: rtol 1e-5, atol 1e-6 (XLA's CPU backend
  contracts the scan's ``a·b + c`` into one FMA, the port rounds twice);
* the model in float32: logits within atol 1e-4, caches within 1e-5;
  bfloat16 within ``tests/test_torch_dense.py``'s 0.08 / 0.35;
* ``forward_train``'s gradients within 1e-4 of each reference leaf's
  largest magnitude (``close_to_leaf``); AdamW as
  ``tests/test_torch_train.py``; checkpoints bit for bit.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as RC
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced
from repro.launch.serve import ModelReplica as RefReplica
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.optim import adamw as RO
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.checkpointing import checkpoint as PC
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import feed_fused as ff
from repro_torch.kernels import fish_count as fc
from repro_torch.kernels import ssd as pssd
from repro_torch.kernels import store_probe as sp
from repro_torch.launch import serve as pserve
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PO

import torch_helpers  # noqa: F401  (caps torch threads)
import torch_model_pairs as pairs
from torch_model_pairs import (as_np, as_numpy, assert_same_leaves,
                               batch_np, close_to_leaf, flat_ref, stacked, t)

ARCH = "recurrentgemma-9b"
B, WINDOW, STEPS = 4, 8, 6
PIECE_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=0.08, atol=0.35)

# the reference's functions, compiled once (configs are static)
REF_GATES = jax.jit(RS._rglru_gates)
REF_CONV = jax.jit(RS._rglru_conv)
REF_BLOCK = jax.jit(RS.rglru_block, static_argnums=2)
REF_DECODE = jax.jit(RS.rglru_decode, static_argnums=3)
REF_SCAN = jax.jit(RS._lru_scan)
REF_INIT = jax.jit(RS.init_rglru_params, static_argnums=(1, 2, 3))
REF_GRAD = jax.jit(jax.value_and_grad(RT.forward_train, has_aux=True),
                   static_argnums=2)
REF_ADAMW = jax.jit(RO.adamw_update, static_argnums=3)


def cfgs(dtype, **kw):
    """The 5-layer, window-8 reduced config in both packages."""
    out = []
    for cfg in (ref_reduced(ref_get_config(ARCH)),
                reduced_config(get_config(ARCH))):
        out.append(dataclasses.replace(
            cfg, num_layers=5, dtype=dtype,
            rglru=dataclasses.replace(cfg.rglru, local_window=WINDOW), **kw))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def make_pair(dtype, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params): the
    port's draw, written into the reference's pytree and carried back by
    ``convert``, which must give the same values bit for bit."""
    rcfg, cfg = cfgs(dtype, **kw)
    drawn = PT.init_params(cfg, seed=seed, device="cpu")
    rparams = pairs.reference_params(drawn, rcfg)
    params = convert.model_params_from_reference(rparams, cfg, device="cpu")
    for (name, a), (_, b) in zip(drawn.named_parameters(),
                                 params.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert PT.num_params(params) == RT.num_params(rparams)
    return rcfg, cfg, rparams, params


class Ref:
    """The reference's prefill and decode, compiled once per shape."""

    def __init__(self, rcfg):
        self.prefill = jax.jit(lambda p, b: RT.prefill(p, b, rcfg))
        self.decode = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rcfg))


@pytest.fixture(scope="module")
def f32():
    rcfg, cfg, rparams, params = make_pair("float32")
    return rcfg, cfg, rparams, params, Ref(rcfg)


def tokens(n, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(
        np.int32)


def cache_leaves(cache):
    """A Griffin cache's tensors in a fixed order: rec conv and h, attn k
    and v, then each tail layer's conv and h."""
    return [cache["rec"]["conv"], cache["rec"]["h"], *cache["attn"],
            *[st[k] for st in cache["tail"] for k in ("conv", "h")]]


def assert_caches_close(got, want, tol):
    assert got["pos"] == int(want["pos"])
    for a, b in zip(cache_leaves(got), cache_leaves(want), strict=True):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(as_np(a), as_np(b), **tol)


# ---------------------------------------------------------------------------
# The RG-LRU block's pieces
# ---------------------------------------------------------------------------


def rec_params(rparams, params, layer=0):
    """Layer ``layer``'s (rec_stack [0, layer]) block in both packages."""
    ref = jax.tree_util.tree_map(lambda x: x[0, layer],
                                 rparams["rec_stack"]["rec"])
    return ref, params.layers[layer].rec


@pytest.mark.parametrize("piece", ["gates", "conv", "block"])
def test_rglru_pieces_match_reference(piece, f32):
    rcfg, cfg, rparams, params, _ = f32
    rp, pp = rec_params(rparams, params)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    xr = rng.standard_normal((B, 24, cfg.rglru.lru_width)).astype(
        np.float32)
    if piece == "gates":
        want = REF_GATES(rp, jnp.asarray(xr))
        got = PS._rglru_gates(pp, t(xr))
    elif piece == "conv":
        want = [REF_CONV(jnp.asarray(xr), rp)]
        got = [PS._rglru_conv(t(xr), pp)]
    else:
        want = [REF_BLOCK(rp, jnp.asarray(x), rcfg.rglru)]
        got = [PS.rglru_block(pp, t(x), cfg.rglru)[0]]
    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PIECE_TOL)


@pytest.mark.parametrize("s", [5, 24, 64])
def test_lru_scan_matches_reference(s):
    """Both of the reference's branches: the whole-sequence associative
    scan (S = 5, 24: S % 16 or S < 32) and 16 chunk-local scans with the
    sequential carry combine (S = 64); both also against the recurrence
    run step by step in float64."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.9, 1.0, (B, s, 16)).astype(np.float32)
    b = rng.standard_normal((B, s, 16)).astype(np.float32)
    want = np.asarray(REF_SCAN(jnp.asarray(a), jnp.asarray(b)))
    got = PS._lru_scan(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, **PIECE_TOL)
    h, seq = np.zeros((B, 16)), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    np.testing.assert_allclose(got, np.stack(seq, 1), **PIECE_TOL)


def test_rglru_decode_matches_reference(f32):
    """8 single-token steps from the zero state: outputs and states each
    step; after them the state equals ``rglru_block``'s over the 8
    tokens."""
    rcfg, cfg, rparams, params, _ = f32
    rp, pp = rec_params(rparams, params, layer=1)
    x = np.random.default_rng(8).standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)
    rstate = RS.init_rglru_state(rcfg.d_model, rcfg.rglru, B)
    state = PS.init_rglru_state(cfg.d_model, cfg.rglru, B, "cpu")
    for i in range(8):
        want, rstate = REF_DECODE(rp, jnp.asarray(x[:, i:i + 1]), rstate,
                                  rcfg.rglru)
        got, state = PS.rglru_decode(pp, t(x[:, i:i + 1]), state, cfg.rglru)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PIECE_TOL)
        for k in ("conv", "h"):
            assert state[k].dtype == torch.float32
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(rstate[k]), **PIECE_TOL)
    _, full = PS.rglru_block(pp, t(x), cfg.rglru)
    for k in ("conv", "h"):
        np.testing.assert_allclose(state[k].numpy(), full[k].numpy(),
                                   **PIECE_TOL)


# ---------------------------------------------------------------------------
# The model: prefill, the ring-buffer decode, the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [5, 8, 11])
def test_griffin_prefill_matches_reference(s, f32):
    """Prompts shorter than, equal to and longer than the window: the
    logits, every rec state and the attention caches clipped to the last
    min(S, window) positions."""
    rcfg, cfg, rparams, params, ref = f32
    toks = tokens(s)
    rcache, rlogits = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    cache, logits = PT.prefill(params, {"tokens": t(toks)}, cfg)
    assert logits.shape == (B, PT.padded_vocab(cfg))
    np.testing.assert_allclose(as_np(logits[:, :cfg.vocab_size]),
                               as_np(rlogits[:, :cfg.vocab_size]),
                               **LOGIT_TOL)
    assert cache["attn"][0].shape[2] == min(s, WINDOW)
    assert_caches_close(cache, rcache, CACHE_TOL)


@pytest.mark.parametrize("s", [5, 8, 11])
def test_griffin_decode_keeps_the_reference_ring(s, f32):
    """6 decode steps after a prompt of S, port against reference within
    1e-4, and the caches after.  The ring writes position ``pos`` at slot
    ``pos % w``: after a prompt of 8 (a multiple of the window) the decode
    continues the window exactly and its last logits equal a prefill of
    S + 6 tokens; after 5 (a ring of 5 slots) or 11 (slot 11 % 8 holds
    position 11 − 3, inside the window) it drops a key the window holds,
    and the port keeps the reference's gap to that prefill."""
    rcfg, cfg, rparams, params, ref = f32
    toks = tokens(s + STEPS, seed=s)
    rcache, _ = ref.prefill(rparams, {"tokens": jnp.asarray(toks[:, :s])})
    cache, _ = PT.prefill(params, {"tokens": t(toks[:, :s])}, cfg)
    for i in range(s, s + STEPS):
        rlogits, rcache = ref.decode(rparams, rcache,
                                     jnp.asarray(toks[:, i:i + 1]))
        logits, cache = PT.decode_step(params, cache, t(toks[:, i:i + 1]),
                                       cfg)
        np.testing.assert_allclose(as_np(logits[:, :cfg.vocab_size]),
                                   as_np(rlogits[:, :cfg.vocab_size]),
                                   **LOGIT_TOL)
    assert_caches_close(cache, rcache, CACHE_TOL)
    _, rlonger = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    _, longer = PT.prefill(params, {"tokens": t(toks)}, cfg)
    v = cfg.vocab_size
    gap = as_np(logits[:, :v]) - as_np(longer[:, :v])
    rgap = as_np(rlogits[:, :v]) - as_np(rlonger[:, :v])
    np.testing.assert_allclose(gap, rgap, **LOGIT_TOL)
    if s % WINDOW == 0:
        assert np.abs(gap).max() <= 1e-4
    else:
        assert np.abs(rgap).max() > 0.05  # the quirk is on, in both


@pytest.mark.parametrize("batch,max_seq", [(2, 5), (4, 128)])
def test_init_cache_matches_reference(batch, max_seq):
    """A ring of min(max_seq, window) slots; float32 rec states."""
    rcfg, cfg = cfgs("bfloat16")
    want = RT.init_cache(rcfg, batch, max_seq)
    got = PT.init_cache(cfg, batch, max_seq, device="cpu")
    assert got["pos"] == 0 and len(got["tail"]) == len(want["tail"]) == 2
    for a, b in zip(cache_leaves(got), cache_leaves(want), strict=True):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, str(b.dtype))
        assert not a.any()


def test_griffin_bf16_matches_reference():
    """bfloat16 weights and activations (the conv's taps summed in bf16 in
    the prefill, in float32 in the decode, as the reference): a prefill
    of 11 and 6 decode steps."""
    rcfg, cfg, rparams, params = make_pair("bfloat16", seed=2)
    ref = Ref(rcfg)
    toks = tokens(11 + STEPS, seed=3)
    rcache, rlogits = ref.prefill(rparams, {"tokens": jnp.asarray(
        toks[:, :11])})
    cache, logits = PT.prefill(params, {"tokens": t(toks[:, :11])}, cfg)
    v = cfg.vocab_size
    np.testing.assert_allclose(as_np(logits[:, :v]), as_np(rlogits[:, :v]),
                               **BF16_TOL)
    for i in range(11, 11 + STEPS):
        rlogits, rcache = ref.decode(rparams, rcache,
                                     jnp.asarray(toks[:, i:i + 1]))
        logits, cache = PT.decode_step(params, cache, t(toks[:, i:i + 1]),
                                       cfg)
        np.testing.assert_allclose(as_np(logits[:, :v]),
                                   as_np(rlogits[:, :v]), **BF16_TOL)
    assert_caches_close(cache, rcache, BF16_TOL)


@pytest.mark.parametrize("layers,want", [(38, 8_578_306_048),
                                         (8, 2_642_628_608)])
def test_num_params_at_full_width_match_reference(layers, want):
    """The published widths on the meta device against the reference's
    ``eval_shape``: the whole model and the 8-layer cut trained on the
    card (2 groups + a tail of 2)."""
    rcfg = dataclasses.replace(ref_get_config(ARCH), num_layers=layers)
    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    shapes = jax.eval_shape(lambda k: RT.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(shapes)) == want
    assert PT.num_params(PT.Model(cfg, device="meta")) == want


def test_init_rglru_params_draws_the_reference_distributions():
    """Each leaf's mean and spread against the reference init's (other
    PRNGs), ``conv_b`` zero and Λ the same grid, at d_model 512, width
    512 and 16 gate blocks."""
    rg = dataclasses.replace(get_config(ARCH).rglru, lru_width=512)
    want = REF_INIT(jax.random.PRNGKey(3), 512, rg, jnp.float32)
    got = dict(PS.init_rglru_params(torch.Generator().manual_seed(3), 512,
                                    rg, torch.float32,
                                    "cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w, g = np.asarray(w), got[name].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "lambda":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        elif w.std() == 0:
            assert np.array_equal(g, w), name
        else:
            assert abs(g.std() / w.std() - 1) < 0.05, name
            assert abs(g.mean()) < 0.05 * w.std(), name


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_serve_matches_the_reference_serving_loop(f32):
    """``launch/serve.py``'s ``serve`` against the reference's loop
    (``src/repro/launch/serve.py`` ``main``: its ``ModelReplica``s and
    ``ServingEngine``, the same requests) on one set of weights, 2
    replicas x 4 slots, 20 requests, each replica's ring of min(128, 8)
    slots wrapping: equal ``EngineMetrics``, tokens, positions and next
    tokens, and the caches within 1e-5; no kernel of the repo launches.
    The replicas share the decode the other tests compiled (the same
    function, the same shapes)."""
    rcfg, cfg, rparams, params, ref = f32
    n = 20
    reps = [RefReplica(rcfg, rparams, 4, 128) for _ in range(2)]
    for r in reps:
        r._step = ref.decode
    eng = RefEngine(num_replicas=2, slots_per_replica=4, grouping="fish",
                    step_fn=lambda i, active: reps[i].step())
    rng = np.random.default_rng(0)
    for i in range(n):
        sess = f"hot{rng.integers(0, 3)}" if rng.random() < 0.7 \
            else f"cold{rng.integers(0, 50)}"
        eng.submit(RefRequest(i, sess, arrival=float(i) * 0.25,
                              target_tokens=int(rng.integers(4, 16))))
    eng.run(until_done=n)
    counters = (ff.LAUNCHES, fc.LAUNCHES, pssd.LAUNCHES, sp.LAUNCHES)
    before = [dict(c) for c in counters]
    peng, preps = pserve.serve(cfg, params, requests=n, device="cpu")
    assert [dict(c) for c in counters] == before
    assert len(peng.done) == n
    assert dataclasses.asdict(peng.metrics()) == dataclasses.asdict(
        eng.metrics())
    assert peng.now == eng.now
    assert [(r.request_id, r.replica, r.finished) for r in peng.done] == [
        (r.request_id, r.replica, r.finished) for r in eng.done]
    for p, r in zip(preps, reps, strict=True):
        assert p.tokens_generated == r.tokens_generated
        assert p.cache["pos"] == int(r.cache["pos"]) > WINDOW  # wrapped
        np.testing.assert_array_equal(p.tokens.numpy(), np.asarray(r.tokens))
        assert_caches_close(p.cache, r.cache, CACHE_TOL)


# ---------------------------------------------------------------------------
# Training, the optimizer and checkpoints on Griffin's leaves
# ---------------------------------------------------------------------------


def test_forward_train_matches_reference(f32):
    """The loss and every gradient at 2 x 32 (the chunked scan's branch)
    in float32, under remat (each group checkpointed as one unit)."""
    rcfg, cfg, rparams, params, _ = f32
    bn = batch_np(cfg, b=2, s=32)
    (rloss, rout), rgrads = REF_GRAD(
        rparams, {k: jnp.asarray(v) for k, v in bn.items()}, rcfg)
    assert cfg.remat
    model = copy.deepcopy(params).requires_grad_(True)
    loss, out = PT.forward_train(model, {k: t(v) for k, v in bn.items()},
                                 cfg)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(out["ce_loss"].detach()),
                               float(rout["ce_loss"]), rtol=1e-5)
    assert float(out["aux_loss"]) == float(rout["aux_loss"]) == 0.0
    assert out["new_hotness"] is None and rout["new_hotness"] is None
    want = flat_ref(rgrads)
    got = stacked(model, dict(zip(names, grads)))
    assert got.keys() == want.keys()
    for path in want:
        close_to_leaf(got[path], want[path], 1e-4, path)


def adamw_cfgs(factored):
    ocfg = PO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          factored_v=factored)
    return ocfg, RO.AdamWConfig(**dataclasses.asdict(ocfg))


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_on_griffin_leaves_matches_reference(factored, f32,
                                                   monkeypatch):
    """Two AdamW steps on the stacked leaves: the decay mask leaf for leaf
    (``lambda`` is not decayed; ``conv_b`` is: it matches no name of
    ``_NO_DECAY``); factored, every ``rec_stack`` leaf — ``lambda``'s
    (G, 2, W) too — has its r over the two stack axes.  The elementwise
    updates run in pieces of 4,096 elements (the embedding in 16)."""
    monkeypatch.setattr(PO, "_PIECE", 4096)
    rcfg, cfg, rparams, params, _ = f32
    params = copy.deepcopy(params)  # updated in place
    ocfg, rocfg = adamw_cfgs(factored)
    want_mask = flat_ref(RO._decay_mask(rparams))
    leaves = PT.reference_leaves(params)
    assert {p: PO.decays(p) for p, _, _ in leaves} == {
        p: bool(m) for p, m in want_mask.items()}
    assert not PO.decays("rec_stack/rec/lambda")
    assert PO.decays("rec_stack/rec/conv_b")
    assert PO.decays("rec_tail/rec/conv_b")
    rstate, state = RO.init_opt_state(rparams, rocfg), \
        PO.init_opt_state(params, ocfg)
    named = dict(params.named_parameters())
    rng = np.random.default_rng(5)
    for _ in range(2):
        gflat = {p: (rng.standard_normal(np.shape(a)) * 0.1).astype(
            np.asarray(a).dtype) for p, a in flat_ref(rparams).items()}
        rgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(rparams), list(gflat.values()))
        rparams, rstate, rm = REF_ADAMW(rgrads, rstate, rparams, rocfg)
        grads = {}
        for path, names, lead in leaves:
            grads.update(zip(names, t(gflat[path]).reshape(
                -1, *named[names[0]].shape)))
        params, state, m = PO.adamw_update(grads, state, params, ocfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
    want_p = flat_ref(rparams)
    got_p = stacked(params, dict(params.named_parameters()))
    for path in want_p:
        close_to_leaf(got_p[path], want_p[path], 1e-6, path)
    rv = flat_ref(rstate.v)
    for path, want in flat_ref(rstate.m).items():
        close_to_leaf(state.m[path].numpy(), want, 1e-6, f"m {path}")
        v = state.v[path]
        for part, x in (v.items() if isinstance(v, dict) else (("", v),)):
            key = f"{path}/{part}" if part else path
            close_to_leaf(x.numpy(), rv[key], 1e-6, f"v {key}")
    if factored:
        assert state.v["rec_stack/rec/lambda"]["r"].shape == (1, 2)
        assert state.v["rec_stack/rec/lambda"]["c"].shape == (
            1, cfg.rglru.lru_width)


def train_state_tree(f32):
    """A reference train state (one AdamW step of factored state, no
    hotness): every kind of Griffin leaf.  (The update the AdamW test
    compiled.)"""
    rcfg, cfg, rparams, _, _ = f32
    _, rocfg = adamw_cfgs(True)
    rgrads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01,
                                                       p.dtype), rparams)
    rparams, rstate, _ = REF_ADAMW(
        rgrads, RO.init_opt_state(rparams, rocfg), rparams, rocfg)
    return cfg, {"params": rparams, "opt": rstate, "hotness": None}


def ref_leaves(tree):
    return {pairs.leaf_name(p): as_numpy(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_restores_bit_for_bit_in_either_package(direction,
                                                           tmp_path, f32):
    cfg, tree = train_state_tree(f32)
    params, state, hot = convert.train_state_from_reference(tree, cfg, "cpu")
    assert hot is None
    port = {"params": PT.param_tree(params), "opt": state, "hotness": None}
    if direction == "reference_to_port":
        RC.save(str(tmp_path), 7, tree)
        like = {"params": PT.param_tree(PT.Model(cfg, device="cpu")),
                "opt": PO.init_opt_state(params, adamw_cfgs(True)[0]),
                "hotness": None}
        restored, step = PC.restore(str(tmp_path), like)
        got = {p: as_numpy(x) for p, x in PC._paths(restored)}
    else:
        PC.save(str(tmp_path), 7, port)
        restored, step = RC.restore(str(tmp_path), jax.tree_util.tree_map(
            jnp.zeros_like, tree))
        got = ref_leaves(restored)
    assert step == 7
    assert_same_leaves(got, ref_leaves(tree))
    # the port's tree is the reference's, leaf for leaf, in its order
    assert_same_leaves({p: as_numpy(x) for p, x in PC._paths(port)},
                       ref_leaves(tree))
