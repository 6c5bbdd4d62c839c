"""MoE with FISH expert routing in the port against the JAX package:
``fish_capacities`` (CHK), ``_route``, ``moe_ffn`` under every routing mode
and dispatch implementation, and kimi-k2 (GQA + MoE) at ``reduced_config``.

Inputs and weights are made with numpy from a seed (the model's are the
port's draw, written into the reference's pytree: ``torch_model_pairs``);
the port runs on ``device="cpu"``.  Tolerances:

* CHK's capacities and ``_route``'s ids / keep / pos: equal, bit for bit;
* ``moe_ffn`` in float32: ``y`` within 1e-5 (the same products summed in
  another order), ``new_hotness`` and the drop and load metrics equal, the
  aux loss within 1e-6;
* the model: float32 within 1e-3, after the routing is held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

import torch_helpers  # noqa: F401  (caps torch threads)
import torch_model_pairs as pairs

Y_TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's _route, compiled once per config (a frozen dataclass,
# hashable, so static).  Its moe_ffn runs op by op: under jit XLA fuses
# alpha * hotness + counts on the CPU and lands an ulp off its own eager
# result, which the port's hotness equals bit for bit.
REF_ROUTE = jax.jit(RM._route, static_argnums=1)


def _zipf_hotness(e, seed, scale=1000.0):
    """Zipf(1.2)-skewed decayed counters over a seeded expert order."""
    rng = np.random.default_rng(seed)
    h = scale * np.arange(1, e + 1, dtype=np.float64) ** -1.2
    h = (0.2 * h[rng.permutation(e)] + rng.integers(0, 30, e))
    return h.astype(np.float32)


# ---------------------------------------------------------------------------
# CHK
# ---------------------------------------------------------------------------


def _hotness_case(case):
    e = {"zero": 64, "pow2": 8, "pow2_wide": 64, "one_hot": 8,
         "theta_edge": 8}.get(case, 64 if case != "zipf_384" else 384)
    if case == "zero":
        return np.zeros(e, np.float32)
    if case == "pow2":  # f_top / f_e exactly 1, 2, 4, ... 128
        return (2.0 ** np.arange(7, -1, -1)).astype(np.float32)
    if case == "pow2_wide":  # ratios at powers of two past the clip at E
        return (2.0 ** (np.arange(e) % 24)).astype(np.float32)[::-1].copy()
    if case == "one_hot":
        h = np.zeros(e, np.float32)
        h[5] = 3.0
        return h
    if case == "theta_edge":  # f_e exactly theta = 0.25 / 8 for two experts
        return np.array([24, 4, 1, 1, 1, 1, 0, 0], np.float32)
    return _zipf_hotness(e, seed=int(case.split("_")[1]))


@pytest.mark.parametrize("case", ["zero", "pow2", "pow2_wide", "one_hot",
                                  "theta_edge", "zipf_1", "zipf_2",
                                  "zipf_384"])
def test_fish_capacities_match_reference_exactly(case):
    h = _hotness_case(case)
    e = h.shape[0]
    for budget, c_max in ((int(1024 * 6 * 1.25), 152), (5120, 16),
                          (e * 3, 4 * e)):
        want = np.asarray(RM.fish_capacities(jnp.asarray(h), budget=budget,
                                             c_max=c_max))
        got = PM.fish_capacities(torch.from_numpy(h), budget=budget,
                                 c_max=c_max)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_fish_capacities_follow_the_hotness_hierarchy():
    """Hotness 8:4:2:1 of four experts (E = 8): ratios 1, 2, 4, 8 give
    shares E/1, E/2, E/4 and the floor d_min = 2; the four cold experts
    fall under theta and get d_min; Σ share = 8+4+2+2+4·2 = 24."""
    h = torch.tensor([8, 4, 2, 1, 0, 0, 0, 0], dtype=torch.float32)
    cap = PM.fish_capacities(h, budget=240, c_max=1000)
    assert cap.tolist() == [80, 40, 20, 20, 20, 20, 20, 20]


# ---------------------------------------------------------------------------
# _route
# ---------------------------------------------------------------------------


def _gates(g, t, e, seed, tie=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((g, t, e)).astype(np.float32)
    if tie:  # whole rows of equal gates, and pairs tied at the k-th place
        logits[:, ::3] = 0.0
        logits[:, 1::3, 2] = logits[:, 1::3, 5]
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return gates


@pytest.mark.parametrize("case", ["uniform", "tight", "fish_caps", "tie"])
def test_route_matches_reference_exactly(case):
    g, t, e, k = 3, 48, 8, 3
    moe = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8)
    gates = _gates(g, t, e, seed=4, tie=case == "tie")
    if case == "tight":
        caps = np.full(e, 5, np.int32)  # many claims overflow
    elif case == "fish_caps":
        caps = np.asarray(RM.fish_capacities(
            jnp.asarray(_zipf_hotness(e, 3)), budget=t * k, c_max=32))
    else:
        caps = np.full(e, t * k // e, np.int32)
    want = REF_ROUTE(jnp.asarray(gates), moe, jnp.asarray(caps))
    got = PM._route(torch.from_numpy(gates), moe, torch.from_numpy(caps))
    for name, w, p in zip(("ids", "gates", "keep", "pos"), want, got):
        if name == "gates":
            np.testing.assert_allclose(p.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(w),
                                          err_msg=name)
    if case == "tie":  # the all-equal rows claim experts 0, 1, 2
        assert got[0][:, ::3].eq(torch.arange(k)).all()
    if case == "tight":
        assert not got[2].all()


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _moe_pair(routing, impl, seed=0, d=32):
    """One MoE layer in both packages on numpy weights of the reference
    init's distributions."""
    kw = dict(num_experts=8, top_k=2, d_ff_expert=16, shared_experts=1,
              routing=routing, capacity_factor=1.0, tokens_per_group=32,
              dispatch_impl=impl, hot_headroom=2.0)
    rmoe, moe = RefMoEConfig(**kw), MoEConfig(**kw)
    p = PM.MoE(d, moe, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    rp = {}
    with torch.no_grad():
        for name, t in p.named_parameters():
            a = (rng.standard_normal(t.shape) / np.sqrt(t.shape[-2])
                 ).astype(np.float32)
            t.copy_(torch.from_numpy(a))
            node = rp
            *path, last = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[last] = jnp.asarray(a)
    return rmoe, moe, rp, p


@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("routing", ["fish", "pkg", "fg"])
def test_moe_ffn_matches_reference(routing, impl):
    """128 tokens in 4 groups of 32, 8 experts top-2, capacity factor 1
    (claims drop), one shared expert, Zipf-skewed hotness."""
    rmoe, moe, rp, p = _moe_pair(routing, impl)
    x = np.random.default_rng(2).standard_normal((128, 32)).astype(
        np.float32)
    hot = _zipf_hotness(8, seed=5)
    y_r, nh_r, aux_r, m_r = RM.moe_ffn(rp, jnp.asarray(x), rmoe,
                                       jnp.asarray(hot))
    y, nh, aux, m = PM.moe_ffn(p, torch.from_numpy(x), moe,
                               torch.from_numpy(hot))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **Y_TOL)
    np.testing.assert_array_equal(nh.numpy(), np.asarray(nh_r))
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-6,
                               atol=1e-6)
    for key in ("moe_drop_frac", "moe_load_max_over_mean"):
        assert float(m[key]) == float(m_r[key]), key
    np.testing.assert_allclose(float(m["moe_aux"]), float(m_r["moe_aux"]),
                               rtol=1e-6, atol=1e-6)
    assert float(m["moe_drop_frac"]) > 0  # the capacity bit


def test_moe_ffn_carries_hotness_across_calls():
    """Three FISH calls, each fed the last one's ``new_hotness``: the
    capacities move with the carried hotness in both packages alike."""
    rmoe, moe, rp, p = _moe_pair("fish", "scatter", seed=1)
    rng = np.random.default_rng(9)
    hot_r, hot = jnp.zeros(8, jnp.float32), PM.init_hotness(8, device="cpu")
    for _ in range(3):
        x = rng.standard_normal((128, 32)).astype(np.float32)
        y_r, hot_r, _, _ = RM.moe_ffn(rp, jnp.asarray(x), rmoe, hot_r)
        y, hot, _, _ = PM.moe_ffn(p, torch.from_numpy(x), moe, hot)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **Y_TOL)
        np.testing.assert_array_equal(hot.numpy(), np.asarray(hot_r))
    assert float(hot.sum()) > 0


def test_moe_ffn_refuses_tokens_off_the_group_size():
    """The reference asserts ``T % min(tokens_per_group, T) == 0``; the
    port raises on the same inputs (4 × 4,095 tokens in groups of 1,024
    would fail it)."""
    _, moe, _, p = _moe_pair("fish", "scatter")
    x = torch.zeros((40, 32))
    with pytest.raises(ValueError, match="not divisible"):
        PM.moe_ffn(p, x, moe, torch.zeros(8))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_kimi_prefill_and_decode_match_reference(monkeypatch):
    """kimi-k2 reduced (a GQA dense prefix layer, then a GQA + MoE
    layer); float32, the routing held equal first."""
    pairs.run_prefill_and_decode("kimi-k2-1t-a32b", "float32", monkeypatch)


@pytest.mark.parametrize("arch,count", [
    ("deepseek-v2-lite-16b", 15_706_484_224),
    ("kimi-k2-1t-a32b", 1_028_298_994_688)])
def test_moe_num_params_at_full_width_match_reference(arch, count):
    """The published widths on the meta device against the reference's
    ``eval_shape``d pytree: no weight is made."""
    shapes = jax.eval_shape(lambda k: RT.init_params(ref_get_config(arch), k),
                            jax.random.PRNGKey(0))
    model = PT.Model(get_config(arch), device="meta")
    assert PT.num_params(model) == count == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert model.layers[0].moe.router.dtype == torch.float32


def test_init_hotness_state_has_a_row_per_moe_layer():
    cfg = get_config("deepseek-v2-lite-16b")
    hot = PT.init_hotness_state(cfg, device="cpu")
    assert hot.shape == (26, 64) and hot.dtype == torch.float32
    assert not hot.any()
    assert PT.init_hotness_state(get_config("qwen1.5-0.5b")) is None
