"""The port's training loop against the JAX package's: ``make_train_step``
with and without accumulation, the FISH-grouped data pipeline,
checkpoints in both directions and ``TrainLoop``, the CLI on the CPU, the
cosine schedule, remat (bit-equal to the plain forward) and the
checkpoint directory's rules.

Inputs are made with numpy from a seed; the models' weights are the
port's draw written into the reference's pytree (``torch_model_pairs``),
or the reference's carried over by ``convert``.  The port runs on
``device="cpu"``.  Tolerances:

* the train step in float32: the losses and the gradient norm within
  1e-5, m and v within 1e-4 of the leaf's largest magnitude, the
  parameters too where the gradient is not near zero
  (``assert_adam_step_close``), the new hotness as ``forward_train``'s;
* ``TrainLoop`` in float32: equal batches, 5 losses within 1e-4;
* the pipeline's host ids, batches and backlogs, and checkpoints: equal,
  bit for bit; the schedule within 1e-6.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as RC
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced
from repro.core.fish import FishParams as RefFishParams
from repro.data.pipeline import StreamingPipeline as RefPipeline
from repro.data.synthetic import token_stream as ref_token_stream
from repro.launch import steps as RS
from repro.launch.train import TrainLoop as RefTrainLoop
from repro.optim import adamw as RO
from repro_torch import convert
from repro_torch.checkpointing import checkpoint as PC
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.fish import FishParams
from repro_torch.data.pipeline import StreamingPipeline
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import steps as PS
from repro_torch.launch.train import TrainLoop
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PO

import torch_helpers  # noqa: F401  (caps torch threads)
import torch_model_pairs as pairs
from torch_model_pairs import (as_numpy, assert_adam_step_close,
                               assert_hotness, assert_same_leaves, batch_np,
                               close_to_leaf, flat_ref, hotness_np, stacked,
                               t)

# the reference's update, compiled once per tree and config
REF_ADAMW = jax.jit(RO.adamw_update, static_argnums=3)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference(accum):
    """deepseek-v2-lite (MLA + MoE) reduced, float32, from a carried
    hotness: with 2 microbatches the second routes with the first's."""
    rcfg, cfg, rparams, params = pairs.model_pair(
        "deepseek-v2-lite-16b", "float32", grad_accum=accum)
    ocfg = PO.AdamWConfig(lr=1e-3, warmup_steps=0)
    rocfg = RO.AdamWConfig(**dataclasses.asdict(ocfg))
    bn, hot = batch_np(cfg, b=4), hotness_np(cfg)
    rstep = jax.jit(RS.make_train_step(rcfg, rocfg, None))
    rparams, rstate, rhot, rm = rstep(
        rparams, RO.init_opt_state(rparams, rocfg), jnp.asarray(hot),
        {k: jnp.asarray(v) for k, v in bn.items()})
    step = PS.make_train_step(cfg, ocfg)
    params, state, new_hot, m = step(
        params, PO.init_opt_state(params, ocfg), t(hot),
        {k: t(v) for k, v in bn.items()})
    for key in ("loss", "ce_loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5,
                                   err_msg=key)
    if accum == 1:
        assert_hotness(new_hot, rhot, hot, cfg)
    else:  # the second microbatch from the first's hotness
        np.testing.assert_array_max_ulp(new_hot.numpy(), np.asarray(rhot), 1)
    want_m = flat_ref(rstate.m)
    for path, want in want_m.items():
        close_to_leaf(state.m[path].numpy(), want, 1e-4, f"m {path}")
    for path, want in flat_ref(rstate.v).items():
        close_to_leaf(state.v[path].numpy(), want, 1e-4, f"v {path}")
    assert_adam_step_close(stacked(params, dict(params.named_parameters())),
                           flat_ref(rparams), want_m, ocfg.lr)


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouping", ["fish", "pkg"])
def test_pipeline_matches_reference(grouping):
    """Per-document and batched ingest, work stealing, host feedback and a
    rescale: the same hosts, batches, backlogs and memory overhead."""
    kw = dict(num_hosts=4, seq_len=32, batch_per_host=2, grouping=grouping)
    ref = RefPipeline(fish_params=RefFishParams(epoch=200, k_max=64), **kw)
    port = StreamingPipeline(fish_params=FishParams(epoch=200, k_max=64),
                             **kw)
    rs = ref_token_stream(10**6, num_keys=300, doc_len=16, vocab_size=500,
                          seed=1)
    ps = token_stream(10**6, num_keys=300, doc_len=16, vocab_size=500, seed=1)
    for i in range(6):
        docs = [next(rs) for _ in range(40)]
        pdocs = [next(ps) for _ in range(40)]
        for (k, a), (pk, b) in zip(docs, pdocs):
            assert k == pk and np.array_equal(a, b)
        if i % 2:
            keys = np.asarray([k for k, _ in docs])
            np.testing.assert_array_equal(
                port.ingest_batch(keys, [b for _, b in pdocs]),
                ref.ingest_batch(keys, [a for _, a in docs]))
        else:
            assert [port.ingest(k, b) for k, b in pdocs] == [
                ref.ingest(k, a) for k, a in docs]
        if i == 2:
            ref.report_host_time(1, 0.5)
            port.report_host_time(1, 0.5)
        if i == 3:
            ref.rescale([0, 1, 2])
            port.rescale([0, 1, 2])
        np.testing.assert_array_equal(port.backlog(), ref.backlog())
        rb, pb = ref.next_global_batch(), port.next_global_batch()
        assert (rb is None) == (pb is None)
        if rb is not None:
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(pb[key], rb[key])
        assert port.memory_overhead() == ref.memory_overhead()
    assert port.num_hosts == ref.num_hosts == 3


# ---------------------------------------------------------------------------
# Checkpoints, both directions
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def kimi_train_state():
    """Reduced kimi-k2 (bf16 weights, bf16 factored state) after one
    reference AdamW step, with a hotness: every kind of leaf."""
    rcfg, cfg, rparams, params = pairs.model_pair("kimi-k2-1t-a32b",
                                                  "bfloat16", num_layers=3)
    rocfg = RO.AdamWConfig(state_dtype=rcfg.opt_state_dtype,
                           factored_v=rcfg.opt_factored)
    rgrads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01,
                                                       p.dtype), rparams)
    rparams, rstate, _ = REF_ADAMW(
        rgrads, RO.init_opt_state(rparams, rocfg), rparams, rocfg)
    tree = {"params": rparams, "opt": rstate,
            "hotness": jnp.asarray(hotness_np(rcfg))}
    return rcfg, cfg, rocfg, tree


def port_tree(params, state, hot):
    return {"params": PT.param_tree(params), "opt": state, "hotness": hot}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rcfg, cfg, rocfg, tree = kimi_train_state()
    RC.save(str(tmp_path / "ref"), 7, tree)
    params, state, hot = convert.train_state_from_reference(tree, cfg, "cpu")
    like = port_tree(PT.init_params(cfg, seed=1, device="cpu"),
                     PO.init_opt_state(params, PO.AdamWConfig(
                         state_dtype=cfg.opt_state_dtype,
                         factored_v=cfg.opt_factored)),
                     torch.zeros_like(hot))
    restored, step = PC.restore(str(tmp_path / "ref"), like)
    assert step == 7
    want = {p: as_numpy(x) for p, x in PC._paths(port_tree(params, state,
                                                           hot))}
    assert_same_leaves({p: as_numpy(x) for p, x in PC._paths(restored)},
                       want)
    # the converted state is the reference's, leaf for leaf, in its order
    assert_same_leaves(want, {pairs.leaf_name(p): as_numpy(x) for p, x in
                              jax.tree_util.tree_flatten_with_path(tree)[0]})
    # the port writes the same manifest: paths, files, shapes, dtypes
    PC.save(str(tmp_path / "port"), 7, port_tree(params, state, hot))
    manifests = [json.load(open(tmp_path / d / "step_000000007" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rcfg, cfg, rocfg, tree = kimi_train_state()
    params, state, hot = convert.train_state_from_reference(tree, cfg, "cpu")
    PC.save(str(tmp_path), 3, port_tree(params, state, hot))
    assert PC.latest_step(str(tmp_path)) == RC.latest_step(str(tmp_path)) == 3
    like = jax.tree_util.tree_map(jnp.zeros_like, tree)
    restored, step = RC.restore(str(tmp_path), like)
    assert step == 3
    assert_same_leaves(
        {pairs.leaf_name(p): as_numpy(x) for p, x in
         jax.tree_util.tree_flatten_with_path(restored)[0]},
        {pairs.leaf_name(p): as_numpy(x) for p, x in
         jax.tree_util.tree_flatten_with_path(tree)[0]})


# ---------------------------------------------------------------------------
# TrainLoop
# ---------------------------------------------------------------------------


def test_train_loop_matches_reference(tmp_path):
    """The reference's ``_loop`` setup (``tests/test_system.py``: olmo-1b
    reduced to 2 layers, batch 4 x 64, lr 2e-3 after 5 warmup steps) in
    float32, the port's loop on the reference's initial weights: 5 steps
    with equal batches and losses, then a checkpoint of each that the
    other restores."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("olmo-1b")),
                               num_layers=2, grad_accum=1, dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config("olmo-1b")),
                              num_layers=2, grad_accum=1, dtype="float32")
    ocfg = dict(lr=2e-3, warmup_steps=5, total_steps=60)
    ref = RefTrainLoop(rcfg, RO.AdamWConfig(**ocfg), batch=4, seq=64,
                       ckpt_dir=str(tmp_path / "ref"))
    port = TrainLoop(cfg, PO.AdamWConfig(**ocfg), batch=4, seq=64,
                     ckpt_dir=str(tmp_path / "port"), device="cpu")
    port.params = convert.model_params_from_reference(ref.params, cfg, "cpu")
    seen = {"ref": [], "port": []}
    for name, loop in (("ref", ref), ("port", port)):
        real = loop.next_batch

        def record(real=real, name=name):
            b = real()
            seen[name].append({k: np.asarray(v) for k, v in b.items()})
            return b

        loop.next_batch = record
    rhist = ref.run(5, ckpt_every=5, log_every=100)
    phist = port.run(5, ckpt_every=5, log_every=100)
    assert len(seen["ref"]) == len(seen["port"]) == 5
    for rb, pb in zip(seen["ref"], seen["port"]):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(pb[k], rb[k])
    np.testing.assert_allclose(phist, rhist, rtol=1e-4)
    # each package's checkpoint of step 5 restores in the other
    again = RefTrainLoop(rcfg, RO.AdamWConfig(**ocfg), batch=4, seq=64,
                         ckpt_dir=str(tmp_path / "port"))
    assert again.maybe_restore() and again.step == 5
    mine = TrainLoop(cfg, PO.AdamWConfig(**ocfg), batch=4, seq=64,
                     ckpt_dir=str(tmp_path / "ref"), device="cpu")
    assert mine.maybe_restore() and mine.step == 5
    want = flat_ref(ref.params)
    for path, x in PT.param_tree(mine.params).items():
        np.testing.assert_array_equal(x.numpy(), want[path])
    for path, x in flat_ref(again.params).items():
        close_to_leaf(x, want[path], 1e-4, path)


def test_train_cli_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """``python -m repro_torch.launch.train --device cpu``: reduced
    deepseek-v2-lite for 2 steps with a checkpoint, then ``--resume``."""
    import sys

    from repro_torch.launch import train

    argv = ["train", "--device", "cpu", "--arch", "deepseek-v2-lite-16b",
            "--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv)
    train.main()
    assert PC.latest_step(str(tmp_path)) == 2
    monkeypatch.setattr(sys, "argv", argv + ["--resume"])
    train.main()
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "final loss" in out
    assert PC.latest_step(str(tmp_path)) == 4


# ---------------------------------------------------------------------------
# Pieces: the schedule, remat, the checkpoint directory's rules
# ---------------------------------------------------------------------------


def test_cosine_schedule_matches_reference():
    ocfg = PO.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    rocfg = RO.AdamWConfig(**dataclasses.asdict(ocfg))
    steps = np.arange(0, 130, dtype=np.int32)
    np.testing.assert_allclose(
        PO.cosine_schedule(t(steps), ocfg).numpy(),
        np.asarray(RO.cosine_schedule(jnp.asarray(steps), rocfg)),
        rtol=1e-6)


def test_remat_changes_no_number():
    """``cfg.remat`` (each layer, and the loss chunks, checkpointed) gives
    the loss, every gradient and the new hotness of the plain forward,
    bit for bit: the recompute runs the same operations."""
    _, cfg = pairs.cfgs("kimi-k2-1t-a32b", "float32")
    bn, hot = batch_np(cfg), t(hotness_np(cfg))
    runs = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = PT.init_params(c, seed=0, device="cpu").requires_grad_(True)
        loss, out = PT.forward_train(params, {k: t(v) for k, v in
                                              bn.items()}, c, hot)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        runs.append((loss.detach(), out["new_hotness"], grads))
    (la, ha, ga), (lb, hb, gb) = runs
    assert torch.equal(la, lb) and torch.equal(ha, hb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_checkpoint_directory_rules_match_reference(tmp_path):
    """Both packages read one directory alike: uncommitted and ``.tmp``
    steps are not checkpoints, ``keep`` prunes the oldest committed ones,
    and a restore refuses a missing leaf or another shape."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.zeros(2, dtype=torch.int32)]}
    d = str(tmp_path)
    for step in (1, 2, 3):
        PC.save(d, step, tree, keep=2)
    (tmp_path / "step_000000009").mkdir()  # no COMMITTED
    (tmp_path / "step_000000010.tmp").mkdir()
    assert PC.latest_step(d) == RC.latest_step(d) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000003", "step_000000009",
        "step_000000010.tmp"]
    assert PC.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="missing"):
        PC.restore(d, {"a": tree["a"], "c": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        PC.restore(d, {"a": torch.zeros(3, 2), "b": tree["b"]})
    got, step = PC.restore(d, tree, step=2)
    assert step == 2 and torch.equal(got["a"], tree["a"])
    assert isinstance(got["b"], list) and got["b"][0].dtype == torch.int32
