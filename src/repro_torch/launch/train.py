"""End-to-end training entry point of the port: the JAX package's
``launch/train.py`` on one card.

Runs real steps with:

* the FISH-grouped streaming data pipeline feeding batches,
* fault-tolerant checkpoint/restore (auto-resume from the latest commit),
  in the reference's on-disk format,
* straggler mitigation wired into the step loop,
* the MoE FISH hotness carried through the train state.

Parameters are random-initialised from a seeded ``torch.Generator``.

Usage (a reduced config trains on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch deepseek-v2-lite-16b --reduced --steps 50 --batch 8 \\
        --seq 128 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from .._device import resolve_device
from ..checkpointing import checkpoint as ckpt
from ..configs import get_config, list_archs, reduced_config
from ..core.fish import FishParams
from ..data.pipeline import StreamingPipeline
from ..data.synthetic import token_stream
from ..models import transformer as T
from ..optim.adamw import AdamWConfig, init_opt_state
from ..runtime.stragglers import StragglerMitigator
from . import steps as S

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Parameters, optimizer state and hotness on ``device`` (``None`` =
    ``cuda``), a FISH-grouped pipeline over ``num_hosts`` host shards, and
    the train step."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, *, batch: int, seq: int,
                 ckpt_dir: Optional[str] = None, num_hosts: int = 4,
                 grouping: str = "fish", seed: int = 0, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.batch, self.seq = batch, seq
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.params = T.init_params(cfg, seed=seed, device=self.device)
        self.opt_state = init_opt_state(self.params, opt_cfg)
        self.hotness = T.init_hotness_state(cfg, device=self.device)
        self.step = 0

        if batch % num_hosts:
            raise ValueError(f"batch {batch} not divisible by {num_hosts} "
                             "hosts")
        self.pipeline = StreamingPipeline(
            num_hosts=num_hosts, seq_len=seq, batch_per_host=batch // num_hosts,
            grouping=grouping, fish_params=FishParams(epoch=1000, k_max=512),
        )
        self.stragglers = StragglerMitigator(num_hosts)
        self._step_fn = S.make_train_step(cfg, opt_cfg)
        self._stream = token_stream(
            10**9, num_keys=20_000, doc_len=seq // 2,
            vocab_size=cfg.vocab_size, z=1.2, phases=6, seed=seed,
        )

    # -- fault tolerance ---------------------------------------------------------
    def _state_tree(self) -> dict:
        """The train state as the reference's checkpoint tree: parameters
        as its stacked leaves (host copies), the optimizer state, the
        hotness."""
        return {"params": T.param_tree(self.params, device="cpu"),
                "opt": self.opt_state, "hotness": self.hotness}

    def maybe_restore(self) -> bool:
        if not self.ckpt_dir:
            return False
        if ckpt.latest_step(self.ckpt_dir) is None:
            return False
        restored, step = ckpt.restore(self.ckpt_dir, self._state_tree())
        T.load_param_tree(self.params, restored["params"])
        self.opt_state = restored["opt"]
        self.hotness = restored["hotness"]
        self.step = step
        return True

    def save(self) -> None:
        if self.ckpt_dir:
            ckpt.save(self.ckpt_dir, self.step, self._state_tree())

    # -- data --------------------------------------------------------------------
    def next_batch(self):
        b = self.pipeline.next_global_batch()
        while b is None:
            for _ in range(64):  # ingest in chunks, steal fills the rest
                key, toks = next(self._stream)
                self.pipeline.ingest(key, toks)
            b = self.pipeline.next_global_batch()
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    # -- loop --------------------------------------------------------------------
    def run(self, num_steps: int, *, ckpt_every: int = 50,
            log_every: int = 10) -> list:
        history = []
        for _ in range(num_steps):
            batch = self.next_batch()
            t0 = time.perf_counter()
            self.params, self.opt_state, self.hotness, metrics = self._step_fn(
                self.params, self.opt_state, self.hotness, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            self.step += 1
            history.append(loss)
            for h in range(self.stragglers.est.num_workers):
                self.stragglers.record_step_time(h, dt / max(self.batch, 1))
            if self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if ckpt_every and self.step % ckpt_every == 0:
                self.save()
        return history


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grouping", default="fish")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 100),
                          state_dtype=cfg.opt_state_dtype,
                          factored_v=cfg.opt_factored)
    loop = TrainLoop(cfg, opt_cfg, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, grouping=args.grouping,
                     device=args.device)
    if args.resume and loop.maybe_restore():
        print(f"resumed from step {loop.step}")
    hist = loop.run(args.steps)
    print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f})")
    loop.save()


if __name__ == "__main__":
    main()
