"""Serving entry point: FISH-routed continuous batching over model replicas.

Each replica holds the model's parameters and a batched decode cache; the
engine routes requests by session key (FISH: CHK replication for hot
sessions + Alg. 3 inferred-backlog replica choice + consistent hashing
under failures) and drives a real ``decode_step`` per tick.  By default
the model is the architecture's reduced config, as the JAX package's
``serve.py`` does; ``--full`` serves it at its published widths.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 64 --replicas 2 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config, list_archs, reduced_config
from ..models import transformer as T
from ..serving.engine import Request, ServingEngine

__all__ = ["ModelReplica", "serve", "main"]


class ModelReplica:
    """One replica: parameters (shared between replicas) + a batched decode
    cache + the greedy next token of every slot."""

    def __init__(self, cfg, params, num_slots: int, max_seq: int,
                 device=None):
        self.cfg = cfg
        self.params = params
        dev = resolve_device(device)
        self.cache = T.init_cache(cfg, num_slots, max_seq, device=dev)
        self.cache["pos"] = -1
        self.tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                  device=dev)
        self.tokens_generated = 0

    def step(self) -> None:
        logits, self.cache = T.decode_step(self.params, self.cache,
                                           self.tokens, self.cfg)
        nxt = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1)
        self.tokens = nxt[:, None].to(torch.int32)
        self.tokens_generated += self.tokens.shape[0]


def serve(cfg, params, *, replicas: int = 2, slots: int = 4,
          requests: int = 64, max_seq: int = 128, grouping: str = "fish",
          device=None) -> Tuple[ServingEngine, List[ModelReplica]]:
    """Submit ``requests`` session-keyed requests (70 % on three hot
    sessions; seed 0, as the JAX package's ``serve.py``) and serve them to
    completion."""
    reps = [ModelReplica(cfg, params, slots, max_seq, device=device)
            for _ in range(replicas)]

    def step_fn(replica_idx: int, active_slots) -> None:
        reps[replica_idx].step()

    eng = ServingEngine(num_replicas=replicas, slots_per_replica=slots,
                        grouping=grouping, step_fn=step_fn)
    rng = np.random.default_rng(0)
    for i in range(requests):
        sess = f"hot{rng.integers(0, 3)}" if rng.random() < 0.7 \
            else f"cold{rng.integers(0, 50)}"
        eng.submit(Request(i, sess, arrival=float(i) * 0.25,
                           target_tokens=int(rng.integers(4, 16))))
    eng.run(until_done=requests)
    return eng, reps


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--grouping", default="fish")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths, not the reduced config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    if cfg.embeds_input or cfg.encoder_layers:  # as the reference refuses
        raise SystemExit(f"{args.arch}: serving driver supports token-input "
                         "decoders; use the engine simulation for "
                         "frontend-stub archs")
    params = T.init_params(cfg, seed=0, device=args.device)
    eng, reps = serve(cfg, params, replicas=args.replicas, slots=args.slots,
                      requests=args.requests, max_seq=args.max_seq,
                      grouping=args.grouping, device=args.device)
    m = eng.metrics()
    total_model_tokens = sum(r.tokens_generated for r in reps)
    print(f"served {len(eng.done)} requests | p50={m.latency_p50:.1f} "
          f"p99={m.latency_p99:.1f} ticks | {m.throughput_tokens:.2f} "
          f"tok/tick | session replication {m.session_replicas_norm:.2f}x | "
          f"model decode calls produced {total_model_tokens} tokens")


if __name__ == "__main__":
    main()
