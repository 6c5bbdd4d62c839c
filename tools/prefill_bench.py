#!/usr/bin/env python3
"""Warm prefill time of mamba2-780m at full width, on the card.

``chip_smoke.py`` times path C's first prefill, which also pays the
caching allocator's growth and the libraries' first calls.  This times
the steady state: the same model (48 layers, d_model 1536, bf16, random
weights from seed 0) and the same prompts (4 x 4,096 tokens from seed 0),
two untimed prefills, then ``REPS`` timed ones, each on the host clock
between two ``torch.cuda.synchronize()`` and with CUDA events around it.
It prints one JSON line: every wall, their median, tokens per second and
milliseconds per layer, and the SSD kernels' launches per prefill.

It uses the package of the checkout it sits in, so a copy of this file
in an older checkout times that checkout's kernels.  Usage, from the root
of a checkout on a machine with the card: ``python3 tools/prefill_bench.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROMPTS, PROMPT_LEN = 4, 4_096
WARM, REPS = 2, 5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as MT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = get_config("mamba2-780m")
    params = MT.init_params(cfg, seed=0, device=torch.device("cuda"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32)).cuda()
    batch = {"tokens": toks}
    for _ in range(WARM):
        MT.prefill(params, batch, cfg)
    walls, events = [], []
    ssd.LAUNCHES.update(dict.fromkeys(ssd.LAUNCHES, 0))
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        _, logits = MT.prefill(params, batch, cfg)
        e1.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(e0.elapsed_time(e1) / 1e3)
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            print("prefill_bench: non-finite logits", file=sys.stderr)
            return 1
    med = float(np.median(walls))
    print(json.dumps({
        "card": card, "prompts": PROMPTS, "prompt_len": PROMPT_LEN,
        "walls_s": walls, "events_s": events, "median_s": med,
        "tokens_per_s": PROMPTS * PROMPT_LEN / med,
        "ms_per_layer": med * 1e3 / cfg.num_layers,
        "ssd_launches_per_prefill": {k: v // REPS
                                     for k, v in ssd.LAUNCHES.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
