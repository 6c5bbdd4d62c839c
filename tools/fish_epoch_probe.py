#!/usr/bin/env python3
"""Where ``fish_epoch_update``'s time goes, on the card.

Builds copies of ``src/repro_torch/csrc/fish_count.cu`` and runs the
whole-epoch kernel in each on two epochs: the paper's (``FishParams()``:
K = N = 1,000, the table after 100 epochs of ``chip_smoke.py``'s ZF
stream, epoch 100's keys) and one at the size limit's order (K = 4,096,
N = 8,192, from a seed).  The copies:

* ``phases``: thread 0 reads ``clock64`` and ``%globaltimer`` at the
  kernel's start and after each phase (table sort, match, epoch sort, the
  runs and slot keys, the candidate + slot sort, the ReplaceMin), so the
  kernel's cycles split by phase;
* ``warp_sync``: nothing cut; between two sort stages whose pairs lie
  within 64 entries (j <= 32), ``__syncwarp`` in place of
  ``__syncthreads``: such a stage keeps each pair inside one 64-entry
  block, and a block's pairs always fall to one warp (pair t to thread
  t mod blockDim, a multiple of 32) — 40 of a 1,024-entry sort's 55
  barriers.

Each copy's launch is timed with CUDA events over back-to-back launches
(the kernel, not the host, is the longer of the two here); the unchanged
source is timed first and last and held against the plain version.

Usage, from the root of a checkout on a machine with the card and nvcc:
``python3 tools/fish_epoch_probe.py``.  The builds go to
``build/fish_epoch_probe``.  A marker that is no longer in the source stops
the script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REPS = 500

_PROBES = r'''
__device__ long long g_probe[32];
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
_READ = r'''
extern "C" int probe_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 32);
}
'''

#: phase name → the source line the stamp goes after (or before, "^")
_MARKS = (
    ("start", "  const int tid = threadIdx.x, nt = blockDim.x;\n"),
    ("table_sort", "  bitonic_sort2(tb, k_pad, nullptr, 0);\n"),
    ("match", "^  // decay + epoch counts"),
    ("epoch_sort", "  bitonic_sort2(ep, n_pad, nullptr, 0);\n"),
    ("runs_and_slots", "^  // 3. candidates (most frequent first)"),
    ("top_bottom_sort", "  bitonic_sort2(top, n_pad, tb, k_pad);\n"),
    ("replace", "^  for (int s = tid; s < k; s += nt) {\n    keys_out[s]"),
    ("write", "    counts_out[s] = cnt[s];\n  }\n"),
)
_STAGE_BARRIER = ("      if (k <= nb) bitonic_stage(b, nb, k, j);\n"
                  "      __syncthreads();\n")
_WARP_SYNC = ("      if (k <= nb) bitonic_stage(b, nb, k, j);\n"
              "      const int next_j = j > 1 ? j >> 1 : k;\n"
              "      if (j > 32 || next_j > 32 || (j == 1 && k == n))\n"
              "        __syncthreads();\n"
              "      else\n"
              "        __syncwarp();\n")


def variant_source(src: str, name: str) -> str:
    def need(text):
        if text not in src:
            raise SystemExit(f"fish_epoch_probe: not in the source: {text!r}")

    if name == "phases":
        src = src.replace("namespace {\n", _PROBES + "namespace {\n", 1)
        for slot, (_, mark) in enumerate(_MARKS):
            before = mark.startswith("^")
            mark = mark.lstrip("^")
            need(mark)
            stamp = (f"  if (threadIdx.x == 0) {{ g_probe[{2 * slot}] = "
                     f"clock64(); g_probe[{2 * slot + 1}] = probe_ns(); }}\n")
            src = src.replace(mark, stamp + mark if before else mark + stamp,
                              1)
        return src + _READ
    if name == "warp_sync":
        need(_STAGE_BARRIER)
        return src.replace(_STAGE_BARRIER, _WARP_SYNC)
    return src


def build(out_dir: Path, names) -> dict:
    from repro_torch.kernels import _build

    src = (REPO / "src/repro_torch/csrc/fish_count.cu").read_text()
    procs = {}
    for name in names:
        cu = out_dir / f"fish_count_{name}.cu"
        cu.write_text(variant_source(src, name))
        so = out_dir / f"fish_count_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fish_epoch_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import numpy as np

    from repro_torch.core import fish as F
    from repro_torch.data.synthetic import zipf_time_evolving
    from repro_torch.kernels import _build
    from repro_torch.kernels import fish_count as fc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    out_dir = REPO / "build" / "fish_epoch_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = ("base", "phases", "warp_sync")
    libs = build(out_dir, names)
    for lib in libs.values():
        f = lib.fish_epoch_update
        f.argtypes = list(fc._SIGS["fish_epoch_update"])
        f.restype = ctypes.c_int
    libs["phases"].probe_read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    p = F.FishParams()
    keys = zipf_time_evolving(101 * p.epoch, num_keys=100_000, z=1.2,
                              flip_at=0.8, flip_head=10_000, seed=0)
    st = F.init_fish_state(p.k_max, device=dev)
    kd = torch.from_numpy(keys).to(dev)
    for e in range(100):
        st = F.epoch_update(st, kd[e * p.epoch:(e + 1) * p.epoch],
                            alpha=p.alpha, epoch_fn=fc.fish_epoch_update)
    rng = np.random.default_rng(0)
    big_t = np.full(4096, -1, np.int32)
    big_t[:3072] = rng.choice(40_000, 3072, replace=False)
    big_c = np.zeros(4096, np.float32)
    big_c[:3072] = rng.gamma(2.0, 3.0, 3072).astype(np.float32)
    big_k = zipf_time_evolving(8192, num_keys=40_000, z=1.2, seed=1)
    epochs = {
        "paper K=1000 N=1000": (st["keys"], st["counts"],
                                kd[100 * p.epoch:101 * p.epoch]),
        "K=4096 N=8192": tuple(torch.from_numpy(x).to(dev)
                               for x in (big_t, big_c, big_k))}
    stream = _build.stream_ptr(dev)
    mhz = float(card.strip().split(",")[-1].split()[0])
    result = {}
    for label, (tk, tc, bk) in epochs.items():
        k, n = tk.shape[0], bk.shape[0]
        outs = (torch.empty(k, dtype=torch.int32, device=dev),
                torch.empty(k, dtype=torch.float32, device=dev))

        def launch(lib, ties_key):
            err = lib.fish_epoch_update(
                tk.data_ptr(), tc.data_ptr(), p.alpha, k, bk.data_ptr(), n,
                min(64, k, n), ties_key, outs[0].data_ptr(),
                outs[1].data_ptr(), stream)
            _build.check(err, "fish_epoch_update")

        row = {}
        for ties_key, ties in enumerate(fc.TIES):
            want = fc.fish_epoch_update_plain(tk, tc, bk, alpha=p.alpha,
                                              max_new=64, ties=ties)
            for name in ("base", "phases", "warp_sync", "base"):
                launch(libs[name], ties_key)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                    raise SystemExit(f"fish_epoch_probe: {name} ({ties}) "
                                     "differs from the plain version")
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(REPS):
                    launch(libs[name], ties_key)
                e1.record()
                torch.cuda.synchronize()
                row.setdefault(f"{name} {ties} ms", []).append(
                    e0.elapsed_time(e1) / REPS)
            launch(libs["phases"], ties_key)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 32)()
            libs["phases"].probe_read(buf)
            cyc = {m[0]: buf[2 * i + 2] - buf[2 * i]
                   for i, m in enumerate(_MARKS[1:])}
            ns = buf[2 * len(_MARKS) - 1] - buf[1]
            row[f"phases {ties} cycles"] = cyc
            row[f"phases {ties} total"] = {
                "cycles": sum(cyc.values()), "ns": ns,
                "mhz": sum(cyc.values()) / max(ns, 1) * 1e3}
        result[label] = row
        print(f"{label}:")
        for key, v in row.items():
            print(f"  {key}: {json.dumps(v)}")
    print(json.dumps({"card": card.strip(), "max_mhz": mhz,
                      "fish_epoch_probe": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
