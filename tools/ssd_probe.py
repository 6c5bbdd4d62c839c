#!/usr/bin/env python3
"""Where the SSD kernels' time goes (K4 ``ssd_chunk_state``, K5
``ssd_chunk_output``), on the card.

Builds copies of ``src/repro_torch/csrc/ssd.cu`` with one piece of work cut
out each (the results of those copies are wrong on purpose; only their
times are read), or one design choice changed, and times K4 and K5 in
each, with CUDA events, at mamba2-780m's prefill shapes (BC 128 chunks of
Q = 128, H 48 heads of P = 64, G 1, N 128; inputs from a seed).  The
unchanged source is timed first and last, and held against the plain
PyTorch versions (3e-4).  What each copy changes:

* ``one_pass``: the lo.hi and hi.lo passes of every product (one TF32 MMA
  where 3xTF32 issues three);
* ``no_split``: the hi/lo split of every operand (its integer and float
  instructions; the MMAs stay);
* ``no_exp``: K5's per-score decay ``exp(a_i - a_j)`` (the difference is
  used as the weight);
* ``no_scores``: K5's score product C.B^T;
* ``no_causal``: K5's (S o L).x MMAs and their A fragments;
* ``no_carried``: K5's carried-state MMAs and their B fragments;
* ``three_stages``: nothing cut; the copy ring holds three tiles, not two;
* ``heads_48``: nothing cut; a K5 block takes up to 48 heads of a group,
  not 8, so that at mamba2-780m's widths the scores of a (chunk, row
  tile) are computed once, not six times (256 blocks, not 1,536).

It also prints the rate that back-to-back ``mma.sync`` reaches on the card
with no memory traffic (TF32 m16n8k8 and, beside it, bf16 m16n8k16), at 8,
32 and 64 warps an SM: the ceiling of the kernels' products, below the
495 TFLOP/s TF32 rate that only ``wgmma`` reaches.

Usage, from the root of a checkout on a machine with the card and nvcc:
``python3 tools/ssd_probe.py``.  The builds go to ``build/ssd_probe``.  A
variant whose source text is no longer in ``ssd.cu`` stops the script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPE = dict(bc=128, q=128, h=48, p=64, g=1, n=128)   # mamba2-780m prefill
REPS = 20
MMA_ITERS = 2_000

_PASSES = """#pragma unroll
  for (int j = 0; j < T; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < T; ++j) mma_tf32(acc[j], ah, bl[j]);
"""
_SPLIT = """  const uint32_t h = __float_as_uint(v) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(h))) & 0xffffe000u;"""
_CARRIED = """          uint32_t bh[PT][2], bl[PT][2];
          load_b<PT>(ts + (ks + tq) * ldv + gq, ldv, bh, bl);
          mma3_tiles<PT>(acc, ah, al, bh, bl);
        }
      } else if"""

#: variant → [(text in ssd.cu, its replacement)]
VARIANTS = {
    "one_pass": [(_PASSES, "")],
    "no_split": [(_SPLIT, "  hi = lo = __float_as_uint(v);")],
    "no_exp": [("expf(a_h[i] - a_h[j])", "(a_h[i] - a_h[j])")],
    "no_scores": [("      if (active && j0 <= iw_last) {",
                   "      if (active && j0 < 0) {")],
    "no_causal": [("      } else if (active && (k - ptiles) * kKT <= iw_last)"
                   " {", "      } else if (active && k < 0) {")],
    # the A fragments stay live, so that only the B loads and MMAs go
    "no_carried": [(_CARRIED, "          if (ah[0] == 1u) acc[0][0] += al[1];"
                              "\n        }\n      } else if")],
    "three_stages": [("constexpr int kStages = 2;",
                      "constexpr int kStages = 3;")],
    "heads_48": [("constexpr int kOutHeads = 8;",
                  "constexpr int kOutHeads = 48;")],
}

_MMA_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <bool TF32>
__global__ void mma_loop(int iters, float* out) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = TF32 ? (__float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u)
                : 0x3f803f80u;
  b[0] = a[0];
  b[1] = a[1];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(int tf32, int iters, int blocks, int threads,
                        float* out) {
  if (tf32) mma_loop<true><<<blocks, threads>>>(iters, out);
  else mma_loop<false><<<blocks, threads>>>(iters, out);
  return (int)cudaGetLastError();
}
'''


def variant_source(src: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"ssd_probe: the text of variant {name!r} is not"
                             f" in ssd.cu once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(out_dir: Path, sources: dict) -> dict:
    """name → .so path; one nvcc per source, all started together."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssd_probe: nvcc failed for {name}:\n{log}")
    return {name: so for name, (_, so) in procs.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from chip_smoke import card_line, ssd_compare, time_cuda
    from repro_torch.kernels import _build, ssd

    print(f"card: {card_line()}")
    out_dir = REPO / "build" / "ssd_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (REPO / "src/repro_torch/csrc/ssd.cu").read_text()
    sources = {"base": base, "mma_peak": _MMA_SRC}
    sources.update({name: variant_source(base, name) for name in VARIANTS})
    libs = {name: ctypes.CDLL(str(so))
            for name, so in build(out_dir, sources).items()}

    # -- the mma.sync ceiling --------------------------------------------------
    mma = libs.pop("mma_peak")
    mma.mma_peak.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    mma.mma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    peak = []
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for per_sm, threads in ((2, 128), (4, 256), (8, 256)):
            blocks = sms * per_sm
            ms = time_cuda(lambda: _build.check(mma.mma_peak(
                tf32, MMA_ITERS, blocks, threads, out.data_ptr()),
                "mma_peak"), 5, torch)
            mmas = blocks * threads // 32 * MMA_ITERS * 8
            peak.append({"operands": "tf32" if tf32 else "bf16",
                         "warps_per_sm": per_sm * threads // 32, "ms": ms,
                         "tflops": mmas * flop / ms / 1e9})
            print(f"mma.sync {peak[-1]['operands']}, "
                  f"{peak[-1]['warps_per_sm']} warps an SM: "
                  f"{peak[-1]['tflops']:.1f} TFLOP/s")

    # -- the variants ----------------------------------------------------------
    bc, q, h, p, g, n = (SHAPE[k] for k in ("bc", "q", "h", "p", "g", "n"))
    rng = np.random.default_rng(0)

    def up(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    x = up(rng.normal(size=(bc, q, h, p)))
    b = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    c = up(rng.normal(size=(bc, q, g, n)) * 0.3)
    a_cum = up(np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.05, 1))
    prev = up(rng.normal(size=(bc, h, n, p)))
    states = torch.empty((bc, h, n, p), device="cuda")
    a_tot = torch.empty((bc, h), device="cuda")
    y = torch.empty((bc, q, h, p), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def kernels(lib):
        for fn, argtypes in ssd._SIGS.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        return (lambda: _build.check(lib.ssd_chunk_state(
                    x.data_ptr(), b.data_ptr(), a_cum.data_ptr(), bc, q, h,
                    p, g, n, states.data_ptr(), a_tot.data_ptr(), stream),
                    "ssd_chunk_state"),
                lambda: _build.check(lib.ssd_chunk_output(
                    x.data_ptr(), b.data_ptr(), c.data_ptr(),
                    a_cum.data_ptr(), prev.data_ptr(), bc, q, h, p, g, n,
                    y.data_ptr(), stream), "ssd_chunk_output"))

    k4, k5 = kernels(libs["base"])
    k4()
    k5()
    torch.cuda.synchronize()
    err = max(ssd_compare("ssd_chunk_state", states,
                          ssd.ssd_chunk_state_plain(x, b, a_cum)[0]),
              ssd_compare("ssd_chunk_output", y, ssd.ssd_chunk_output_plain(
                  x, b, c, a_cum, prev)))
    print(f"base: K4 and K5 within 3e-4 of the plain versions (max |err| "
          f"{err:.3e})")
    times = {}
    for name in ["base", *VARIANTS, "base"]:
        k4, k5 = kernels(libs[name])
        t = (time_cuda(k4, REPS, torch), time_cuda(k5, REPS, torch))
        times.setdefault(name, []).append(t)
    base_ms = [sum(v) / 2 for v in zip(*times.pop("base"))]
    rows = {"base": {"k4_ms": base_ms[0], "k5_ms": base_ms[1]}}
    print(f"base: K4 {base_ms[0]:.4f} ms, K5 {base_ms[1]:.4f} ms (mean of "
          f"the first and last runs)")
    for name, ((t4, t5),) in times.items():
        rows[name] = {"k4_ms": t4, "k5_ms": t5,
                      "k4_saved_ms": base_ms[0] - t4,
                      "k5_saved_ms": base_ms[1] - t5}
        print(f"{name:12s}: K4 {t4:.4f} ms ({base_ms[0] - t4:+.4f} saved), "
              f"K5 {t5:.4f} ms ({base_ms[1] - t5:+.4f} saved)")
    print(json.dumps({"card": card_line(), "shape": SHAPE, "mma_sync": peak,
                      "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
