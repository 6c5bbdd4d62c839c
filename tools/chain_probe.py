#!/usr/bin/env python3
"""Where ``route_scan``'s time goes, in SM cycles, on the card.

Builds an instrumented copy of ``src/repro_torch/csrc/feed_fused.cu``
(``clock64`` and ``%globaltimer`` read by thread 0 at the kernel's start,
at the end of its parallel prologue and at the end of the routing chain)
plus a few dependent-chain microbenchmarks, then runs ``route_scan`` for
PKG, DC, WC and FISH on one segment at the main path's shapes (16,384
tuples of a z = 1.2 stream over 100,000 keys, 128 workers, candidate width
128; the segment of ``tests/test_torch_cuda.py``) and prints:

* cycles per step of dependent chains on one warp: a shared-memory
  pointer chase, a shared-memory read-compare-write (a PKG step), a
  ``redux.sync`` minimum, a ``shfl.sync``, a ballot + ffs, and an f64
  max + add (a FIFO step);
* per scheme: the prologue's and the chain's cycles, cycles per tuple and
  the SM clock those imply (cycles over globaltimer nanoseconds).

Usage, from the root of a checkout on a machine with the card and nvcc:
``python3 tools/chain_probe.py``.  The build goes to ``build/chain_probe``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
STEPS = 100_000

_PROBES = r'''
__device__ long long g_probe[16];
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''

_MICRO = r'''
__global__ void chains_kernel(int steps, int* out) {
  __shared__ int nxt[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) nxt[i] = (i * 97 + 13) & 1023;
  __syncwarp();
  long long c[8];
  int p = 0;
  c[0] = clock64();
  if (lane == 0) for (int s = 0; s < steps; ++s) p = nxt[p];
  __syncwarp();
  c[1] = clock64();
  int q = 0;
  if (lane == 0) {
    for (int s = 0; s < steps; ++s) {
      const int a0 = nxt[q & 1023], a1 = nxt[(q + 7) & 1023];
      q = a0 <= a1 ? a0 : a1;
      nxt[q] = q;
    }
  }
  __syncwarp();
  c[2] = clock64();
  unsigned v = lane;
  for (int s = 0; s < steps; ++s)
    v = __reduce_min_sync(0xffffffffu, v + lane) + 1u;
  c[3] = clock64();
  int x = lane;
  for (int s = 0; s < steps; ++s) x = __shfl_sync(0xffffffffu, x, (x + 1) & 31);
  c[4] = clock64();
  unsigned bb = lane;
  for (int s = 0; s < steps; ++s)
    bb = __ffs(__ballot_sync(0xffffffffu, ((bb + lane) & 3) == 0)) + bb;
  c[5] = clock64();
  double d = lane;
  for (int s = 0; s < steps; ++s) d = fmax(d, 0.5) + 1.0;
  c[6] = clock64();
  if (lane == 0) {
    for (int k = 0; k < 6; ++k) g_probe[8 + k] = c[k + 1] - c[k];
  }
  out[lane] = p + q + (int)v + x + (int)bb + (int)d;
}
extern "C" int probe_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 16);
}
extern "C" int probe_chains(int steps, int* out) {
  chains_kernel<<<1, 32>>>(steps, out);
  return (int)cudaDeviceSynchronize();
}
'''

_MARKS = {
    "route_scan_kernel(RouteArgs a) {\n": 0,
    "  // the chain: warp 0 walks the tuples": 2,
    "  for (int w = tid; w < w1; w += kRouteThreads) {\n"
    "    a.counts[w] = s_counts[w];": 4,
}


def instrumented_source() -> str:
    src = (REPO / "src/repro_torch/csrc/feed_fused.cu").read_text()
    src = src.replace("namespace {\n", _PROBES + "namespace {\n", 1)
    for mark, slot in _MARKS.items():
        if mark not in src:
            raise SystemExit(f"chain_probe: marker not found: {mark!r}")
        stamp = (f"  if (threadIdx.x == 0) {{ g_probe[{slot}] = clock64(); "
                 f"g_probe[{slot + 1}] = probe_ns(); }}\n")
        if mark.endswith("{\n"):
            src = src.replace(mark, mark + stamp)
        else:
            src = src.replace(mark, stamp + mark)
    return src + _MICRO


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "tests"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import feed_fused as ff

    out_dir = REPO / "build" / "chain_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "feed_fused_probe.cu"
    cu.write_text(instrumented_source())
    so = out_dir / "feed_fused_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in ff._SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_chains.argtypes = [ctypes.c_int, ctypes.c_void_p]
    ff._lib = lambda: lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")

    buf = (ctypes.c_longlong * 16)()
    scratch = torch.zeros(32, dtype=torch.int32, device="cuda")
    lib.probe_chains(STEPS, scratch.data_ptr())
    lib.probe_read(buf)
    names = ("smem_chase", "smem_read_compare_write", "redux_min",
             "shfl_idx", "ballot_ffs", "f64_max_add")
    chains = {n: buf[8 + k] / STEPS for k, n in enumerate(names)}
    print("dependent chains, cycles per step: " + ", ".join(
        f"{n} {v:.1f}" for n, v in chains.items()))

    import test_torch_cuda as TC

    s = TC._segment(seed=12, m=16_384, n_pad=16_384, kcap=100_000,
                    workers=128, z=1.2)
    schemes = {}
    for scheme in ("pkg", "dc", "wc", "fish"):
        TC._run_segment(scheme, s, "cuda")
        torch.cuda.synchronize()
        lib.probe_read(buf)
        pro, chain = buf[2] - buf[0], buf[4] - buf[2]
        ns = buf[5] - buf[3]
        schemes[scheme] = {"prologue_cycles": pro, "chain_cycles": chain,
                           "cycles_per_tuple": chain / s["m"],
                           "chain_ms": ns / 1e6,
                           "sm_mhz": chain / max(ns, 1) * 1e3}
        print(f"route_scan {scheme:4s}: prologue {pro} cycles, chain {chain}"
              f" cycles = {chain / s['m']:.0f} per tuple, {ns / 1e6:.3f} ms"
              f" at {chain / max(ns, 1) * 1e3:.0f} MHz")
    print(json.dumps({"chains": chains, "route_scan": schemes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
