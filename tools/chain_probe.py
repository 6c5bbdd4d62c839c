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
  pointer chase, a shared-memory read-compare-write (the shared walk's
  least step), a ``redux.sync`` minimum, a ``shfl.sync``, a ballot + ffs,
  an f64 max + add (a FIFO step), the register chain's FISH step as
  ``route_scan`` runs it (``RegChain::step`` on one tuple over and over,
  every worker a candidate), and its latency floor: two dependent
  ``redux.sync`` minima and the owner's select, the register chain's
  bound;
* per scheme: the chain ``route_scan`` takes, the prologue's and the
  chain's cycles, cycles per tuple and the SM clock those imply (cycles
  over globaltimer nanoseconds).  ``--workers 257`` runs the same on an
  edge of 257 workers, past the register chain: the shared walk.

Usage, from the root of a checkout on a machine with the card and nvcc:
``python3 tools/chain_probe.py [--workers N]``.  The build goes to
``build/chain_probe``.
"""

from __future__ import annotations

import argparse
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
  long long c[9];
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
  // the register chain's FISH step, K = 4, route_scan's own: 128
  // workers, worker l + 32k at a position no other worker takes (37 is
  // odd: a permutation of 0..127), every worker a candidate
  __shared__ int s_cnt[128], s_act[128];
  __shared__ float s_bl[128], s_asn[128], s_ec[128];
  __shared__ unsigned s_nkey[128];
  for (int w = lane; w < 128; w += 32) {
    s_cnt[w] = 0;
    s_act[w] = 1;
    s_bl[w] = 0.5f;
    s_asn[w] = (float)(w & 3);
    s_ec[w] = 1.25f;
  }
  __syncwarp();
  RegChain<FISH, 4> ch;
  ch.load(s_cnt, s_act, s_bl, s_asn, s_ec, s_nkey, lane, 128);
  RegWords<4> pv;
  pv.q[0] = make_uint4((((lane + 0u) * 37u) & 127u) << 8 | lane,
                       (((lane + 32u) * 37u) & 127u) << 8 | (lane + 32u),
                       (((lane + 64u) * 37u) & 127u) << 8 | (lane + 64u),
                       (((lane + 96u) * 37u) & 127u) << 8 | (lane + 96u));
  ch.first(pv, 128);
  int picks = 0;
  for (int s = 0; s < steps; ++s) {
    picks += ch.step(pv, 128, s_bl, s_asn, s_ec, s_nkey);
  }
  c[7] = clock64();
  // the register chain's latency floor: the least key, the least position
  // among the lanes that hold it, the owner's select, dependent
  unsigned hk = ((lane * 37u) & 31u) | 0x80000000u, lw = lane << 8;
  for (int s = 0; s < steps; ++s) {
    const unsigned klo = __reduce_min_sync(0xffffffffu, hk);
    const unsigned cand = hk == klo ? lw : 0xffffffffu;
    const unsigned jw = __reduce_min_sync(0xffffffffu, cand);
    hk = cand == jw ? hk + 32u : hk;
  }
  c[8] = clock64();
  if (lane == 0) {
    for (int k = 0; k < 8; ++k) g_probe[8 + k] = c[k + 1] - c[k];
  }
  out[lane] = p + q + (int)v + x + (int)bb + (int)d + picks + (int)hk;
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
    "  // the chain on warp 0; warps 1.. stage tile t+1": 2,
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=128,
                    help="the segment's workers (w1 - 1); default 128")
    args = ap.parse_args()
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
             "shfl_idx", "ballot_ffs", "f64_max_add", "reg_chain_step",
             "reg_chain_floor")
    chains = {n: buf[8 + k] / STEPS for k, n in enumerate(names)}
    print("dependent chains, cycles per step: " + ", ".join(
        f"{n} {v:.1f}" for n, v in chains.items()))

    import test_torch_cuda as TC

    s = TC._segment(seed=12, m=16_384, n_pad=16_384, kcap=100_000,
                    workers=args.workers, z=1.2)
    schemes = {}
    for scheme in ("pkg", "dc", "wc", "fish"):
        width = 2 if scheme == "pkg" else s["cands"].shape[1]
        path = ff._route_scan_plan(s["w1"], 1, width).path
        TC._run_segment(scheme, s, "cuda")
        torch.cuda.synchronize()
        lib.probe_read(buf)
        pro, chain = buf[2] - buf[0], buf[4] - buf[2]
        ns = buf[5] - buf[3]
        schemes[scheme] = {"chain": path, "prologue_cycles": pro,
                           "chain_cycles": chain,
                           "cycles_per_tuple": chain / s["m"],
                           "prologue_ms": (buf[3] - buf[1]) / 1e6,
                           "chain_ms": ns / 1e6,
                           "sm_mhz": chain / max(ns, 1) * 1e3}
        print(f"route_scan {scheme:4s} ({path} chain, {args.workers} "
              f"workers): prologue {pro} cycles, chain {chain} cycles = "
              f"{chain / s['m']:.0f} per tuple, {ns / 1e6:.3f} ms at "
              f"{chain / max(ns, 1) * 1e3:.0f} MHz")
    print(json.dumps({"workers": args.workers, "chains": chains,
                      "route_scan": schemes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
