#!/usr/bin/env python3
"""What one thread-block cluster costs on the card: the latency of a
shared-memory access (local, through the cluster window, remote) and of a
cluster barrier, each alone and with every thread of the cluster at it.

``tracker_segment`` runs as one cluster; these numbers say which of its
operations are worth avoiding.  The kernel below (built into
``build/cluster_probe/``) fills each block's 64 KB of shared memory with a
permutation, then has one thread (``all_threads`` false) or every thread
follow a chain of 64 dependent operations of one kind: a load from its
own shared memory, from its own through the cluster window, from the
next block's (remote), a remote CAS or atomicAdd, a local CAS, a local
atomicAdd that every thread of the block aims at one address, or 64
cluster or block barriers.  Prints one JSON line per (cluster, block
size, operation, load): the median cycles per operation over the
threads that ran it (``clock64``), and the card's name and power limit.

Usage, from the root of a checkout on a machine with the card and nvcc:
``python3 tools/cluster_probe.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ITERS = 64
OPS = ("local load", "remote load", "remote CAS", "remote atomicAdd",
       "load through the cluster window", "cluster barrier", "block barrier",
       "local CAS", "local atomicAdd, one address")
ALONE = (0, 1, 2, 3, 4, 7)  # the operations also timed on one thread

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void chase(int op, int all, int iters, unsigned long long* out) {
  extern __shared__ unsigned sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  for (int i = tid; i < 16384; i += blockDim.x) sm[i] = (i * 7 + 13) & 16383;
  cluster.sync();
  unsigned* remote =
      cluster.map_shared_rank(sm, (rank + 1) % (int)cluster.num_blocks());
  unsigned* window = cluster.map_shared_rank(sm, rank);
  const bool active = all || (tid == 0 && rank == 1);
  unsigned x = (unsigned)(tid * 33) & 16383;
  const long long t0 = clock64();
  if (active) {
    switch (op) {
      case 0: for (int i = 0; i < iters; ++i) x = sm[x]; break;
      case 1: for (int i = 0; i < iters; ++i) x = remote[x]; break;
      case 2:
        for (int i = 0; i < iters; ++i) {
          x = atomicCAS(&remote[x], 0xffffffffu, 0u) & 16383;
        }
        break;
      case 3:
        for (int i = 0; i < iters; ++i) x = atomicAdd(&remote[x], 0u) & 16383;
        break;
      case 4: for (int i = 0; i < iters; ++i) x = window[x]; break;
      case 5: for (int i = 0; i < iters; ++i) cluster.sync(); break;
      case 6: for (int i = 0; i < iters; ++i) __syncthreads(); break;
      case 7:
        for (int i = 0; i < iters; ++i) {
          x = atomicCAS(&sm[x], 0xffffffffu, 0u) & 16383;
        }
        break;
      case 8:
        for (int i = 0; i < iters; ++i) x += atomicAdd(&sm[16383], 0u) & 1u;
        break;
    }
  }
  const long long t1 = clock64();
  if (active) out[rank * blockDim.x + tid] = (unsigned long long)(t1 - t0);
  if (x == 0xdeadbeefu) out[0] = x;
  cluster.sync();  // no block leaves while another reads its memory
}

extern "C" int run(int c, int threads, int op, int all, int iters,
                   unsigned long long* host) {
  const size_t n = (size_t)c * threads;
  unsigned long long* d = nullptr;
  cudaError_t e = cudaMalloc(&d, n * 8);
  if (e != cudaSuccess) return (int)e;
  cudaMemset(d, 0, n * 8);
  cudaFuncSetAttribute(chase, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       65536);
  cudaFuncSetAttribute(chase, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 65536;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, chase, op, all, iters, d);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) {
    e = cudaMemcpy(host, d, n * 8, cudaMemcpyDeviceToHost);
  }
  cudaFree(d);
  return (int)e;
}
"""


def build(root: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build

    out = root / "build" / "cluster_probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "cluster_probe.cu", out / "cluster_probe.so"
    cu.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    lib = build(Path(__file__).resolve().parents[1])
    for c in (16, 8):
        for threads in (1024, 256):
            for op, name in enumerate(OPS):
                for all_threads in ((False, True) if op in ALONE
                                    else (True,)):
                    buf = (ctypes.c_ulonglong * (c * threads))()
                    for _ in range(2):  # the first run warms the card
                        err = lib.run(c, threads, op, int(all_threads),
                                      ITERS, ctypes.addressof(buf))
                    if err:
                        print(f"cluster_probe: CUDA error {err} ({name})",
                              file=sys.stderr)
                        return 1
                    cyc = np.frombuffer(buf, dtype=np.uint64)
                    cyc = cyc[cyc > 0].astype(np.float64) / ITERS
                    print(json.dumps({
                        "cluster": c, "threads": threads, "op": name,
                        "all_threads": all_threads,
                        "cycles_per_op": float(np.median(cyc)),
                        "max": float(cyc.max())}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
