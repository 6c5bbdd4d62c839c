// Keyed-state probe/accumulate for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/store_probe.py::store_probe, the Pallas
// kernel DeviceStateStore._merge calls twice per merge (once per column).
// The TPU kernel builds the full O(N x K) key-vs-slot compare matrix
// block by block in VMEM.  Here the slot table is strictly ascending (the
// caller's precondition, kept by DeviceStateStore), so each token finds its
// slot with a binary search — O(N log K) work.
//
// What bounds it on the card: bytes.  Each token reads its key and value
// (8 B) and ~log2(K) table entries that stay in L1/L2; each hit does two
// int32 atomicAdds into the K-entry sums.  Integer atomics are exact and
// order-free, so the sums are bit-identical to the compare-matrix form no
// matter how the blocks are scheduled.  At the main path's shapes (a few
// hundred tokens per per-worker store) a launch is latency bound; the
// design keeps it to one launch with no host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void store_probe_kernel(const int* __restrict__ table, int k,
                                   const int* __restrict__ keys,
                                   const int* __restrict__ vals, int n,
                                   int* __restrict__ vsum,
                                   int* __restrict__ csum,
                                   unsigned char* __restrict__ matched) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  int lo = 0, hi = k;  // lower bound: first slot with table[slot] >= key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] < key) lo = mid + 1; else hi = mid;
  }
  // empty slots (key -1) never match: the compare-matrix form masks
  // table < 0, and a negative token key cannot hit a live slot
  const bool hit = key >= 0 && lo < k && table[lo] == key;
  matched[i] = hit ? 1 : 0;
  if (hit) {
    atomicAdd(vsum + lo, vals[i]);
    atomicAdd(csum + lo, 1);
  }
}

}  // namespace

extern "C" int store_probe(const int* table, int k, const int* keys,
                           const int* vals, int n, int* vsum, int* csum,
                           unsigned char* matched, cudaStream_t stream) {
  if (k > 0) {
    cudaMemsetAsync(vsum, 0, sizeof(int) * (size_t)k, stream);
    cudaMemsetAsync(csum, 0, sizeof(int) * (size_t)k, stream);
  }
  if (n > 0) {
    store_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(table, k, keys, vals, n, vsum, csum,
                                   matched);
  }
  return (int)cudaGetLastError();
}
