// Keyed-state probe/accumulate for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/store_probe.py::store_probe, the Pallas
// kernel DeviceStateStore._merge calls twice per merge (once per column).
// The TPU kernel builds the full O(N x K) key-vs-slot compare matrix
// block by block in VMEM.  Here each slot table is strictly ascending (the
// caller's precondition, kept by DeviceStateStore), so each token finds its
// slot with a binary search — O(N log K) work.
//
// One launch folds G (slot table, chunk) pairs: a pane sync merges one
// chunk into each of up to a few hundred per-worker stores, and one launch
// per store (two, one per column, in the TPU kernel's shape) left the card
// waiting on the host's issue rate.  Tokens of all pairs are packed
// back to back; a token finds its pair by a binary search over the G+1
// token offsets, then its slot in that pair's table, and adds its value
// and count (1, or the pair's count column: both columns of a merge in
// the same launch) straight into that pair's output columns.  G = 1 with
// its own arguments is ops.store_probe: the TPU kernel's function.
//
// What bounds it on the card: bytes.  Each token reads its key, value and
// count (12 B) and ~log2(K) table entries that stay in L1/L2; each hit does
// two int32 atomicAdds into the K-entry sums.  Integer atomics are exact
// and order-free, so the sums are bit-identical to the compare-matrix form
// no matter how the blocks are scheduled.  At the main path's shapes (a
// pane sync of ~25k tokens over 128 tables) a launch is latency bound; the
// design keeps the whole sync to one launch with no host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// meta (int64, 5G+1): table pointer[G], table length[G], token offset[G+1],
// value-out pointer[G], count-out pointer[G]
__global__ void store_probe_kernel(int g_n, const long long* __restrict__ meta,
                                   const int* __restrict__ table1, int k1,
                                   int* __restrict__ vout1,
                                   int* __restrict__ cout1,
                                   const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ cnts, int n,
                                   unsigned char* __restrict__ matched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* table = table1;
  int k = k1;
  int* vout = vout1;
  int* cout = cout1;
  if (meta) {
    // the pair: last g with off[g] <= i (empty pairs share an offset)
    const long long* off = meta + 2 * g_n;
    int lo = 0, hi = g_n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    table = reinterpret_cast<const int*>(meta[lo]);
    k = (int)meta[g_n + lo];
    vout = reinterpret_cast<int*>(meta[3 * g_n + 1 + lo]);
    cout = reinterpret_cast<int*>(meta[4 * g_n + 1 + lo]);
  }
  const int key = keys[i];
  int lo = 0, hi = k;  // lower bound: first slot with table[slot] >= key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] < key) lo = mid + 1; else hi = mid;
  }
  // empty slots (key -1) never match: the compare-matrix form masks
  // table < 0, and a negative token key cannot hit a live slot
  const bool hit = key >= 0 && lo < k && table[lo] == key;
  if (matched) matched[i] = hit ? 1 : 0;
  if (hit) {
    atomicAdd(vout + lo, vals[i]);
    atomicAdd(cout + lo, cnts ? cnts[i] : 1);
  }
}

}  // namespace

extern "C" {

// G = 1: fresh sums (vsum, csum zeroed here) and the per-token hit flags
int store_probe(const int* table, int k, const int* keys, const int* vals,
                int n, int* vsum, int* csum, unsigned char* matched,
                cudaStream_t stream) {
  if (k > 0) {
    cudaMemsetAsync(vsum, 0, sizeof(int) * (size_t)k, stream);
    cudaMemsetAsync(csum, 0, sizeof(int) * (size_t)k, stream);
  }
  if (n > 0) {
    store_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(0, nullptr, table, k, vsum, csum, keys,
                                   vals, nullptr, n, matched);
  }
  return (int)cudaGetLastError();
}

// G pairs described by the device array meta; adds into each pair's
// output columns (no zeroing, no hit flags).  cnts may be null (count 1).
int store_probe_grouped(int g_n, const long long* meta, const int* keys,
                        const int* vals, const int* cnts, int n,
                        cudaStream_t stream) {
  if (n > 0 && g_n > 0) {
    store_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(g_n, meta, nullptr, 0, nullptr, nullptr,
                                   keys, vals, cnts, n, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
