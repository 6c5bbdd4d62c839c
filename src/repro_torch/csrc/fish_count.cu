// FISH epoch match-and-count for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/fish_count.py::fish_count (K1a) and
// ::fish_epoch_count (K1b), the Pallas kernels behind
// repro.core.fish.epoch_update(match_fn=/fused_fn=) — paper Alg. 1 run a
// whole epoch at a time against the bounded counter table K (-1 = empty).
//
//   K1a: delta[s]   = #{i : keys[i] == table[s] >= 0}, matched[i]
//   K1b: counts'[s] = fl(counts[s] * alpha) + delta[s], matched[i],
//        cand[i]    = #{j : keys[j] == keys[i]}           (O(N^2))
//        first[i]   = no j < i with keys[j] == keys[i]
//
// The TPU kernel walks token blocks in grid order and carries the per-slot
// sums in its resident output block.  Blocks here run in no order, so one
// thread per token adds its hits into an int32 scratch with atomicAdd
// (exact and order-free: never a float atomic), and a second, K-wide
// launch turns the integers into the float counts.  Integer counts are
// exact in float32 below 2^24; the decay is fl(fl(c * alpha) + delta) with
// the _rn intrinsics (never contracted into an FMA), bit for bit what the
// plain PyTorch version computes.
//
// What bounds it on the card: operations.  The compares are N*K (match)
// plus N^2 (K1b's histogram) int32 compares — 2e6 at the paper's sizes
// (N = K = 1000) — against 8 (N + K) bytes of traffic.  The table and the
// epoch's keys stream through shared memory in 1024-entry tiles (4 KB), so
// neither size is bounded by shared memory (the TPU kernel keeps the whole
// epoch resident); every thread of a block reads the same tile entry at
// once (a broadcast, no bank conflicts).  At the paper's sizes a launch is
// latency bound: four blocks of 256 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // table / key entries per shared-memory tile

__global__ void fish_match_kernel(const int* __restrict__ table, int k,
                                  const int* __restrict__ keys, int n,
                                  int* __restrict__ delta,
                                  unsigned char* __restrict__ matched,
                                  float* __restrict__ cand,
                                  unsigned char* __restrict__ first) {
  __shared__ int tile[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int key = i < n ? keys[i] : -1;
  bool hit = false;
  for (int base = 0; base < k; base += kTile) {
    const int len = min(kTile, k - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) tile[j] = table[base + j];
    __syncthreads();
    // a negative key can only equal an empty (negative) slot, which never
    // matches; the padding thread (i >= n) carries -1 for the same reason
    if (key >= 0) {
      for (int j = 0; j < len; ++j) {
        if (tile[j] == key) {
          hit = true;
          atomicAdd(delta + base + j, 1);
        }
      }
    }
  }
  if (i < n) matched[i] = hit ? 1 : 0;
  if (cand == nullptr) return;  // K1a: no histogram
  int same = 0;
  bool earlier = false;
  for (int base = 0; base < n; base += kTile) {
    const int len = min(kTile, n - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) tile[j] = keys[base + j];
    __syncthreads();
    if (i < n) {
      for (int j = 0; j < len; ++j) {
        if (tile[j] == key) {
          ++same;
          earlier |= base + j < i;
        }
      }
    }
  }
  if (i < n) {
    cand[i] = (float)same;
    first[i] = earlier ? 0 : 1;
  }
}

__global__ void fish_finish_kernel(const int* __restrict__ delta, int k,
                                   const float* __restrict__ counts,
                                   float alpha, float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= k) return;
  const float d = (float)delta[s];
  out[s] = counts == nullptr ? d : __fadd_rn(__fmul_rn(counts[s], alpha), d);
}

int launch(const int* table, const float* counts, float alpha, int k,
           const int* keys, int n, int* delta, float* out,
           unsigned char* matched, float* cand, unsigned char* first,
           cudaStream_t stream) {
  if (k > 0) cudaMemsetAsync(delta, 0, sizeof(int) * (size_t)k, stream);
  if (n > 0) {
    fish_match_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(table, k, keys, n, delta, matched, cand,
                                  first);
  }
  if (k > 0) {
    fish_finish_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(delta, k, counts, alpha, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1a: counts (K,) f32 and matched (N,) of one epoch; delta is an int32
// scratch of K entries.
extern "C" int fish_count(const int* table, int k, const int* keys, int n,
                          int* delta, float* counts_out,
                          unsigned char* matched, cudaStream_t stream) {
  return launch(table, nullptr, 0.0f, k, keys, n, delta, counts_out, matched,
                nullptr, nullptr, stream);
}

// K1b: decayed counts + delta, matched, candidate histogram, first flags.
extern "C" int fish_epoch_count(const int* table, const float* counts,
                                float alpha, int k, const int* keys, int n,
                                int* delta, float* counts_out,
                                unsigned char* matched, float* cand,
                                unsigned char* first, cudaStream_t stream) {
  return launch(table, counts, alpha, k, keys, n, delta, counts_out, matched,
                cand, first, stream);
}
