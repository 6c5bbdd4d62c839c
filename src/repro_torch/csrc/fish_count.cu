// FISH epoch match-and-count for Hopper (sm_90a), plain C interface:
// K1a and K1b (below), and fish_epoch_update, a whole epoch in one launch
// (further down).
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

// ---------------------------------------------------------------------------
// fish_epoch_update: one whole Alg. 1 epoch in one launch, one thread block
// ---------------------------------------------------------------------------
//
// Replaces, on the card, K1b and K1a together with the tail of the
// reference's epoch_update: src/repro/kernels/fish_count.py:50 (fish_count),
// :133 (fish_epoch_count) and the XLA ops that follow them in
// src/repro/core/fish.py::epoch_update (scores or the sort/segment
// candidate pass, top_k, argsort of the counters, the batched ReplaceMin
// scatters).  Output: the new table (keys, counts), bit for bit what
// kernels/fish_count.py::fish_epoch_update_plain computes under the same
// tie rule:
//
//   counts[s] = fl(fl(counts[s] * alpha) + delta[s])      (decay + match)
//   candidates: the epoch's unmatched keys, each with its epoch frequency
//     len, ranked by len descending, equal len by the key's first token
//     position (ties "first", the fused path) or by ascending key ("key",
//     the match path; a negative key is never a candidate there)
//   slots: ranked by eff = (key < 0 ? 0 : counts) ascending, equal eff by
//     slot index
//   for j < min(max_new, K, N) with a j-th candidate: the j-th slot takes
//     its key and fl(eff + len)
//
// Design: the whole epoch lives in the block's shared memory, so no step
// needs the host or a second launch, and every order is a sort on one
// 64-bit key (no float atomics, no order left to the schedule):
//   1. the live table as (key << 32 | slot), bitonic-sorted; each token
//      binary-searches it and adds 1 to every slot of its key with a
//      shared int32 atomicAdd (exact, order-free), so a table that holds a
//      key twice counts it twice, as the plain version does;
//   2. the unmatched tokens as (key << 32 | position), sorted: a run of
//      equal keys is one candidate, its first entry the key's first
//      position and its length (a binary search for the run's end) the
//      key's epoch frequency;
//   3. the candidates as (~len << 32 | position or key) and the slots as
//      (float bits of eff << 32 | slot), sorted together (one barrier a
//      stage for both).  Counts are non-negative, so their IEEE-754 bits
//      order as unsigned integers; -0.0 is taken as +0.0, as a float sort
//      takes it.  (A negative count, which Alg. 1 never makes, would sort
//      above the positive ones here and below them in the plain version.)
//   4. the j-th candidate goes into the j-th slot; the block writes the
//      table out once.
//
// What bounds it: neither bytes (16 K + 4 N of them) nor operations (a few
// times N log N compares), but the chain of barrier-separated sort stages
// on one SM: S(K') + S(N') + S(max(N', K')) stages, S(n) = log2 n (log2 n
// + 1) / 2 for the power-of-two pads K', N' — 165 at the paper's
// N = K = 1,000 — each a shared-memory compare-exchange and a round trip of
// a __syncthreads across the block, which fish_barrier_probe below
// measures.
//
// Size limit: the block needs 16 N' + 8 K' + 8 K bytes of shared memory
// (two epoch-sized 64-bit arrays, one table-sized 64-bit array, the counts
// and an int array of K), at most the 232,448 B (227 KB) a block may use,
// asked for with cudaFuncSetAttribute above 48 KB.  So N <= 8,192 at any K
// (N' = 16,384 alone needs 262,144 B), K <= 4,480 at N = 8,192 (exactly
// 232,448 B; N = 8,192 with K = 4,096 takes 196,608 B), K <= 10,624 at
// N = 1,000.  kernels/fish_count.py::check_epoch_shape refuses larger
// shapes before any launch; the entry returns cudaErrorInvalidValue.

namespace {

typedef unsigned long long u64;

constexpr size_t kEpochSmemLimit = 232448;
constexpr u64 kNone = ~0ull;  // sorts after every real entry

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One compare-exchange stage (k, j) of an ascending bitonic sort of a[0, n),
// n a power of two.
__device__ inline void bitonic_stage(u64* a, int n, int k, int j) {
  for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
    const int i = 2 * t - (t & (j - 1));  // i has bit j clear; partner i + j
    const u64 x = a[i], y = a[i + j];
    if ((x > y) == ((i & k) == 0)) {
      a[i] = y;
      a[i + j] = x;
    }
  }
}

// Sorts a[0, na) and b[0, nb) ascending (powers of two; nb may be 0), the
// stages of both under one barrier.  The caller synchronises before.
__device__ void bitonic_sort2(u64* a, int na, u64* b, int nb) {
  const int n = max(na, nb);
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (k <= na) bitonic_stage(a, na, k, j);
      if (k <= nb) bitonic_stage(b, nb, k, j);
      __syncthreads();
    }
  }
}

// First index in a[lo, hi) whose entry is >= x (a sorted ascending).
__device__ inline int lower_bound(const u64* a, int lo, int hi, u64 x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void fish_epoch_kernel(const int* __restrict__ table,
                                  const float* __restrict__ counts, float alpha,
                                  int k, int k_pad,
                                  const int* __restrict__ keys, int n,
                                  int n_pad, int max_new, int ties_key,
                                  int* __restrict__ keys_out,
                                  float* __restrict__ counts_out) {
  extern __shared__ u64 smem[];
  u64* ep = smem;                  // n_pad: unmatched tokens, then runs
  u64* top = ep + n_pad;           // n_pad: candidates
  u64* tb = top + n_pad;           // k_pad: live table, then slots by eff
  float* cnt = (float*)(tb + k_pad);          // k: decayed counts
  int* sk = (int*)(cnt + k);                  // k: delta, then table keys
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. the live table, sorted by key; delta = 0
  for (int s = tid; s < k_pad; s += nt) {
    const int key = s < k ? table[s] : -1;
    tb[s] = key >= 0 ? ((u64)(unsigned)key << 32) | (unsigned)s : kNone;
  }
  for (int s = tid; s < k; s += nt) sk[s] = 0;
  __syncthreads();
  bitonic_sort2(tb, k_pad, nullptr, 0);

  // match: each token adds 1 to every slot of its key; an unmatched token
  // (a non-negative one only, under ties "key") becomes a candidate entry
  for (int i = tid; i < n_pad; i += nt) {
    u64 e = kNone;
    if (i < n) {
      const int key = keys[i];
      const u64 hk = (u64)(unsigned)key << 32;
      bool hit = false;
      if (key >= 0) {  // an empty slot never matches
        for (int p = lower_bound(tb, 0, k_pad, hk);
             p < k_pad && tb[p] != kNone && (tb[p] & ~0xffffffffull) == hk;
             ++p) {
          atomicAdd(sk + (int)(unsigned)tb[p], 1);
          hit = true;
        }
      }
      if (!hit && (key >= 0 || !ties_key)) e = hk | (unsigned)i;
    }
    ep[i] = e;
  }
  __syncthreads();

  // decay + epoch counts (never contracted into an FMA); sk becomes the
  // table's keys
  for (int s = tid; s < k; s += nt) {
    const int d = sk[s];
    cnt[s] = __fadd_rn(__fmul_rn(counts[s], alpha), (float)d);
    sk[s] = table[s];
  }
  // 2. the unmatched tokens, sorted by (key, position)
  bitonic_sort2(ep, n_pad, nullptr, 0);

  // a run's first entry: its key's first position and its length
  for (int i = tid; i < n_pad; i += nt) {
    const u64 e = ep[i];
    u64 c = kNone;
    if (e != kNone && (i == 0 || (ep[i - 1] >> 32) != (e >> 32))) {
      // the run ends at the first entry >= (key, 0xffffffff): a position
      // is below 2^13, and kNone, whose high word may be the key's, is not
      const int end = lower_bound(ep, i + 1, n_pad, e | 0xffffffffull);
      const unsigned len = (unsigned)(end - i);
      const unsigned tie = ties_key ? (unsigned)(e >> 32) : (unsigned)e;
      c = ((u64)~len << 32) | tie;
    }
    top[i] = c;
  }
  // slots by eff = (key < 0 ? 0 : count), -0.0 as +0.0
  for (int s = tid; s < k_pad; s += nt) {
    u64 e = kNone;
    if (s < k) {
      const float eff = sk[s] < 0 ? 0.0f : cnt[s];
      const unsigned bits = eff == 0.0f ? 0u : __float_as_uint(eff);
      e = ((u64)bits << 32) | (unsigned)s;
    }
    tb[s] = e;
  }
  __syncthreads();
  // 3. candidates (most frequent first) and slots (smallest first)
  bitonic_sort2(top, n_pad, tb, k_pad);

  // 4. batched ReplaceMin: the j-th candidate into the j-th slot (each
  // slot appears once, so no two threads touch one)
  for (int j = tid; j < max_new; j += nt) {
    const u64 c = top[j];
    if (c == kNone) continue;  // fewer candidates than max_new
    const unsigned len = ~(unsigned)(c >> 32);
    const int key = ties_key ? (int)(unsigned)c : keys[(unsigned)c];
    const int s = (int)(unsigned)tb[j];
    const float eff = sk[s] < 0 ? 0.0f : cnt[s];
    cnt[s] = __fadd_rn(eff, (float)len);
    sk[s] = key;
  }
  __syncthreads();
  for (int s = tid; s < k; s += nt) {
    keys_out[s] = sk[s];
    counts_out[s] = cnt[s];
  }
}

__global__ void noop_kernel() {}

// reps stages of: read a neighbour's shared word, write one's own into the
// other buffer, __syncthreads (blockDim a power of two)
__global__ void barrier_probe_kernel(int reps, long long* out) {
  __shared__ int x[2][1024];
  const int t = threadIdx.x, m = blockDim.x - 1;
  x[0][t] = t;
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    x[(r + 1) & 1][t] = x[r & 1][(t + r) & m] + 1;
    __syncthreads();
  }
  const long long t1 = clock64();
  if (t == 0) {
    out[0] = t1 - t0;
    out[1] = x[reps & 1][0];
  }
}

size_t epoch_smem_bytes(int k, int n) {
  return 16 * (size_t)pow2_at_least(n) + 8 * (size_t)pow2_at_least(k) +
         8 * (size_t)k;
}

}  // namespace

// One epoch: keys_out/counts_out (K,) are the new table.  max_new is the
// clipped min(max_new, K, N) (<= 0: no insert); ties_key 0 = "first",
// 1 = "key".  Returns cudaErrorInvalidValue past the size limit (the
// wrapper refuses first).
extern "C" int fish_epoch_update(const int* table, const float* counts,
                                 float alpha, int k, const int* keys, int n,
                                 int max_new, int ties_key, int* keys_out,
                                 float* counts_out, cudaStream_t stream) {
  // past the limit at any size (and pow2_at_least kept in range)
  if (k < 0 || n < 0 || k > 16384 || n > 8192)
    return (int)cudaErrorInvalidValue;
  const size_t smem = epoch_smem_bytes(k, n);
  if (smem > kEpochSmemLimit) return (int)cudaErrorInvalidValue;
  const int k_pad = pow2_at_least(k), n_pad = pow2_at_least(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fish_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = min(1024, max(32, max(n_pad, k_pad) / 2));
  fish_epoch_kernel<<<1, threads, smem, stream>>>(
      table, counts, alpha, k, k_pad, keys, n, n_pad, max_new, ties_key,
      keys_out, counts_out);
  return (int)cudaGetLastError();
}

// Timing floors for chip_smoke.py: an empty launch, and `reps` barrier
// round trips of one block of `threads` (SM cycles into out[0]; out[1]
// keeps the stores alive).
extern "C" int fish_noop(cudaStream_t stream) {
  noop_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int fish_barrier_probe(int threads, int reps, long long* out,
                                  cudaStream_t stream) {
  barrier_probe_kernel<<<1, threads, 0, stream>>>(reps, out);
  return (int)cudaGetLastError();
}
