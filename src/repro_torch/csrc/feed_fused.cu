// The fused keyed-stream segment for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/feed_fused.py::_get_seg_fn — one jitted XLA
// launch per (edge, segment) that routes a segment's tuples with one of six
// grouping schemes, runs the per-worker FIFO and scatters the keyed pane
// state.  XLA lowers its per-tuple lax.scans to a sequential loop; PyTorch
// has no scan, and written op for op it would cost one launch per tuple.
// Here the segment is at most five launches:
//
//   ring_rows      (parallel)   consistent-hash candidate rows per tuple
//   tracker_count  (parallel)   int32 per-(epoch ordinal, key) tuple counts
//   tracker_fold   (parallel)   decay + fold the counts into the dense f32
//                               tracker, its snapshot at each epoch's end,
//                               per-(epoch, block) partial sum and max
//   route_fifo     (one block)  the sequential routing scan + FIFO
//   pane_update    (parallel)   pane (value, count) scatter, count plane,
//                               replica matrix, pane_last
//
// The FIFO runs in float64 relative to the feed's first arrival (the
// reference runs it in float32 because a TPU has no f64; at the paper's
// scale a hot FG worker's sequential float32 busy-time sum drifts ~1.5e-4
// from the host engine's float64 closed form, past the 1e-4 contract).
//
// What bounds it on the card: the route_fifo scan is a dependency chain —
// tuple i's choice reads the counts that tuple i-1 wrote — so it runs on
// one warp with the per-worker state (counts, busy, estimator) in shared
// memory, and its time is ~m sequential steps of a warp argmin over at most
// dmax candidates.  The parallel kernels move a few bytes per tuple plus,
// for the trackers, one pass over the dense per-key table; they are bound
// by bytes and by launch latency at 16k-tuple segments.
//
// Frequencies are read at epoch granularity: a FISH tuple classifies
// against the tracker as it stands at the end of its own epoch (the batched
// engine's sub-chunk discipline), not at the end of the segment — a 16k
// segment spans ~16 epochs, and a hot-key flip inside it would otherwise
// reclassify the pre-flip head as light.  DC/WC have no epochs (one
// ordinal per segment).
//
// Determinism: every float sum runs in a fixed order.  The tracker never
// adds floats with atomics (run-to-run order would change the rounding):
// tuples are counted with int32 atomics per (epoch ordinal, key), then each
// key folds its counts ordinal by ordinal (decay, add), and the per-epoch
// total/max reduce in a fixed tree.  Integer atomics (counts, pane sums)
// are exact in any order.  Build with -fmad=false so every float
// expression rounds op by op, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

// route_fifo's arguments; outside the unnamed namespace so the C entry
// that takes it keeps external linkage
struct RouteArgs {
  int scheme;
  int n_pad;
  int m;
  int w1;
  int width;
  const int* rows;      // (n_pad, width) candidates; null for SG
  const int* keys;      // (n_pad,)
  const double* t;      // (n_pad,) arrival time relative to the feed base
  double* busy;         // (w1,) in/out, relative to the feed base
  const double* caps;   // (w1,) seconds per tuple
  int* counts;          // (w1,) in/out, rebased
  int* workers;         // (n_pad,) out
  double* fin;          // (n_pad,) out, relative to the feed base
  const int* act;       // SG: live workers padded to w1
  int a_live;
  int rr;
  int kcap1;
  const float* trk;     // DC/WC/FISH: tracker after this segment's fold
  const float* snap;    // FISH: (ne, kcap1) tracker at each epoch's end
  const float* psum;    // (ne, n_part) per-block partial sums and maxima
  const float* pmax;
  int n_part;
  int ne;               // epochs (ordinals) in the segment; 1 for DC/WC
  long long g0;         // stream index of the segment's first tuple
  int epoch;            // FISH epoch length (0: no epochs)
  float theta;
  float wnum;
  const unsigned char* act_mask;  // WC: live lanes
  int* m_k;             // FISH: CHK monotone memory (kcap1,)
  int d_min;
  float* ebl;           // FISH estimator backlog (w1,) in/out
  float* eas;           // FISH estimator assigned (w1,) in/out
  const float* ecaps;   // FISH estimator capacities (w1,)
  int do_tick;
  float elapsed;
  int* dbuf;            // (n_pad,) scratch: per-tuple candidate count d
  int* mbuf;            // (n_pad,) scratch: FISH m_k update value
};

namespace {

constexpr int kThreads = 256;        // parallel kernels
constexpr int kFoldThreads = 256;    // tracker_fold block (fixed tree order)
constexpr int kRouteThreads = 256;   // route_fifo: the one block
constexpr int kBigI32 = 1 << 30;     // masked candidate wait (int schemes)

enum Scheme { SG = 0, FG = 1, PKG = 2, DC = 3, WC = 4, FISH = 5 };

// ---------------------------------------------------------------------------
// ring_rows: upper_bound of the key hash over the sorted ring points
// (searchsorted side="right", then % R), then the candidate row.
// ---------------------------------------------------------------------------

__global__ void ring_rows_kernel(const unsigned int* __restrict__ pts, int r_n,
                                 const int* __restrict__ cands, int dmax,
                                 int width,
                                 const unsigned int* __restrict__ hashes,
                                 const int* __restrict__ keys, int n_pad,
                                 int m, int* __restrict__ rows) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_pad * width) return;
  const int i = (int)(idx / width);
  const int j = (int)(idx % width);
  if (i >= m) {
    // padding lanes carry key id kcap, one past the hash cache: never read
    rows[idx] = -1;
    return;
  }
  const unsigned int h = keys ? hashes[keys[i]] : hashes[i];
  int lo = 0, hi = r_n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pts[mid] <= h) lo = mid + 1; else hi = mid;
  }
  if (lo == r_n) lo = 0;  // wrap around the ring
  rows[idx] = cands[(long long)lo * dmax + j];
}

// ---------------------------------------------------------------------------
// tracker: counts per (epoch ordinal, key), then an ordered fold that also
// snapshots the tracker at the end of each epoch inside the segment
// ---------------------------------------------------------------------------

__global__ void tracker_count_kernel(const int* __restrict__ keys, int m,
                                     int kcap1, long long g0, int epoch,
                                     int* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  // epoch ordinal inside the segment (0 without epochs: DC/WC)
  const int j = epoch > 0 ? (int)((g0 + i) / epoch - g0 / epoch) : 0;
  atomicAdd(cnt + (long long)j * kcap1 + keys[i], 1);
}

__global__ void tracker_fold_kernel(float* __restrict__ trk, int kcap1,
                                    int* __restrict__ cnt, int ne,
                                    float alpha, int pre,
                                    float* __restrict__ snap,
                                    float* __restrict__ psum,
                                    float* __restrict__ pmax) {
  __shared__ float ssum[kFoldThreads];
  __shared__ float smax[kFoldThreads];
  const int t = threadIdx.x;
  const int k = blockIdx.x * kFoldThreads + t;
  float acc = k < kcap1 ? trk[k] : 0.0f;
  // TimeDecayingUpdate fires before the boundary tuple is counted: once up
  // front for a segment starting on a boundary, then at every ordinal
  if (pre) acc = acc * alpha;
  for (int j = 0; j < ne; ++j) {
    if (k < kcap1) {
      if (j > 0) acc = acc * alpha;
      int* c = cnt + (long long)j * kcap1 + k;
      const int v = *c;
      if (v) {
        acc = acc + (float)v;
        *c = 0;  // the scratch table stays zeroed between segments
      }
      if (snap) snap[(long long)j * kcap1 + k] = acc;
    }
    ssum[t] = acc;
    smax[t] = acc;
    __syncthreads();
    for (int s = kFoldThreads / 2; s > 0; s >>= 1) {
      if (t < s) {
        ssum[t] = ssum[t] + ssum[t + s];
        smax[t] = fmaxf(smax[t], smax[t + s]);
      }
      __syncthreads();
    }
    if (t == 0) {
      psum[(long long)j * gridDim.x + blockIdx.x] = ssum[0];
      pmax[(long long)j * gridDim.x + blockIdx.x] = smax[0];
    }
    __syncthreads();
  }
  if (k < kcap1) trk[k] = acc;
}

// ---------------------------------------------------------------------------
// route_fifo: one block; a parallel prologue, then the sequential scan
// ---------------------------------------------------------------------------


// (value, index) argmin with ties to the lower index, like jnp.argmin
template <typename T>
__device__ __forceinline__ void argmin_merge(T& best, int& bj, T v, int j) {
  if (v < best || (v == best && j < bj)) {
    best = v;
    bj = j;
  }
}

template <typename T>
__device__ __forceinline__ int warp_argmin(T best, int bj) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    argmin_merge(best, bj, ob, oj);
  }
  return __shfl_sync(0xffffffffu, bj, 0);
}

__global__ void __launch_bounds__(kRouteThreads)
route_fifo_kernel(RouteArgs a) {
  extern __shared__ unsigned char smem[];
  const int w1 = a.w1;
  double* s_busy = reinterpret_cast<double*>(smem);
  double* s_caps = s_busy + w1;
  int* s_counts = reinterpret_cast<int*>(s_caps + w1);
  float* s_bl = reinterpret_cast<float*>(s_counts + w1);
  float* s_asn = s_bl + w1;
  float* s_ec = s_asn + w1;
  float* s_tot = s_ec + w1;         // per-epoch tracker total
  float* s_ftop = s_tot + a.ne;     // per-epoch max / total
  __shared__ float red_sum[kRouteThreads];
  __shared__ float red_max[kRouteThreads];

  const int tid = threadIdx.x;
  const int sch = a.scheme;
  const bool tracked = sch == DC || sch == WC || sch == FISH;

  for (int w = tid; w < w1; w += kRouteThreads) {
    s_counts[w] = a.counts[w];
    s_busy[w] = a.busy[w];
    s_caps[w] = a.caps[w];
    if (sch == FISH) {
      // Alg. 3 Eq. 1 estimator tick, once at segment start when due
      float bl = a.ebl[w];
      float asn = a.eas[w];
      const float ec = a.ecaps[w];
      if (a.do_tick) {
        const float work = (bl + asn) * ec;
        bl = work > a.elapsed ? (work - a.elapsed) / ec : 0.0f;
        asn = 0.0f;
      }
      s_bl[w] = bl;
      s_asn[w] = asn;
      s_ec[w] = ec;
    }
  }

  if (tracked) {
    // per epoch: total / max of the tracker, partials in a fixed stride
    // order, then a tree
    for (int j = 0; j < a.ne; ++j) {
      const float* ps = a.psum + (long long)j * a.n_part;
      const float* pm = a.pmax + (long long)j * a.n_part;
      float acc = 0.0f, mx = 0.0f;
      for (int p = tid; p < a.n_part; p += kRouteThreads) {
        acc = acc + ps[p];
        mx = fmaxf(mx, pm[p]);
      }
      red_sum[tid] = acc;
      red_max[tid] = mx;
      __syncthreads();
      for (int s = kRouteThreads / 2; s > 0; s >>= 1) {
        if (tid < s) {
          red_sum[tid] = red_sum[tid] + red_sum[tid + s];
          red_max[tid] = fmaxf(red_max[tid], red_max[tid + s]);
        }
        __syncthreads();
      }
      if (tid == 0) {
        const float total = red_sum[0];
        s_tot[j] = total;
        s_ftop[j] = total > 0.0f ? red_max[0] / total : 0.0f;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // parallel prologue: fixed routes (SG/FG) and per-tuple candidate counts,
  // epoch by epoch — each tuple reads the tracker as of its epoch's end,
  // and FISH's CHK memory M_k as of the epoch's start
  const int n_ep = tracked ? a.ne : 1;
  for (int j = 0; j < n_ep; ++j) {
    int lo = 0, hi = a.m;
    if (tracked && a.epoch > 0) {
      const long long e0 = a.g0 / a.epoch;
      lo = j == 0 ? 0 : (int)min((e0 + j) * a.epoch - a.g0, (long long)a.m);
      hi = (int)min((e0 + j + 1) * a.epoch - a.g0, (long long)a.m);
    }
    const float total = tracked ? s_tot[j] : 0.0f;
    const float f_top = tracked ? s_ftop[j] : 0.0f;
    const float* tj = (a.snap && tracked) ? a.snap + (long long)j * a.kcap1
                                          : a.trk;
    for (int i = lo + tid; i < hi; i += kRouteThreads) {
      if (sch == SG) {
        a.workers[i] = a.act[(a.rr + i) % a.a_live];
      } else if (sch == FG) {
        a.workers[i] = a.rows[(long long)i * a.width];
      } else if (sch == DC || sch == WC) {
        const float f = total > 0.0f ? tj[a.keys[i]] / total : 0.0f;
        const bool hot = f > a.theta;
        float dh = ceilf(f * a.wnum / sqrtf(a.theta));
        dh = fminf(fmaxf(dh, 2.0f), a.wnum);
        // WC hot keys take the argmin over the whole live set (d = -1)
        a.dbuf[i] = hot ? (sch == WC ? -1 : (int)dh) : 2;
      } else if (sch == FISH) {
        const float f = total > 0.0f ? tj[a.keys[i]] / total : 0.0f;
        const bool hot = (f > a.theta) && (f > 0.0f) && (f_top > 0.0f);
        const float ratio = fmaxf(f_top / fmaxf(f, 1e-30f), 1.0f);
        // floor(log2(ratio)) exactly, from the binary exponent
        int idx = ilogbf(ratio);
        idx = idx < 0 ? 0 : (idx > 30 ? 30 : idx);
        float d0f = floorf(ldexpf(a.wnum, -idx));
        d0f = fminf(fmaxf(d0f, (float)a.d_min), a.wnum);
        const int d0 = (int)d0f;
        const int m_prev = a.m_k[a.keys[i]];  // M_k at the epoch's start
        a.dbuf[i] = hot ? max(d0, m_prev) : 2;
        a.mbuf[i] = hot ? max(m_prev, d0) : 0;
      }
    }
    __syncthreads();
    if (sch == FISH) {
      for (int i = lo + tid; i < hi; i += kRouteThreads) {
        const int mv = a.mbuf[i];
        if (mv > 0) atomicMax(a.m_k + a.keys[i], mv);
      }
      __syncthreads();
    }
  }

  // the sequential scan: warp 0, tuple by tuple
  if (tid < 32) {
    const int lane = tid;
    for (int i = 0; i < a.m; ++i) {
      int w;
      if (sch == SG || sch == FG) {
        w = a.workers[i];
      } else {
        const int* r = a.rows + (long long)i * a.width;
        if (sch == PKG) {
          const int a0 = r[0];
          const int a1 = r[1] >= 0 ? r[1] : r[0];
          w = s_counts[a0] <= s_counts[a1] ? a0 : a1;
        } else if (sch == FISH) {
          const int d = min(a.dbuf[i], a.width);
          float best = INFINITY;
          int bj = INT_MAX;
          for (int j = lane; j < d; j += 32) {
            const int c = r[j];
            const float v =
                c >= 0 ? (s_bl[c] + s_asn[c]) * s_ec[c] : INFINITY;
            argmin_merge(best, bj, v, j);
          }
          w = r[warp_argmin(best, bj)];
        } else {
          const int d = a.dbuf[i];
          int best = INT_MAX;
          int bj = INT_MAX;
          if (d < 0) {  // WC hot key: least-loaded live worker, ties to id
            for (int c = lane; c < w1; c += 32) {
              argmin_merge(best, bj, a.act_mask[c] ? s_counts[c] : kBigI32,
                           c);
            }
            w = warp_argmin(best, bj);
          } else {
            const int dd = min(d, a.width);
            for (int j = lane; j < dd; j += 32) {
              const int c = r[j];
              argmin_merge(best, bj, c >= 0 ? s_counts[c] : kBigI32, j);
            }
            w = r[warp_argmin(best, bj)];
          }
        }
      }
      if (lane == 0) {
        s_counts[w] += 1;
        if (sch == FISH) s_asn[w] = s_asn[w] + 1.0f;
        // FIFO, in _fifo_scan's operation order: max(busy, t) + cap
        const double f = fmax(s_busy[w], a.t[i]) + s_caps[w];
        s_busy[w] = f;
        a.fin[i] = f;
        a.workers[i] = w;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int w = tid; w < w1; w += kRouteThreads) {
    a.counts[w] = s_counts[w];
    a.busy[w] = s_busy[w];
    if (sch == FISH) {
      a.ebl[w] = s_bl[w];
      a.eas[w] = s_asn[w];
    }
  }
}

// ---------------------------------------------------------------------------
// pane_update: exact int32 scatters of the routed segment
// ---------------------------------------------------------------------------

__global__ void pane_update_kernel(int has_pane, const int* __restrict__ keys,
                                   const int* __restrict__ workers,
                                   const int* __restrict__ vals, int m,
                                   int w1, int kcap1, int seg_base,
                                   int* __restrict__ pane_tab,
                                   int* __restrict__ pane_cnt,
                                   int* __restrict__ pane_last,
                                   unsigned char* __restrict__ repl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int w = workers[i];
  const int k = keys[i];
  if (has_pane) {
    // worker-major flat index: the host flush's nonzero scan then yields
    // entries grouped per worker with keys ascending
    const long long flat = (long long)w * kcap1 + k;
    atomicAdd(pane_tab + 2 * flat, vals[i]);
    atomicAdd(pane_tab + 2 * flat + 1, 1);
    atomicAdd(pane_cnt + flat, 1);
    atomicMax(pane_last + w, seg_base + i);
  }
  // the replica matrix is (kcap1, w1): transposed against the pane table
  repl[(long long)k * w1 + w] = 1;
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int ring_rows(const unsigned int* pts, int r_n, const int* cands, int dmax,
              int width, const unsigned int* hashes, const int* keys,
              int n_pad, int m, int* rows, cudaStream_t stream) {
  const long long n = (long long)n_pad * width;
  if (n > 0) {
    ring_rows_kernel<<<blocks_for(n, kThreads), kThreads, 0, stream>>>(
        pts, r_n, cands, dmax, width, hashes, keys, n_pad, m, rows);
  }
  return (int)cudaGetLastError();
}

int tracker_count(const int* keys, int m, int kcap1, long long g0, int epoch,
                  int* cnt, cudaStream_t stream) {
  if (m > 0) {
    tracker_count_kernel<<<blocks_for(m, kThreads), kThreads, 0, stream>>>(
        keys, m, kcap1, g0, epoch, cnt);
  }
  return (int)cudaGetLastError();
}

int tracker_fold(float* trk, int kcap1, int* cnt, int ne, float alpha,
                 int pre, float* snap, float* psum, float* pmax,
                 cudaStream_t stream) {
  tracker_fold_kernel<<<blocks_for(kcap1, kFoldThreads), kFoldThreads, 0,
                        stream>>>(trk, kcap1, cnt, ne, alpha, pre, snap, psum,
                                  pmax);
  return (int)cudaGetLastError();
}

int route_fifo(const RouteArgs* args, cudaStream_t stream) {
  const size_t smem = sizeof(double) * 2 * (size_t)args->w1 +
                      sizeof(float) * (4 * (size_t)args->w1 +
                                       2 * (size_t)args->ne);
  route_fifo_kernel<<<1, kRouteThreads, smem, stream>>>(*args);
  return (int)cudaGetLastError();
}

int pane_update(int has_pane, int reset, const int* keys, const int* workers,
                const int* vals, int m, int w1, int kcap1, int seg_base,
                int* pane_tab, int* pane_cnt, int* pane_last,
                unsigned char* repl, cudaStream_t stream) {
  if (has_pane && reset) {
    // first segment of a pane: the tables start from zeros, pane_last
    // from -1 (all bytes 0xff)
    const size_t cells = (size_t)w1 * kcap1;
    cudaMemsetAsync(pane_tab, 0, sizeof(int) * 2 * cells, stream);
    cudaMemsetAsync(pane_cnt, 0, sizeof(int) * cells, stream);
    cudaMemsetAsync(pane_last, 0xff, sizeof(int) * (size_t)w1, stream);
  }
  if (m > 0) {
    pane_update_kernel<<<blocks_for(m, kThreads), kThreads, 0, stream>>>(
        has_pane, keys, workers, vals, m, w1, kcap1, seg_base, pane_tab,
        pane_cnt, pane_last, repl);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
