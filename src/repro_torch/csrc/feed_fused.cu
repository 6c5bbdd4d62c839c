// The fused keyed-stream segment for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/feed_fused.py::_get_seg_fn — one jitted XLA
// launch per (edge, segment) that routes a segment's tuples with one of six
// grouping schemes, runs the per-worker FIFO and scatters the keyed pane
// state.  XLA lowers its per-tuple lax.scans to a sequential loop; PyTorch
// has no scan, and written op for op it would cost one launch per tuple.
// Here the segment is at most six launches:
//
//   ring_rows      (parallel)   consistent-hash candidate rows per tuple
//   tracker_count  (parallel)   int32 per-(epoch ordinal, key) tuple counts
//   tracker_fold   (parallel)   decay + fold the counts into the dense f32
//                               tracker, its snapshot at each epoch's end,
//                               per-(epoch, block) partial sum and max
//   route_scan     (one block)  PKG/DC/WC/FISH: the sequential routing
//                               chain (SG/FG routes are fixed: no launch)
//   fifo_workers   (a warp per  the per-worker FIFO; SG/FG gather their
//                   worker)     fixed routes here
//   pane_update    (parallel)   pane (value, count) scatter, count plane,
//                               replica matrix, pane_last
//
// The FIFO runs in float64 relative to the feed's first arrival (the
// reference runs it in float32 because a TPU has no f64; at the paper's
// scale a hot FG worker's sequential float32 busy-time sum drifts ~1.5e-4
// from the host engine's float64 closed form, past the 1e-4 contract).
//
// What bounds it on the card: routing is a dependency chain — tuple i's
// choice reads the counts (or FISH's estimator) that tuple i-1 wrote — so
// route_scan runs it on one warp: ~m dependent steps of a shared-memory
// read-compare-write, plus a warp argmin (two redux.sync) for the wide
// tuples.  Device memory stays off the chain: the block's other warps
// stage the next tile of (d, candidate rows) into shared memory by
// cp.async while warp 0 walks the current one, and FISH's per-worker wait
// (bl + asn) * ec is kept in shared memory and refreshed only for the
// worker that was picked.  The FIFO reads nothing that routing writes
// except the route, and each worker's recurrence is independent of every
// other's, so fifo_workers runs one warp per worker: bound by its longest
// per-worker run of dependent f64 max + add.  The parallel kernels move a
// few bytes per tuple plus, for the trackers, one pass over the dense
// per-key table; they are bound by bytes and by launch latency at
// 16k-tuple segments.
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
#include <cuda_pipeline.h>
#include <math.h>

// route_scan's arguments; outside the unnamed namespace so the C entry
// that takes it keeps external linkage
struct RouteArgs {
  int scheme;           // PKG, DC, WC or FISH (SG/FG routes are fixed)
  int m;
  int w1;
  int width;
  const int* rows;      // (n_pad, width) candidates
  const int* keys;      // (n_pad,)
  int* counts;          // (w1,) in/out, rebased
  int* workers;         // (n_pad,) out
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
constexpr int kRouteThreads = 256;   // route_scan: the one block
constexpr int kTileInts = 8192;      // route_scan: ints per staged tile
constexpr int kTileMax = 1024;       // route_scan: tuples per staged tile
constexpr int kLaneCands = 4;        // route_scan: candidates a lane keeps
                                     // in registers (128 per warp); the
                                     // select tree below is written for 4
constexpr int kFifoWarps = 4;        // fifo_workers: workers per block
constexpr int kFifoUnroll = 4;       // fifo_workers: 32-tuple strides per load
constexpr int kBigI32 = 1 << 30;     // masked candidate wait (int schemes)

// route_scan's tuples per staged tile at a candidate width
__host__ __device__ inline int route_tile(int width) {
  const int per = kTileInts / (width > 1 ? width : 1);
  return per < 1 ? 1 : (per > kTileMax ? kTileMax : per);
}

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
// route_scan: one block; a parallel prologue, then the routing chain on
// warp 0 while the other warps stage the next tile of candidates
// ---------------------------------------------------------------------------

// (key, index, candidate) argmin with ties to the lower index, like
// jnp.argmin
__device__ __forceinline__ void argmin_merge(unsigned& best, int& bj, int& bc,
                                             unsigned v, int j, int c) {
  if (v < best || (v == best && j < bj)) {
    best = v;
    bj = j;
    bc = c;
  }
}

// order-preserving unsigned keys, so a warp argmin is two redux.sync
// minimum reductions instead of five shuffle rounds
__device__ __forceinline__ unsigned int_key(int v) {
  return (unsigned)v ^ 0x80000000u;
}

__device__ __forceinline__ unsigned float_key(float v) {
  // -0 and +0 compare equal as floats: fold -0 onto +0 first
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the lane-wise (key, index) minima → the warp's index, ties to the lower
// index; every lane gets the result
__device__ __forceinline__ int warp_argmin(unsigned best, int bj) {
  const unsigned lo = __reduce_min_sync(0xffffffffu, best);
  return (int)__reduce_min_sync(0xffffffffu,
                                best == lo ? (unsigned)bj : 0xffffffffu);
}

// candidate x's wait as an argmin key: FISH's estimator (bl + asn) * ec,
// the others' count; a masked candidate (-1) waits forever.  The load is
// unconditional (slot 0 for a masked one) so the key is a select, not a
// branch
template <int SCH>
__device__ __forceinline__ unsigned cand_key(int x, const float* s_wait,
                                             const int* s_counts) {
  const int xi = x >= 0 ? x : 0;
  if (SCH == FISH) {
    const float v = s_wait[xi];
    return float_key(x >= 0 ? v : INFINITY);
  }
  const int v = s_counts[xi];
  return int_key(x >= 0 ? v : kBigI32);
}

// a lane's four (key, position lane + 32k, candidate) folded by a select
// tree: the lower position wins ties, as argmin_merge in position order
__device__ __forceinline__ void fold4(const unsigned (&key)[kLaneCands],
                                      const int (&c)[kLaneCands], int lane,
                                      unsigned& best, int& bj, int& bc) {
  static_assert(kLaneCands == 4, "the tree folds four candidates");
  const bool s1 = key[1] < key[0];
  const bool s3 = key[3] < key[2];
  const unsigned k01 = s1 ? key[1] : key[0];
  const unsigned k23 = s3 ? key[3] : key[2];
  const bool hi = k23 < k01;
  best = hi ? k23 : k01;
  bj = lane + 32 * (hi ? (s3 ? 3 : 2) : (s1 ? 1 : 0));
  bc = hi ? (s3 ? c[3] : c[2]) : (s1 ? c[1] : c[0]);
}

// a tuple's candidates for this lane, j = lane + 32k < min(d, width), and
// r[1] for lane 0's light path; entries past min(d, width) are not read
__device__ __forceinline__ void load_cands(const int* r, int d, int width,
                                           int lane, int (&c)[kLaneCands],
                                           int& c1) {
  const int dd = min(d, width);
#pragma unroll
  for (int k = 0; k < kLaneCands; ++k) {
    const int j = lane + 32 * k;
    c[k] = j < dd ? r[j] : -1;
  }
  c1 = dd >= 2 ? r[1] : -1;
}

// tile t's candidate rows and d values → shared buffer buf, by cp.async
// (rows of consecutive tuples are contiguous in global and shared memory)
__device__ __forceinline__ void stage_tile(const RouteArgs& a, int t, int buf,
                                           int* s_rows, int* s_d, int ptid,
                                           int nprod) {
  const int tile = route_tile(a.width);
  const int i0 = t * tile;
  const int tn = min(tile, a.m - i0);
  const int total = tn * a.width;
  int* dst = s_rows + (long long)buf * tile * a.width;
  const int* src = a.rows + (long long)i0 * a.width;
  const bool vec = (a.width % 4 == 0) &&
                   (reinterpret_cast<unsigned long long>(a.rows) % 16 == 0);
  if (vec) {
    for (int q = ptid; q < total / 4; q += nprod) {
      __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
    }
  } else {
    for (int q = ptid; q < total; q += nprod) {
      __pipeline_memcpy_async(dst + q, src + q, 4);
    }
  }
  for (int q = ptid; q < tn; q += nprod) {
    __pipeline_memcpy_async(s_d + buf * tile + q, a.dbuf + i0 + q, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

template <int SCH>
__global__ void __launch_bounds__(kRouteThreads)
route_scan_kernel(RouteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w1 = a.w1;
  const int tile = route_tile(a.width);
  // the staged tiles first (16-byte aligned for the vector copies)
  int* s_rows = reinterpret_cast<int*>(smem);    // 2 x tile x width
  int* s_d = s_rows + 2 * tile * a.width;        // 2 x tile
  int* s_counts = s_d + 2 * tile;
  int* s_act = s_counts + w1;                    // WC: live lanes
  float* s_bl = reinterpret_cast<float*>(s_act + w1);
  float* s_asn = s_bl + w1;
  float* s_ec = s_asn + w1;
  float* s_wait = s_ec + w1;        // FISH: (bl + asn) * ec per worker
  float* s_tot = s_wait + w1;       // per-epoch tracker total
  float* s_ftop = s_tot + a.ne;     // per-epoch max / total
  __shared__ float red_sum[kRouteThreads];
  __shared__ float red_max[kRouteThreads];

  const int tid = threadIdx.x;
  constexpr int sch = SCH;
  constexpr bool tracked = sch == DC || sch == WC || sch == FISH;

  for (int w = tid; w < w1; w += kRouteThreads) {
    s_counts[w] = a.counts[w];
    s_act[w] = (sch == WC) ? (int)a.act_mask[w] : 0;
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
      s_wait[w] = (bl + asn) * ec;
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

  // parallel prologue: per-tuple candidate counts, epoch by epoch — each
  // tuple reads the tracker as of its epoch's end, and FISH's CHK memory
  // M_k as of the epoch's start
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
      if (sch == PKG) {
        a.dbuf[i] = 2;
      } else if (sch == DC || sch == WC) {
        const float f = total > 0.0f ? tj[a.keys[i]] / total : 0.0f;
        const bool hot = f > a.theta;
        float dh = ceilf(f * a.wnum / sqrtf(a.theta));
        dh = fminf(fmaxf(dh, 2.0f), a.wnum);
        // WC hot keys take the argmin over the whole live set (d = -1)
        a.dbuf[i] = hot ? (sch == WC ? -1 : (int)dh) : 2;
      } else {  // FISH
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

  // the chain: warp 0 walks the tuples with every operand in shared
  // memory; warps 1.. stage tile t+1 while warp 0 walks tile t
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ptid = tid - 32;
  const int nprod = kRouteThreads - 32;
  const int ntiles = (a.m + tile - 1) / tile;
  if (warp > 0 && ntiles > 0) stage_tile(a, 0, 0, s_rows, s_d, ptid, nprod);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (warp == 0) {
      const int i0 = t * tile;
      const int tn = min(tile, a.m - i0);
      const int* rb = s_rows + (long long)buf * tile * a.width;
      const int* db = s_d + buf * tile;
      // this tuple's d and candidates in registers; the next tuple's are
      // read while this one walks the chain.  Every lane computes every
      // pick from broadcast shared loads (no divergence); lane 0 stores
      // it, and a __syncwarp publishes the stores to the next tuple
      int d = db[0];
      int c[kLaneCands];
      int c1;
      load_cands(rb, d, a.width, lane, c, c1);
      for (int ti = 0; ti < tn; ++ti) {
        const int* r = rb + (long long)ti * a.width;
        int nd = 0;
        int nc[kLaneCands] = {};
        int nc1 = -1;
        if (ti + 1 < tn) {
          nd = db[ti + 1];
          load_cands(r + a.width, nd, a.width, lane, nc, nc1);
        }
        const int dd = min(d, a.width);
        int w;
        if (sch == PKG) {
          const int a1 = c1 >= 0 ? c1 : c[0];
          w = s_counts[c[0]] <= s_counts[a1] ? c[0] : a1;
        } else if (d >= 0 && dd <= 2) {
          // light tuple: the two candidates, no shuffles
          const int x1 = dd == 2 ? c1 : -1;
          if (sch == FISH) {
            const float v0 = c[0] >= 0 ? s_wait[c[0]] : INFINITY;
            const float v1 = x1 >= 0 ? s_wait[x1] : INFINITY;
            w = (dd == 2 && v1 < v0) ? x1 : c[0];
          } else {
            const int v0 = c[0] >= 0 ? s_counts[c[0]] : kBigI32;
            const int v1 = x1 >= 0 ? s_counts[x1] : kBigI32;
            w = (dd == 2 && v1 < v0) ? x1 : c[0];
          }
        } else if (sch == WC && d < 0) {
          // WC hot key: least-loaded live worker, ties to id
          unsigned key[kLaneCands];
          int ids[kLaneCands];
#pragma unroll
          for (int k = 0; k < kLaneCands; ++k) {
            const int x = lane + 32 * k;
            const int xi = x < w1 ? x : 0;
            const unsigned kk = int_key(s_act[xi] ? s_counts[xi] : kBigI32);
            key[k] = x < w1 ? kk : 0xffffffffu;
            ids[k] = x;
          }
          unsigned best;
          int bj, bc;
          fold4(key, ids, lane, best, bj, bc);
          for (int x = lane + 32 * kLaneCands; x < w1; x += 32) {
            argmin_merge(best, bj, bc,
                         int_key(s_act[x] ? s_counts[x] : kBigI32), x, x);
          }
          w = warp_argmin(best, bj);
        } else {
          // wide argmin, ties to the lower candidate position.  A lane's
          // four candidates load together (clamped index, no branch), then
          // fold in a select tree that keeps the lower position on ties
          unsigned key[kLaneCands];
#pragma unroll
          for (int k = 0; k < kLaneCands; ++k) {
            const unsigned kk = cand_key<sch>(c[k], s_wait, s_counts);
            key[k] = lane + 32 * k < dd ? kk : 0xffffffffu;
          }
          unsigned best;
          int bj, bc;
          fold4(key, c, lane, best, bj, bc);
          for (int j = lane + 32 * kLaneCands; j < dd; j += 32) {
            const int x = r[j];
            argmin_merge(best, bj, bc, cand_key<sch>(x, s_wait, s_counts), j,
                         x);
          }
          const int jw = warp_argmin(best, bj);
          w = __shfl_sync(0xffffffffu, bc, jw & 31);
        }
        // commit: every lane reads, lane 0 writes
        const int cnt = s_counts[w] + 1;
        if (sch == FISH) {
          const float asn = s_asn[w] + 1.0f;
          const float wait = (s_bl[w] + asn) * s_ec[w];
          if (lane == 0) {
            s_asn[w] = asn;
            s_wait[w] = wait;
          }
        }
        if (lane == 0) {
          s_counts[w] = cnt;
          a.workers[i0 + ti] = w;
        }
        __syncwarp();
        d = nd;
#pragma unroll
        for (int k = 0; k < kLaneCands; ++k) c[k] = nc[k];
        c1 = nc1;
      }
    } else if (t + 1 < ntiles) {
      stage_tile(a, t + 1, buf ^ 1, s_rows, s_d, ptid, nprod);
    }
    __syncthreads();
  }

  for (int w = tid; w < w1; w += kRouteThreads) {
    a.counts[w] = s_counts[w];
    if (sch == FISH) {
      a.ebl[w] = s_bl[w];
      a.eas[w] = s_asn[w];
    }
  }
}

// ---------------------------------------------------------------------------
// fifo_workers: one warp per worker lane walks that worker's tuples in
// arrival order — f = max(busy, t) + cap, _fifo_scan's operation order
// ---------------------------------------------------------------------------

// one 128-tuple stride's routes (SG/FG: the fixed route) and arrivals;
// -1 past m (padding lanes are never read)
__device__ __forceinline__ void fifo_load(
    int scheme, int i0, int m, int lane, int width, const int* rows,
    const int* act, int a_live, int rr, const int* workers, const double* t,
    int (&wk)[kFifoUnroll], double (&tk)[kFifoUnroll]) {
#pragma unroll
  for (int u = 0; u < kFifoUnroll; ++u) {
    const int i = i0 + u * 32 + lane;
    int x = -1;
    double ti = 0.0;
    if (i < m) {
      if (scheme == SG) {
        x = act[(rr + i) % a_live];
      } else if (scheme == FG) {
        x = rows[(long long)i * width];
      } else {
        x = workers[i];
      }
      ti = t[i];
    }
    wk[u] = x;
    tk[u] = ti;
  }
}

__global__ void __launch_bounds__(kFifoWarps * 32)
fifo_workers_kernel(int scheme, int m, int w1, int width,
                    const int* __restrict__ rows, const int* __restrict__ act,
                    int a_live, int rr, int* __restrict__ workers,
                    const double* __restrict__ t, double* __restrict__ busy,
                    const double* __restrict__ caps, int* __restrict__ counts,
                    double* __restrict__ fin) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kFifoWarps + (threadIdx.x >> 5);
  if (w >= w1) return;  // the whole warp
  const bool fixed = scheme == SG || scheme == FG;
  double b = busy[w];
  const double cap = caps[w];
  int n_w = 0;
  // stride i0's routes and arrivals are loaded while stride i0 - 128 is
  // walked
  int wk[kFifoUnroll];
  double tk[kFifoUnroll];
  fifo_load(scheme, 0, m, lane, width, rows, act, a_live, rr, workers, t, wk,
            tk);
  for (int i0 = 0; i0 < m; i0 += 32 * kFifoUnroll) {
    int nwk[kFifoUnroll];
    double ntk[kFifoUnroll];
    fifo_load(scheme, i0 + 32 * kFifoUnroll, m, lane, width, rows, act,
              a_live, rr, workers, t, nwk, ntk);
#pragma unroll
    for (int u = 0; u < kFifoUnroll; ++u) {
      const int i = i0 + u * 32 + lane;
      const bool mine = wk[u] == w;
      if (mine && fixed) workers[i] = w;
      unsigned bal = __ballot_sync(0xffffffffu, mine);
      n_w += __popc(bal);
      if (bal == 0u) continue;  // uniform across the warp
      // walk the matches in lane order; the next match's arrival is
      // shuffled in before this one's max + add, off the busy chain
      int src = __ffs(bal) - 1;
      double tt = __shfl_sync(0xffffffffu, tk[u], src);
      double mine_f = 0.0;
      while (true) {
        bal &= bal - 1;
        const int nsrc = bal ? __ffs(bal) - 1 : src;
        const double ntt = __shfl_sync(0xffffffffu, tk[u], nsrc);
        b = fmax(b, tt) + cap;
        mine_f = lane == src ? b : mine_f;
        if (!bal) break;
        src = nsrc;
        tt = ntt;
      }
      if (mine) fin[i] = mine_f;
    }
#pragma unroll
    for (int u = 0; u < kFifoUnroll; ++u) {
      wk[u] = nwk[u];
      tk[u] = ntk[u];
    }
  }
  if (lane == 0) {
    busy[w] = b;
    if (fixed) counts[w] += n_w;  // routed schemes counted in route_scan
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

int route_scan(const RouteArgs* args, cudaStream_t stream) {
  const RouteArgs& a = *args;
  const int tile = route_tile(a.width);
  const size_t smem =
      sizeof(int) * (2 * (size_t)tile * a.width + 2 * (size_t)tile +
                     2 * (size_t)a.w1) +
      sizeof(float) * (4 * (size_t)a.w1 + 2 * (size_t)a.ne);
  // one instantiation per routed scheme: no scheme test on the chain
  void (*kernel)(RouteArgs) =
      a.scheme == PKG  ? route_scan_kernel<PKG>
      : a.scheme == DC ? route_scan_kernel<DC>
      : a.scheme == WC ? route_scan_kernel<WC>
                       : route_scan_kernel<FISH>;
  if (a.scheme != PKG && a.scheme != DC && a.scheme != WC &&
      a.scheme != FISH) {
    return (int)cudaErrorInvalidValue;
  }
  // above 48 KB a block's dynamic shared memory must be asked for; a
  // refused size surfaces here or as the launch's error
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, kRouteThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int fifo_workers(int scheme, int m, int w1, int width, const int* rows,
                 const int* act, int a_live, int rr, int* workers,
                 const double* t, double* busy, const double* caps,
                 int* counts, double* fin, cudaStream_t stream) {
  if (w1 > 0) {
    fifo_workers_kernel<<<blocks_for(w1, kFifoWarps), kFifoWarps * 32, 0,
                          stream>>>(scheme, m, w1, width, rows, act, a_live,
                                    rr, workers, t, busy, caps, counts, fin);
  }
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
