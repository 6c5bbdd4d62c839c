// The fused keyed-stream segment for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/feed_fused.py::_get_seg_fn — one jitted XLA
// launch per (edge, segment) that routes a segment's tuples with one of six
// grouping schemes, runs the per-worker FIFO and scatters the keyed pane
// state.  XLA lowers its per-tuple lax.scans to a sequential loop; PyTorch
// has no scan, and written op for op it would cost one launch per tuple.
// Here the segment is at most five launches:
//
//   ring_rows       (parallel)   consistent-hash candidate rows per tuple
//   tracker_segment (a cluster)  DC/WC/FISH: the tracker's update in one
//                                launch — per tuple its key's value at the
//                                end of its epoch, per epoch the carried
//                                total and max, the dense tracker decayed
//                                and updated in place
//   route_scan      (one block)  PKG/DC/WC/FISH: the sequential routing
//                                chain, each worker's state in one warp's
//                                registers (SG/FG routes are fixed: no
//                                launch)
//   fifo_workers    (a warp per  the per-worker FIFO; SG/FG gather their
//                    worker)     fixed routes here
//   pane_update     (parallel)   pane (value, count) sums into a compact
//                                open-addressing table, replica matrix,
//                                pane_last
//
// The FIFO runs in float64 relative to the feed's first arrival (the
// reference runs it in float32 because a TPU has no f64; at the paper's
// scale a hot FG worker's sequential float32 busy-time sum drifts ~1.5e-4
// from the host engine's float64 closed form, past the 1e-4 contract).
//
// What bounds it on the card: routing is a dependency chain — tuple i's
// choice reads the counts (or FISH's estimator) that tuple i-1 wrote — so
// route_scan runs it on one warp, m dependent steps.  Tuple i+1 depends on
// tuple i only through the state of the one worker tuple i picked, so on
// every edge of up to 256 workers each worker's argmin key lives in the
// chain warp's registers, a lane owning workers l + 32k: a step is two
// redux.sync minima and the owner's select of its next fold — no shuffle,
// no shared-memory round trip and no __syncwarp on the chain.  The lanes'
// folds of their (key, candidate position) pairs for the next tuple, with
// and without their own pick, and FISH's next wait for a lane's candidate
// (asn + 1, then (bl + asn) * ec, its estimator read from shared memory)
// run while the minima reduce.  A single warp is then bound by its integer
// pipe more than by the chain's latency (tools/chain_probe.py).  What
// depends on the tuple alone is prepared off the chain: the block's other
// warps turn the next tile's candidate rows into per-tuple position words
// packed by lane while warp 0 walks the current one.  Wider edges keep a
// shared-memory walk: per step a read-compare-write of the candidates'
// waits in shared memory, a warp argmin and a __syncwarp.  The FIFO reads
// nothing that routing writes
// except the route, and each worker's recurrence is independent of every
// other's, so fifo_workers runs one warp per worker: bound by its longest
// per-worker run of dependent f64 max + add.  The parallel kernels move a
// few bytes per tuple plus, for FISH's tracker, one decay pass over the
// dense per-key tracker; they are bound by launch latency (and
// tracker_segment by its cluster barriers) at 16k-tuple segments.
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
// tuples are counted with integer atomics per (key, epoch ordinal), then
// each key walks its ordinals in order (decay, add); the per-epoch max is
// an integer atomicMax on non-negative float bits (order-free) and the
// total is carried by one thread.  Integer atomics (counts, pane sums) are
// exact in any order.  Build with -fmad=false so every float expression
// rounds op by op, as in the plain PyTorch version.

#include <cooperative_groups.h>
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
  const float* fv;      // DC/WC/FISH: (m,) each tuple's key's tracker
                        // value at the end of its epoch (tracker_segment)
  const float* tot;     // (ne,) the tracker's total at each epoch's end
  const float* top;     // (ne,) and its maximum
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
  int kreg;             // worker slots a chain lane keeps in registers (4
                        // or 8); 0: the shared-memory walk
  int tile;             // kreg > 0: tuples per staged tile (the wrapper's
                        // plan, sized to the block's shared memory)
};

namespace {

constexpr int kRouteThreads = 256;   // route_scan: the one block
constexpr int kTileInts = 8192;      // route_scan: ints per staged tile
constexpr int kTileMax = 1024;       // route_scan: tuples per staged tile
constexpr int kLaneCands = 4;        // route_scan: candidates a lane keeps
                                     // in registers (128 per warp); the
                                     // select tree below is written for 4
constexpr int kRegGroup = 4;         // route_scan, register chain: tuples
                                     // a staging warp loads at once
constexpr int kRegChunk = 4;         // and 32-candidate chunks of each
constexpr unsigned kRegNone = 0xffffff00u;  // route_scan: not a candidate
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
//
// One search per tuple, in two levels: every 32nd ring point (a splitter)
// is staged in shared memory and binary-searched there; the run of 32
// points after the last splitter <= h is then settled by one coalesced
// 128-byte read and a warp vote (a warp per tuple at width >= 32) or by a
// 5-step search in the run (a thread per tuple below: FG's width 1, PKG's
// 2, DC/WC/FISH on edges of fewer than 32 workers).
// The row is then copied from cands: at width >= 32 by the warp's lanes,
// in 16-byte vectors where width and alignment allow; below, a block
// searches a group of 256 / width tuples into shared memory and then
// writes the group's rows, one int a thread, so the stores coalesce.  The
// kernel is bound by writing the (n_pad, width) rows; the searches are
// dependent loads, hidden by many tuples in flight.
// ---------------------------------------------------------------------------

constexpr int kRingThreads = 256;   // ring_rows: block
constexpr int kRun = 32;            // ring points per splitter (a warp read)
constexpr int kBlocksPerSm = 8;     // ring_rows / pane_update grid cap

// the number of splitters s[j] = pts[32 j] that are <= h
__device__ __forceinline__ int splitter_rank(const unsigned int* s_spl,
                                             int n_spl, unsigned int h) {
  int lo = 0, hi = n_spl;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_spl[mid] <= h) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ unsigned int tuple_hash(
    const unsigned int* __restrict__ hashes, const int* __restrict__ keys,
    int i) {
  return keys ? hashes[keys[i]] : hashes[i];
}

__global__ void __launch_bounds__(kRingThreads)
ring_rows_kernel(const unsigned int* __restrict__ pts, int r_n,
                 const int* __restrict__ cands, int dmax, int width,
                 int vec, const unsigned int* __restrict__ hashes,
                 const int* __restrict__ keys, int n_pad, int m,
                 int* __restrict__ rows) {
  extern __shared__ unsigned int s_spl[];
  const int n_spl = (r_n + kRun - 1) / kRun;
  for (int j = threadIdx.x; j < n_spl; j += kRingThreads) {
    s_spl[j] = pts[j * kRun];
  }
  __syncthreads();
  if (width >= 32) {
    // a warp per tuple: every branch below is uniform across the warp
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (kRingThreads / 32);
    for (int i = blockIdx.x * (kRingThreads / 32) + (threadIdx.x >> 5);
         i < n_pad; i += warps) {
      int* out = rows + (long long)i * width;
      const int* src = nullptr;
      if (i < m) {
        const unsigned int h = tuple_hash(hashes, keys, i);
        const int spl = splitter_rank(s_spl, n_spl, h);
        int ub = 0;  // no point <= h: the ring's first position
        if (spl > 0) {
          const int base = (spl - 1) * kRun;
          const int q = base + lane;
          const bool le = q < r_n && pts[q] <= h;
          ub = base + __popc(__ballot_sync(0xffffffffu, le));
        }
        src = cands + (long long)(ub == r_n ? 0 : ub) * dmax;
      }
      // padding lanes carry key id kcap, one past the hash cache: never
      // read; their rows are -1
      if (vec) {
        int4* o4 = reinterpret_cast<int4*>(out);
        const int4* s4 = reinterpret_cast<const int4*>(src);
        for (int q = lane; q < width / 4; q += 32) {
          o4[q] = src ? __ldg(s4 + q) : make_int4(-1, -1, -1, -1);
        }
      } else {
        for (int j = lane; j < width; j += 32) out[j] = src ? src[j] : -1;
      }
    }
    return;
  }
  // a thread per tuple searches, into shared memory; then the block's
  // threads copy the group's rows, which lie back to back, one int each
  // (thread f writes int f of the group's run: the stores coalesce)
  __shared__ int s_ub[kRingThreads];
  const int tb = kRingThreads / width;  // tuples per group
  const int groups = (n_pad + tb - 1) / tb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int i0 = g * tb;
    if (threadIdx.x < tb) {
      const int i = i0 + threadIdx.x;
      int ub = -1;  // padding rows write -1
      if (i < m) {
        const unsigned int h = tuple_hash(hashes, keys, i);
        const int spl = splitter_rank(s_spl, n_spl, h);
        ub = 0;
        if (spl > 0) {
          // pts[first of the run] <= h: the upper bound lies in the next 32
          int lo = (spl - 1) * kRun + 1;
          int hi = min(lo - 1 + kRun, r_n);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (pts[mid] <= h) lo = mid + 1; else hi = mid;
          }
          ub = lo == r_n ? 0 : lo;
        }
      }
      s_ub[threadIdx.x] = ub;
    }
    __syncthreads();
    const int t = threadIdx.x / width;
    if (t < tb && i0 + t < n_pad) {
      const int j = threadIdx.x - t * width;
      const int u = s_ub[t];
      rows[(long long)(i0 + t) * width + j] =
          u < 0 ? -1 : cands[(long long)u * dmax + j];
    }
    __syncthreads();  // s_ub is rewritten by the next group
  }
}

// ---------------------------------------------------------------------------
// tracker_segment: the segment's tracker update in one launch of one
// thread-block cluster, its work and tables sized by the segment's tuples
// (replaces src/repro/kernels/feed_fused.py:251 _tracker_update)
//
// What route_scan needs is, per tuple, its key's tracker value at the end
// of the tuple's epoch ordinal (fv), and per ordinal the tracker's total and
// maximum; all of it follows from the segment's tuples plus one streaming
// decay pass over the dense tracker (FISH only):
//
//   * a key's value: trk[k], decayed once up front when pre, then per
//     ordinal j: decayed when j > 0, plus its count c_j when c_j != 0 —
//     op by op, in that order (tracker_update_plain's order).  A key the
//     segment does not touch only decays: the dense pass (a fixed point,
//     0 or the smallest subnormals, stays put, so a group of four zeros is
//     skipped);
//   * the maximum is carried exactly: counts are >= 0 and fl(alpha x) is
//     monotone, so max_j = max(fl(alpha max_{j-1}), the touched keys' values
//     at the end of ordinal j), bit for bit the dense max;
//   * the total is carried as T_j = fl(fl(alpha T_{j-1}) + n_j), n_j the
//     ordinal's tuples: the exact sum for DC/WC (alpha = 1, integer
//     counts), within rounding of the dense sum for FISH, where alpha
//     damps the rounding instead of accumulating it.
//
// The cluster is C blocks of 1024 threads: 16 (the non-portable size)
// where the card can place such a cluster, else 8; tracker_plan asks the
// occupancy API once per table size.  What such a cluster is short of
// (tools/cluster_probe.py on an H100): remote shared-memory accesses (one
// per ~3 cycles per SM when every thread makes them, against ~40 cycles a
// local one) and barriers (~1,500 cycles each with 1024-thread blocks).
// So each tuple is counted where it is read, only distinct pairs travel,
// and a key's work stays in one block:
//
//   * block b counts its contiguous share of the tuples in a local table
//     of (key, ordinal) pairs;
//   * the cluster's pair table (>= 2m slots) and key table (>= 2 min(m,
//     kcap1) slots) are split into one region per block; a key's pairs and
//     its slot start in the region of its owner block (a hash of the key),
//     so its walk reads its own shared memory; a probe that runs past a
//     region goes on into the next one.
//
// In the blocks' shared memory when a block's share fits, else in global
// scratch of the same layout (tracker_plan's choice).
//
//   0  block 0 clears top[0, ne).  DC/WC while every value stays below
//      2^24 (the carried max plus m): the tuples' counts go straight into
//      trk by float atomics (integers add exactly in any order), a warp's
//      tuples of one key with one; barrier; each tuple reads its key's new
//      value; the blocks' maxima to top[0]; barrier; the carry; done.
//      Else each block clears its tables; arrive
//   1  the block's tuples counted in its local table (a pair's claimer
//      reads trk[k]); wait; each local pair's count added to its slot in
//      the cluster's pair table (claimed by CAS, which copies trk[k] in);
//      barrier
//   2  each block enters the pairs of its region in the key table (a
//      32-bit mask of the ordinals < 32, the greatest of the rest; the
//      claimer copies trk[k]); barrier; each block lists the keys of its
//      key region, and a warp's 32 listed keys walk the ordinals together,
//      four pair slots read at once — decayed at each ordinal, the count
//      added where the key has one, the pair's end-of-ordinal value kept —
//      while the warps that walk nothing make FISH's dense pass; barrier;
//      each local pair fetches its value, each block writes its keys'
//      final values to trk and takes each ordinal's maximum over its pair
//      region
//   3  the block maxima to top[] (integer atomicMax on non-negative float
//      bits: order-free); arrive (no block leaves while another may still
//      read its shared memory); fv of each tuple from its local pair; wait;
//      block 0 carries the total and the max through the ordinals
//
// What bounds it on the card: the launch and the barriers (five for FISH,
// two for the direct DC/WC path), then a few dependent shared-memory round
// trips per phase (tools/tracker_probe.py --phases); the bytes are 8 a
// tuple and, for FISH, trk read and written once.
// ---------------------------------------------------------------------------

}  // namespace

struct TrkKeySlot {           // 16 bytes
  unsigned int key;           // kTrkEmpty when free
  unsigned int mask;          // ordinals < 32 the key occurs in
  unsigned int hi;            // greatest ordinal >= 32 (0: none)
  float val;                  // trk[k] as found; after the walk, its
                              // final value
};

struct TrkPairSlot {          // 16 bytes
  unsigned long long pair;    // (key << 32) | ordinal; all ones when free
  unsigned int cnt;           // the key's tuples in the ordinal (a local
                              // table, once they travelled: the walk list)
  float val;                  // the cluster's table: trk[k] as found, then
                              // the value at the end of the ordinal; a
                              // local table: the cluster slot's index, then
                              // that value
};

struct TrackerArgs {
  float* trk;            // (kcap1,) in/out
  int kcap1;
  const int* keys;       // (>= m,)
  int m;
  long long g0;
  int epoch;
  int pre;
  int ne;
  float alpha;
  float* carry;          // (2,) in/out: the tracker's total and max
  float* fv;             // (m,) out
  float* tot;            // (ne,) out
  float* top;            // (ne,) out; the touched maxima until phase 3
  TrkKeySlot* gkeys;     // global tables, or null: the blocks' shared
  TrkPairSlot* gpairs;   // memory (tracker_plan's choice)
  TrkPairSlot* glocal;
  int log2c;             // the cluster's blocks (tracker_plan's choice)
  int log2k, log2p;      // the key and pair tables' slots; a block's local
                         // table has as many as its pair region
};

namespace {

constexpr int kTrkThreads = 1024;     // tracker_segment: block
constexpr int kTrkWarps = kTrkThreads / 32;
constexpr int kTrkMaxCluster = 16;    // non-portable cluster size limit
constexpr int kTrkNeLocal = 1024;     // per-ordinal maxima kept per block
constexpr int kTrkBatch = 4;          // pair slots a walk reads at once
                                      // (eight spill past 64 registers)
constexpr int kTrkRounds = 4;         // tuples a thread keeps the local
                                      // slot of in registers (past them:
                                      // in fv until phase 3)
constexpr unsigned int kTrkEmpty = 0xffffffffu;
constexpr unsigned long long kTrkPairEmpty = ~0ull;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// a key's owner block: the top bits of a multiplicative hash
__device__ __forceinline__ unsigned trk_owner(unsigned k, int log2c) {
  return log2c ? (k * 0x9e3779b1u) >> (32 - log2c) : 0u;
}

// a key's slot in its region, and its pairs': the key's mix stepped by
// an odd constant per ordinal, so a key's ordinals never meet each other
__device__ __forceinline__ unsigned trk_key_off(unsigned k) {
  return fmix32(k + 0x165667b1u);
}
__device__ __forceinline__ unsigned trk_mix(unsigned k) {
  return fmix32(k * 0x9e3779b1u + 0x7f4a7c15u);
}
__device__ __forceinline__ unsigned trk_pair_off(unsigned mk, unsigned j) {
  return mk + j * 0x61c88647u;
}

// the cluster barrier in halves: arrive releases this thread's writes
// (its own, remote and global memory) to the cluster, wait acquires the
// others'; work between the two overlaps the barrier
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// slots read after a barrier or another thread's atomics: global tables
// through L2 (another SM's atomics are not in this SM's L1)
template <bool kGlobal>
__device__ __forceinline__ uint4 trk_ld(const TrkPairSlot* q) {
  if (kGlobal) return __ldcg(reinterpret_cast<const uint4*>(q));
  return *reinterpret_cast<const uint4*>(q);
}
template <bool kGlobal>
__device__ __forceinline__ uint4 trk_ld(const TrkKeySlot* q) {
  if (kGlobal) return __ldcg(reinterpret_cast<const uint4*>(q));
  return *reinterpret_cast<const uint4*>(q);
}
template <bool kGlobal>
__device__ __forceinline__ unsigned trk_ld_w(const TrkPairSlot* q) {
  const unsigned* w = reinterpret_cast<const unsigned*>(&q->val);
  if (kGlobal) return __ldcg(w);
  return *w;
}
// a slot's first word, read while other threads may claim it
template <bool kGlobal, class T>
__device__ __forceinline__ T trk_ld_live(const T* q) {
  if (kGlobal) return __ldcg(q);
  return *reinterpret_cast<const volatile T*>(q);
}

__device__ __forceinline__ bool trk_empty(const uint4& v) {
  return v.x == kTrkEmpty && v.y == kTrkEmpty;
}

// x decayed n times by alpha, one multiplication at a time; a fixed point
// (0, alpha = 1, the smallest subnormals) ends it early, since every later
// multiplication would return it unchanged
__device__ __forceinline__ float trk_decay(float x, float alpha, long long n) {
  for (; n > 0; --n) {
    const float y = __fmul_rn(x, alpha);
    if (y == x) break;
    x = y;
  }
  return x;
}

// four keys decayed n times (the same products): up to 64 multiplications
// interleaved, past that as trk_decay
__device__ __forceinline__ float4 trk_decay4(float4 v, float alpha,
                                             long long n) {
  if (n > 64) {
    return make_float4(trk_decay(v.x, alpha, n), trk_decay(v.y, alpha, n),
                       trk_decay(v.z, alpha, n), trk_decay(v.w, alpha, n));
  }
  for (int i = 0; i < (int)n; ++i) {
    v.x = __fmul_rn(v.x, alpha);
    v.y = __fmul_rn(v.y, alpha);
    v.z = __fmul_rn(v.z, alpha);
    v.w = __fmul_rn(v.w, alpha);
  }
  return v;
}

// tuple i's epoch ordinal inside the segment (0 without epochs: DC/WC),
// from r0 = g0 mod epoch: a 32-bit division
__device__ __forceinline__ unsigned trk_ordinal(unsigned r0, int epoch,
                                                int i) {
  return epoch > 0 ? (r0 + (unsigned)i) / (unsigned)epoch : 0u;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kTrkThreads, 1)
tracker_segment_kernel(TrackerArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char trk_smem[];
  __shared__ TrkPairSlot* s_pr[kTrkMaxCluster];  // each block's regions
  __shared__ TrkKeySlot* s_kr[kTrkMaxCluster];
  __shared__ int s_mx[kTrkNeLocal];  // this block's per-ordinal maxima
  __shared__ int s_wn[kTrkWarps + 1];  // per warp: list offsets, maxima

  const int rank = (int)cluster.block_rank();
  const int nblk = 1 << a.log2c;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int log2r = a.log2p - a.log2c;   // a pair region, a local table
  const int log2kr = a.log2k - a.log2c;  // a key region
  const unsigned rmask = (1u << log2r) - 1;
  const unsigned krmask = (1u << log2kr) - 1;
  const unsigned pmask = (1u << a.log2p) - 1;
  const unsigned kmask = (1u << a.log2k) - 1;
  const float alpha = a.alpha;
  const long long nd = a.pre + a.ne - 1;  // an untouched key's decays
  const unsigned r0 = a.epoch > 0 ? (unsigned)(a.g0 % a.epoch) : 0u;
  int* top_bits = reinterpret_cast<int*>(a.top);
  // DC/WC while every value stays below 2^24 (the carried max plus the
  // segment's tuples): integer counts add exactly in any order, so the
  // tuples' counts go straight into trk by float atomics
  const bool direct = a.ne == 1 && alpha == 1.0f && a.pre == 0 &&
                      (double)a.carry[1] + (double)a.m < 16777216.0;
  // this block's tuples: a contiguous share of the segment
  const int per = (a.m + nblk - 1) >> a.log2c;
  const int lo = min(a.m, rank * per);
  const int hi = min(a.m, lo + per);

  TrkPairSlot* my_l;  // the block's local pair table
  TrkPairSlot* my_p;  // its region of the cluster's pair table
  TrkKeySlot* my_k;   // and of the key table
  if (kGlobal) {
    my_l = a.glocal + ((size_t)rank << log2r);
    my_p = a.gpairs + ((size_t)rank << log2r);
    my_k = a.gkeys + ((size_t)rank << log2kr);
  } else {
    my_l = reinterpret_cast<TrkPairSlot*>(trk_smem);
    my_p = my_l + (1 << log2r);
    my_k = reinterpret_cast<TrkKeySlot*>(my_p + (1 << log2r));
  }
  auto pair_at = [&](unsigned s) {
    const unsigned b = s >> log2r;
    return ((int)b == rank ? my_p : s_pr[b]) + (s & rmask);
  };
  auto key_at = [&](unsigned s) {
    const unsigned b = s >> log2kr;
    return ((int)b == rank ? my_k : s_kr[b]) + (s & krmask);
  };
  // where pair (k, j) and key k start probing: the owner's regions
  auto pair_start = [&](unsigned k, unsigned j) {
    return (trk_owner(k, a.log2c) << log2r) |
           (trk_pair_off(trk_mix(k), j) & rmask);
  };
  auto key_start = [&](unsigned k) {
    return (trk_owner(k, a.log2c) << log2kr) | (trk_key_off(k) & krmask);
  };

  // block 0: every block's maxima are in top[]; staged in shared memory,
  // then the total and the max carried through the ordinals by one thread
  auto carry_through = [&]() {
    if (rank == 0) {
      float total = a.carry[0];
      float mx = a.carry[1];
      const long long e0 = a.epoch > 0 ? a.g0 / a.epoch : 0;
      for (int j0 = 0; j0 < a.ne; j0 += kTrkNeLocal) {
        const int n = min(kTrkNeLocal, a.ne - j0);
        __syncthreads();
        for (int j = tid; j < n; j += kTrkThreads) {
          s_mx[j] = __ldcg(top_bits + j0 + j);  // the atomics' maxima, in L2
        }
        __syncthreads();
        if (tid == 0) {
          for (int jj = 0; jj < n; ++jj) {
            const int j = j0 + jj;
            long long jlo = 0, jhi = a.m;
            if (a.epoch > 0) {
              jlo = j == 0 ? 0
                           : min((e0 + j) * a.epoch - a.g0, (long long)a.m);
              jhi = min((e0 + j + 1) * a.epoch - a.g0, (long long)a.m);
            }
            if (j > 0 || a.pre) {
              total = __fmul_rn(alpha, total);
              mx = __fmul_rn(alpha, mx);
            }
            total = __fadd_rn(total, (float)(jhi - jlo));
            mx = fmaxf(mx, __int_as_float(s_mx[jj]));
            a.tot[j] = total;
            a.top[j] = mx;
          }
        }
      }
      if (tid == 0) {
        a.carry[0] = total;
        a.carry[1] = mx;
      }
    }
  };

  // -- phase 0: clear ------------------------------------------------------
  // the thread's first tuples' keys, loading while the tables clear
  unsigned kk[kTrkRounds];
#pragma unroll
  for (int r = 0; r < kTrkRounds; ++r) {
    const int i = lo + r * kTrkThreads + tid;
    kk[r] = i < hi ? (unsigned)__ldg(a.keys + i) : 0u;
  }
  if (direct) {
    // each tuple's count straight into trk[k], a warp's tuples of one key
    // with one atomic; then each tuple reads its key's new value, and the
    // block's maximum goes to top[0]
    if (rank == 0 && tid == 0) a.top[0] = 0.0f;
    auto add_round = [&](int i, unsigned k) {
      const bool live = i < hi;
      const unsigned peers =
          __match_any_sync(0xffffffffu, live ? k : kTrkEmpty);
      if (live && __ffs((int)peers) - 1 == lane) {
        atomicAdd(a.trk + k, (float)__popc(peers));
      }
    };
#pragma unroll
    for (int r = 0; r < kTrkRounds; ++r) {
      const int i0 = lo + r * kTrkThreads;
      if (i0 < hi) add_round(i0 + tid, kk[r]);
    }
    for (int i0 = lo + kTrkRounds * kTrkThreads; i0 < hi;
         i0 += kTrkThreads) {
      const int i = i0 + tid;
      add_round(i, i < hi ? (unsigned)a.keys[i] : 0u);
    }
    cluster_arrive();
    cluster_wait();
    int bmax = 0;  // >= 0: int order is float order
#pragma unroll
    for (int r = 0; r < kTrkRounds; ++r) {
      const int i = lo + r * kTrkThreads + tid;
      if (i < hi) {
        const float x = __ldcg(a.trk + kk[r]);
        a.fv[i] = x;
        bmax = max(bmax, __float_as_int(x));
      }
    }
    for (int i = lo + kTrkRounds * kTrkThreads + tid; i < hi;
         i += kTrkThreads) {
      const float x = __ldcg(a.trk + a.keys[i]);
      a.fv[i] = x;
      bmax = max(bmax, __float_as_int(x));
    }
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if (lane == 0) s_wn[tid >> 5] = bmax;
    __syncthreads();
    if (tid < 32) {
      const int b = __reduce_max_sync(0xffffffffu,
                                      lane < kTrkWarps ? s_wn[lane] : 0);
      if (lane == 0 && b) atomicMax(top_bits, b);
    }
    cluster_arrive();
    cluster_wait();
    carry_through();
    return;
  }
  if (tid < nblk) {
    if (kGlobal) {
      s_pr[tid] = a.gpairs + ((size_t)tid << log2r);
      s_kr[tid] = a.gkeys + ((size_t)tid << log2kr);
    } else {
      s_pr[tid] = cluster.map_shared_rank(my_p, tid);
      s_kr[tid] = cluster.map_shared_rank(my_k, tid);
    }
  }
  // a pair slot (pair empty; cnt and val 0), a key slot (key empty; mask,
  // hi and val 0)
  uint4* lw = reinterpret_cast<uint4*>(my_l);
  uint4* pw = reinterpret_cast<uint4*>(my_p);
  for (int s = tid; s <= (int)rmask; s += kTrkThreads) {
    lw[s] = make_uint4(kTrkEmpty, kTrkEmpty, 0u, 0u);
    pw[s] = make_uint4(kTrkEmpty, kTrkEmpty, 0u, 0u);
  }
  uint4* kw = reinterpret_cast<uint4*>(my_k);
  for (int s = tid; s <= (int)krmask; s += kTrkThreads) {
    kw[s] = make_uint4(kTrkEmpty, 0u, 0u, 0u);
  }
  for (int j = tid; j < kTrkNeLocal; j += kTrkThreads) s_mx[j] = 0;
  if (rank == 0) {
    for (int j = tid; j < a.ne; j += kTrkThreads) a.top[j] = 0.0f;
  }
  __syncthreads();
  cluster_arrive();

  // -- phase 1: the block's tuples counted locally -------------------------
  // tuple i of key k counted in the block's local table, its slot
  // returned; a pair's claimer reads trk[k] for the push.  One atomic a
  // tuple (the card serves many on one shared-memory address about as fast
  // as on many: tools/cluster_probe.py); the table holds at most about
  // half its slots, so every probe ends
  auto count_one = [&](int i, unsigned k) {
    const unsigned j = trk_ordinal(r0, a.epoch, i);
    const unsigned long long p = ((unsigned long long)k << 32) | j;
    unsigned s = trk_pair_off(trk_mix(k), j) & rmask;
    TrkPairSlot* q = my_l + s;
    bool claimed = false;
    for (unsigned n = 0; n <= rmask; ++n) {
      q = my_l + s;
      unsigned long long cur = trk_ld_live<kGlobal>(&q->pair);
      if (cur == kTrkPairEmpty) {
        cur = atomicCAS(&q->pair, kTrkPairEmpty, p);
        claimed = cur == kTrkPairEmpty;
      }
      if (cur == kTrkPairEmpty || cur == p) break;
      s = (s + 1) & rmask;
    }
    atomicAdd(&q->cnt, 1u);
    if (claimed) q->val = a.trk[k];
    return s;
  };
  unsigned ls[kTrkRounds];
#pragma unroll
  for (int r = 0; r < kTrkRounds; ++r) {
    const int i = lo + r * kTrkThreads + tid;
    if (i < hi) ls[r] = count_one(i, kk[r]);
  }
  for (int i = lo + kTrkRounds * kTrkThreads + tid; i < hi;
       i += kTrkThreads) {
    reinterpret_cast<unsigned*>(a.fv)[i] = count_one(i, (unsigned)a.keys[i]);
  }
  __syncthreads();
  cluster_wait();

  // each local pair's count added to the cluster's pair table (a pair's
  // claimer copies in trk[k], which the local pair's claimer read), two at
  // a time; its slot kept in the local pair
  for (int s0 = tid; s0 <= (int)rmask; s0 += 2 * kTrkThreads) {
    uint4 v[2];
    float orig[2];
    unsigned gs[2];
    unsigned long long p[2], cur[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u * kTrkThreads;
      v[u] = s <= (int)rmask ? trk_ld<kGlobal>(my_l + s)
                             : make_uint4(kTrkEmpty, kTrkEmpty, 0u, 0u);
      const bool live = !trk_empty(v[u]);
      orig[u] = __uint_as_float(v[u].w);
      gs[u] = pair_start(v[u].y, v[u].x);
      p[u] = ((unsigned long long)v[u].y << 32) | v[u].x;
      cur[u] = live ? atomicCAS(&pair_at(gs[u])->pair, kTrkPairEmpty, p[u])
                    : kTrkPairEmpty;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (trk_empty(v[u])) continue;
      for (unsigned n = 0; n <= pmask && cur[u] != kTrkPairEmpty &&
                           cur[u] != p[u]; ++n) {
        gs[u] = (gs[u] + 1) & pmask;
        cur[u] = atomicCAS(&pair_at(gs[u])->pair, kTrkPairEmpty, p[u]);
      }
      TrkPairSlot* g = pair_at(gs[u]);
      atomicAdd(&g->cnt, v[u].z);
      if (cur[u] == kTrkPairEmpty) g->val = orig[u];
      *reinterpret_cast<unsigned*>(&my_l[s0 + u * kTrkThreads].val) = gs[u];
    }
  }
  cluster_arrive();
  cluster_wait();

  // -- phase 2: the key table; the walks --------------------------------------------------
  // FISH: every key of trk decays nd times, now that every pair holds its
  // key's value (a touched key's final value replaces this one after the
  // next barrier): each block its slice, over its threads from warp w0 on;
  // whole 16-byte groups where trk is so aligned, two at a time, a group
  // of zeros left as it is
  auto dense_pass = [&](int w0) {
    if (alpha == 1.0f || nd <= 0 || tid < 32 * w0) return;
    const int bt = kTrkThreads - 32 * w0;  // the threads taking part
    const int t0 = tid - 32 * w0;
    const bool vec =
        (reinterpret_cast<unsigned long long>(a.trk) & 15) == 0;
    const int groups = vec ? a.kcap1 / 4 : 0;
    const int gper = (groups + nblk - 1) >> a.log2c;
    const int g_lo = min(groups, rank * gper);
    const int g_hi = min(groups, g_lo + gper);
    float4* t4 = reinterpret_cast<float4*>(a.trk);
    for (int g0 = g_lo + t0; g0 < g_hi; g0 += 2 * bt) {
      float4 v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        v[u] = g0 + u * bt < g_hi ? t4[g0 + u * bt]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (v[u].x != 0.0f || v[u].y != 0.0f || v[u].z != 0.0f ||
            v[u].w != 0.0f) {
          t4[g0 + u * bt] = trk_decay4(v[u], alpha, nd);
        }
      }
    }
    // the keys past the groups, sliced the same way
    const int rest = a.kcap1 - 4 * groups;
    const int rper = (rest + nblk - 1) >> a.log2c;
    const int r_hi = min(rest, rank * rper + rper);
    for (int q = rank * rper + t0; q < r_hi; q += bt) {
      a.trk[4 * groups + q] = trk_decay(a.trk[4 * groups + q], alpha, nd);
    }
  };
  // the pairs of the block's pair region entered in the key table: a
  // 32-bit mask of the ordinals < 32, the greatest of the rest
  for (int s = tid; s <= (int)rmask; s += kTrkThreads) {
    const uint4 v = trk_ld<kGlobal>(my_p + s);
    if (trk_empty(v)) continue;
    const unsigned k = v.y, j = v.x;
    unsigned t = key_start(k);
    TrkKeySlot* ks = key_at(t);
    for (unsigned n = 0; n <= kmask; ++n) {
      ks = key_at(t);
      unsigned cur = trk_ld_live<kGlobal>(&ks->key);
      if (cur == kTrkEmpty) {
        cur = atomicCAS(&ks->key, kTrkEmpty, k);
        if (cur == kTrkEmpty) ks->val = __uint_as_float(v.w);
      }
      if (cur == kTrkEmpty || cur == k) break;
      t = (t + 1) & kmask;
    }
    if (j < 32u) {
      atomicOr(&ks->mask, 1u << j);
    } else {
      atomicMax(&ks->hi, j);
    }
  }
  cluster_arrive();
  cluster_wait();
  // the key region's keys listed in slot order (in the local table's
  // counts, free since they travelled; a key region has no more slots
  // than a local table): each thread's run of slots counted, the counts
  // scanned over the block
  const int run = (int)(krmask / kTrkThreads) + 1;
  const int r0s = tid * run;
  int mine = 0;
  for (int u = 0; u < run; ++u) {
    const int s = r0s + u;
    mine += s <= (int)krmask && trk_ld<kGlobal>(my_k + s).x != kTrkEmpty;
  }
  int x = mine;  // the warp's inclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_wn[tid >> 5] = x;
  __syncthreads();
  if (tid < 32) {  // the warps' totals scanned
    const int n = lane < kTrkWarps ? s_wn[lane] : 0;
    int y = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    if (lane < kTrkWarps) s_wn[lane] = y - n;
    if (lane == 31) s_wn[kTrkWarps] = y;
  }
  __syncthreads();
  int at = s_wn[tid >> 5] + x - mine;
  for (int u = 0; u < run; ++u) {
    const int s = r0s + u;
    if (s <= (int)krmask && trk_ld<kGlobal>(my_k + s).x != kTrkEmpty) {
      my_l[at++].cnt = (unsigned)s;
    }
  }
  const int listed = s_wn[kTrkWarps];
  __syncthreads();
  // the key slot of list entry w
  auto t_of = [&](int w) -> unsigned {
    if constexpr (kGlobal) {
      return __ldcg(&my_l[w].cnt);
    } else {
      return my_l[w].cnt;
    }
  };
  // a warp's 32 listed keys walked through the ordinals together, four
  // at a time: the pairs' slots read at once (a pair not in its first
  // slot probed on), then each key decayed at every ordinal (one
  // multiplication, as the dense loop), its pair's count added where it
  // has one, the pair's end-of-ordinal value kept; the key's final value
  // kept in its slot.  The warps that walk nothing make the dense pass
  // meanwhile
  for (int w0 = tid - lane; w0 < listed; w0 += kTrkThreads) {
    const int w = w0 + lane;
    const bool live = w < listed;
    const uint4 kv = live ? trk_ld<kGlobal>(my_k + t_of(w))
                          : make_uint4(kTrkEmpty, 0u, 0u, 0u);
    const unsigned k = kv.x;
    float acc = __uint_as_float(kv.w);
    if (a.pre && alpha != 1.0f) acc = __fmul_rn(acc, alpha);
    const unsigned mk = trk_mix(k);
    const unsigned base = trk_owner(k, a.log2c) << log2r;
    for (unsigned j0 = 0; j0 < (unsigned)a.ne; j0 += kTrkBatch) {
      bool has[kTrkBatch];
      unsigned sl[kTrkBatch];
      uint4 pv[kTrkBatch];
#pragma unroll
      for (int u = 0; u < kTrkBatch; ++u) {
        const unsigned j = j0 + u;
        has[u] = live && j < (unsigned)a.ne &&
                 (j < 32u ? (kv.y >> j) & 1u : j <= kv.z);
        sl[u] = base | (trk_pair_off(mk, j) & rmask);
        pv[u] = has[u] ? trk_ld<kGlobal>(pair_at(sl[u]))
                       : make_uint4(kTrkEmpty, kTrkEmpty, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kTrkBatch; ++u) {
        const unsigned j = j0 + u;
        if (j >= (unsigned)a.ne) break;
        if (j > 0 && alpha != 1.0f) acc = __fmul_rn(acc, alpha);
        for (unsigned n = 0; n <= pmask && has[u] &&
                             !(pv[u].x == j && pv[u].y == k); ++n) {
          if (trk_empty(pv[u])) {
            has[u] = false;  // an ordinal >= 32 the key skips
          } else {
            sl[u] = (sl[u] + 1) & pmask;
            pv[u] = trk_ld<kGlobal>(pair_at(sl[u]));
          }
        }
        if (has[u]) {
          acc = __fadd_rn(acc, (float)pv[u].z);
          pair_at(sl[u])->val = acc;
        }
      }
    }
    if (live) my_k[t_of(w)].val = acc;
  }
  const int walking = (listed + 31) >> 5;  // the warps that walk
  dense_pass(walking < kTrkWarps ? walking : 0);
  cluster_arrive();
  cluster_wait();
  // each local pair's end-of-ordinal value fetched from its slot
  for (int s = tid; s <= (int)rmask; s += kTrkThreads) {
    TrkPairSlot* q = my_l + s;
    const uint4 v = trk_ld<kGlobal>(q);
    if (trk_empty(v)) continue;
    *reinterpret_cast<unsigned*>(&q->val) =
        trk_ld_w<kGlobal>(pair_at(v.w));
  }
  // the key region's final values to trk, after every dense write
  for (int s = tid; s <= (int)krmask; s += kTrkThreads) {
    const uint4 kv = trk_ld<kGlobal>(my_k + s);
    if (kv.x != kTrkEmpty) a.trk[kv.x] = __uint_as_float(kv.w);
  }
  // each ordinal's maximum over the values the region's pairs end it
  // with (a pair's walker may be another block's: after the barrier)
  for (int s = tid; s <= (int)rmask; s += kTrkThreads) {
    const uint4 v = trk_ld<kGlobal>(my_p + s);
    if (trk_empty(v)) continue;
    if (v.x < (unsigned)kTrkNeLocal) {
      if ((int)v.w > s_mx[v.x]) atomicMax(s_mx + v.x, (int)v.w);
    } else {
      atomicMax(top_bits + v.x, (int)v.w);
    }
  }
  __syncthreads();
  const int nloc = a.ne < kTrkNeLocal ? a.ne : kTrkNeLocal;
  for (int j = tid; j < nloc; j += kTrkThreads) {
    if (s_mx[j]) atomicMax(top_bits + j, s_mx[j]);
  }

  // -- phase 3: fv; the carry ----------------------------------------------
  cluster_arrive();  // (no block leaves while another may still read its
  __syncthreads();   // shared memory)
#pragma unroll
  for (int r = 0; r < kTrkRounds; ++r) {
    const int i = lo + r * kTrkThreads + tid;
    if (i < hi) a.fv[i] = __uint_as_float(trk_ld_w<kGlobal>(my_l + ls[r]));
  }
  for (int i = lo + kTrkRounds * kTrkThreads + tid; i < hi;
       i += kTrkThreads) {
    const unsigned s = reinterpret_cast<const unsigned*>(a.fv)[i];
    a.fv[i] = __uint_as_float(trk_ld_w<kGlobal>(my_l + s));
  }
  cluster_wait();
  carry_through();
}

// tracker_segment's kernel and launch for tables in global scratch (or in
// the blocks' shared memory) on 2^log2c blocks
using TrkKernel = void (*)(TrackerArgs);

TrkKernel trk_kernel(bool global) {
  return global ? tracker_segment_kernel<true>
                : tracker_segment_kernel<false>;
}

// a block's dynamic shared memory: its local pair table, its pair region
// and its key region
size_t trk_smem_bytes(bool global, int log2c, int log2k, int log2p) {
  return global ? 0
                : 2 * (sizeof(TrkPairSlot) << (log2p - log2c)) +
                      (sizeof(TrkKeySlot) << (log2k - log2c));
}

cudaError_t trk_config(bool global, int log2c, int log2k, int log2p,
                       cudaStream_t stream, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  const TrkKernel kernel = trk_kernel(global);
  const size_t smem = trk_smem_bytes(global, log2c, log2k, log2p);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if ((1 << log2c) > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(1u << log2c, 1, 1);
  cfg->blockDim = dim3(kTrkThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log2c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// route_scan: one block; a parallel prologue, then the routing chain on
// warp 0 while the other warps stage the next tile of candidates.  Two
// chains, chosen by the wrapper from the edge's worker count alone:
//
//   * the register chain (K > 0: w1 - 1 <= 256 workers, every cluster of
//     the paper).  Lane l of warp 0 owns workers l + 32k, k < K, and keeps
//     each one's argmin key in registers: a count's, which is its record
//     too, or FISH's wait's (FISH's estimator and counts stay in shared
//     memory: the counts are summed from the routes at the end).  The
//     staging warps turn each tuple's candidate row into position words
//     packed by lane: word k of lane l holds worker l + 32k's position in
//     the row, or none.  A step is two redux.sync minima (the key, then
//     the position among the lanes that hold it) and the owner's select;
//     the next tuple's lane-local folds run while they reduce (RegChain);
//   * the shared-memory walk (K = 0, wider edges): a lane keeps candidates
//     by position, and every operand of a step is read from shared memory.
//
// Every tie goes to the lower candidate position, which is each scheme's
// rule: PKG's <=, the light path's "c0 unless c1 is strictly less", DC's
// and FISH's argmin; a WC hot key's position is the worker's id.
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
  // -0 and +0 compare equal as floats: fold -0 onto +0 first; then a
  // negative's bits all flip, a positive's sign bit (two integer ops)
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
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

// the register chain's position table: per tuple, lane l's K words, word
// k = (j << 8) | w for worker w = l + 32k at position j < 2^23 of the
// tuple's candidate row (the worker rides along, below the position), or
// kRegNone where the worker is not a candidate: its sign bit set, its
// worker bits 0, a worker any lane may read
template <int K>
struct RegWords {
  uint4 q[K / 4];
  __device__ __forceinline__ unsigned at(int k) const {
    const uint4& v = q[k / 4];
    const int c = k & 3;
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
  }
};

// tile t's position words and d values -> pos and s_d (one buffer), by
// staging warp sw of nsw.  A warp takes kRegGroup tuples at a time: their
// d, then their first 32 kRegChunk candidates, all loads in flight
// together; it marks every slot of those tuples "not a candidate", then
// writes each candidate's word, j < min(d, width), into its worker's
// slot.  A tuple is one warp's, its marks ordered before its positions by
// __syncwarp, so the staging warps need no barrier among themselves.  A
// row holds distinct workers below w1 - 1 (ring_rows: the first distinct
// owners on the ring); a WC hot key (d < 0) reads no row
template <int K>
__device__ __forceinline__ void stage_positions(const RouteArgs& a, int t,
                                                RegWords<K>* pos, int* s_d,
                                                int sw, int nsw, int lane) {
  const int i0 = t * a.tile;
  const int tn = min(a.tile, a.m - i0);
  for (int g = sw * kRegGroup; g < tn; g += nsw * kRegGroup) {
    int d[kRegGroup], dd[kRegGroup];
    int x[kRegGroup][kRegChunk];
#pragma unroll
    for (int u = 0; u < kRegGroup; ++u) {
      d[u] = g + u < tn ? a.dbuf[i0 + g + u] : 0;
      dd[u] = d[u] > 0 ? min(d[u], a.width) : 0;
    }
#pragma unroll
    for (int u = 0; u < kRegGroup; ++u) {
      const int* r = a.rows + (long long)(i0 + g + u) * a.width;
#pragma unroll
      for (int q = 0; q < kRegChunk; ++q) {
        const int j = lane + 32 * q;
        x[u][q] = j < dd[u] ? r[j] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kRegGroup; ++u) {
      if (g + u < tn) {
#pragma unroll
        for (int h = 0; h < K / 4; ++h) {
          pos[(g + u) * 32 + lane].q[h] =
              make_uint4(kRegNone, kRegNone, kRegNone, kRegNone);
        }
        if (lane == 0) s_d[g + u] = d[u];
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRegGroup; ++u) {
      unsigned* p = reinterpret_cast<unsigned*>(pos + (g + u) * 32);
      auto put = [&](int w, int j) {
        if (w >= 0 && w < 32 * K) {
          p[(w & 31) * K + (w >> 5)] = ((unsigned)j << 8) | (unsigned)w;
        }
      };
#pragma unroll
      for (int q = 0; q < kRegChunk; ++q) put(x[u][q], lane + 32 * q);
      const int* r = a.rows + (long long)(i0 + g + u) * a.width;
      for (int j = lane + 32 * kRegChunk; j < dd[u]; j += 32) put(r[j], j);
    }
  }
}

// the register chain's state on lane l of warp 0: slot k < K holds worker
// l + 32k (nw workers; a slot past them never takes part).  One warp is
// bound by its integer pipe (half a warp instruction a cycle), so a step
// keeps that pipe's work small: position words as the staging warps wrote
// them, the worker riding in their low bits (the second minimum names the
// pick to every lane, and a fold is a plain 64-bit min); FISH's estimator
// and each worker's next key in shared memory, read for the one slot that
// may be picked while the minima reduce
template <int SCH, int K>
struct RegChain {
  unsigned key[K];   // the argmin key: FISH's float_key(wait), else
                     // int_key(count), which is the count's record too
  bool live[K];      // WC: the worker is live
  int lane, nw;
  // per slot of the next tuple: the pair's high word (key & keep) | over,
  // its low word lo; a slot whose worker is not a candidate reads all ones
  // high, and never wins
  unsigned keep[K], over[K], lo[K];
  unsigned long long best;  // this lane's least pair of the tuple at hand

  // s_nkey: FISH, per worker the key its next pick gives (each lane
  // writes and reads its own workers' alone)
  __device__ __forceinline__ void load(const int* s_counts, const int* s_act,
                                       const float* s_bl, const float* s_asn,
                                       const float* s_ec, unsigned* s_nkey,
                                       int ln, int n) {
    lane = ln;
    nw = n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k < nw ? lane + 32 * k : 0;
      live[k] = s_act[w] != 0;
      if (SCH == FISH) {
        key[k] = float_key((s_bl[w] + s_asn[w]) * s_ec[w]);
        if (lane + 32 * k < nw) {
          s_nkey[w] = float_key((s_bl[w] + (s_asn[w] + 1.0f)) * s_ec[w]);
        }
      } else {
        key[k] = int_key(s_counts[w]);
      }
    }
  }

  // the int schemes' counts from their keys; FISH's come from the routes
  // afterwards (route_scan_kernel), its assigned are in shared memory
  __device__ __forceinline__ void store(int* s_counts) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      if (SCH != FISH && w < nw) s_counts[w] = (int)(key[k] ^ 0x80000000u);
    }
  }

  // the next tuple's masks, from its d and its position words
  __device__ __forceinline__ void tuple(const RegWords<K>& pv, int d) {
    if (SCH == WC && d < 0) {
      // WC hot key: every worker at its id, a dead one at kBigI32's key
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int w = lane + 32 * k;
        const bool in = w < nw;
        keep[k] = in && live[k] ? ~0u : 0u;
        over[k] = !in ? ~0u : (live[k] ? 0u : int_key(kBigI32));
        lo[k] = in ? ((unsigned)w << 8) | (unsigned)w : kRegNone;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lo[k] = pv.at(k);
      keep[k] = ~0u;
      over[k] = (unsigned)((int)lo[k] >> 31);  // all ones: not a candidate
    }
  }

  // the lane's least (high, low) pair over keys ky (a row's positions
  // differ: no two tie)
  __device__ __forceinline__ unsigned long long fold(
      const unsigned (&ky)[K]) const {
    unsigned long long v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = ((unsigned long long)((ky[k] & keep[k]) | over[k]) << 32) | lo[k];
    }
#pragma unroll
    for (int s = 1; s < K; s <<= 1) {
#pragma unroll
      for (int k = 0; k + s < K; k += 2 * s) {
        v[k] = v[k + s] < v[k] ? v[k + s] : v[k];
      }
    }
    return v[0];
  }

  __device__ __forceinline__ void first(const RegWords<K>& pv, int d) {
    tuple(pv, d);
    best = fold(key);
  }

  // one step of the chain: the warp's argmin of the tuple at hand — the
  // least key, then the least position among the lanes that hold it (two
  // redux.sync; the worker rides below the position) — then the owner's
  // update, a few selects.  Everything else
  // is off the chain, done while the minima reduce: the next tuple (npv,
  // nd) folded as things stand, then as they stand if this lane's best
  // slot is picked; for FISH that slot's estimator and next key read and
  // the key its pick after this one would give.  Every tuple has a
  // candidate (d >= 1, a row's first entry a worker).  Returns the worker
  // picked, on every lane
  __device__ __forceinline__ int step(const RegWords<K>& npv, int nd,
                                      const float* s_bl, float* s_asn,
                                      const float* s_ec, unsigned* s_nkey) {
    const unsigned bhi = (unsigned)(best >> 32);
    const unsigned blo = (unsigned)best;
    const unsigned klo = __reduce_min_sync(0xffffffffu, bhi);
    const int wb = (int)(blo & 0xffu);  // the lane's best worker
    const unsigned bk32 = blo & 0xe0u;  // and its slot, times 32
    float bl = 0.0f, a1 = 0.0f, ec = 0.0f;
    unsigned nk = 0u;
    if (SCH == FISH) {
      nk = s_nkey[wb];
      bl = s_bl[wb];
      a1 = s_asn[wb] + 1.0f;
      ec = s_ec[wb];
    }
    tuple(npv, nd);
    const unsigned long long f_same = fold(key);
    const unsigned cand = bhi == klo ? blo : 0xffffffffu;
    const unsigned jw = __reduce_min_sync(0xffffffffu, cand);
    unsigned kb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      kb[k] = bk32 == 32u * k ? (SCH == FISH ? nk : key[k] + 1u) : key[k];
    }
    const unsigned long long f_pick = fold(kb);
    const unsigned nn =
        SCH == FISH ? float_key((bl + (a1 + 1.0f)) * ec) : 0u;
    // positions differ, so the lane holding the least one owns the pick
    const bool own = cand == jw;
    best = own ? f_pick : f_same;
#pragma unroll
    for (int k = 0; k < K; ++k) key[k] = own ? kb[k] : key[k];
    if (SCH == FISH && own) {
      s_asn[wb] = a1;
      s_nkey[wb] = nn;
    }
    return (int)(jw & 0xffu);
  }
};

// K: the register chain's worker slots a lane keeps (4 or 8); 0: the
// shared-memory walk.  One block a launch: all of the SM's registers
template <int SCH, int K>
__global__ void __launch_bounds__(kRouteThreads, 1)
route_scan_kernel(RouteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w1 = a.w1;
  const int tile = K > 0 ? a.tile : route_tile(a.width);
  // the staged tiles first (16-byte aligned for the vector copies): 2 x
  // tile x width candidates (the walk), or 2 x tile tuples' position words
  // and two more, which the chain's read two tuples ahead may reach
  int* s_rows = reinterpret_cast<int*>(smem);
  const long long per = K > 0 ? 32 * 4 * K : 4LL * a.width;
  int* s_d = reinterpret_cast<int*>(smem + (2 * tile + (K > 0 ? 2 : 0)) *
                                               per);  // 2 x tile
  // the register chain's routes, 2 x tile (the walk has none)
  int* s_route = s_d + 2 * tile;
  int* s_counts = s_route + (K > 0 ? 2 * tile : 0);
  int* s_act = s_counts + w1;                    // WC: live lanes
  float* s_bl = reinterpret_cast<float*>(s_act + w1);
  float* s_asn = s_bl + w1;
  float* s_ec = s_asn + w1;
  float* s_wait = s_ec + w1;        // FISH: (bl + asn) * ec per worker
  float* s_tot = s_wait + w1;       // per-epoch tracker total
  float* s_ftop = s_tot + a.ne;     // per-epoch max / total

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
    // per epoch: the tracker's total and max / total, as tracker_segment
    // carried them
    for (int j = tid; j < a.ne; j += kRouteThreads) {
      const float total = a.tot[j];
      s_tot[j] = total;
      s_ftop[j] = total > 0.0f ? a.top[j] / total : 0.0f;
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
    for (int i = lo + tid; i < hi; i += kRouteThreads) {
      if (sch == PKG) {
        a.dbuf[i] = 2;
      } else if (sch == DC || sch == WC) {
        const float f = total > 0.0f ? a.fv[i] / total : 0.0f;
        const bool hot = f > a.theta;
        float dh = ceilf(f * a.wnum / sqrtf(a.theta));
        dh = fminf(fmaxf(dh, 2.0f), a.wnum);
        // WC hot keys take the argmin over the whole live set (d = -1)
        a.dbuf[i] = hot ? (sch == WC ? -1 : (int)dh) : 2;
      } else {  // FISH
        const float f = total > 0.0f ? a.fv[i] / total : 0.0f;
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

  // the chain on warp 0; warps 1.. stage tile t+1 while warp 0 walks
  // tile t
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ntiles = (a.m + tile - 1) / tile;
  if constexpr (K > 0) {
    RegWords<K>* s_pos = reinterpret_cast<RegWords<K>*>(smem);  // 2 x tile
                                                                 // x 32 lanes
    // the staging warps: all but warp 0 and warp 4, which shares warp 0's
    // scheduler and integer pipe (a warp's scheduler is its id mod 4)
    constexpr int nsw = kRouteThreads / 32 - 2;
    const bool stages = warp % 4 != 0;
    const int sw = warp - 1 - (warp > 4);
    // worker w1 - 1 pads the lanes: it is on no ring row and never live,
    // so no tuple picks it and it stays in shared memory, untouched
    const int nw = w1 - 1;
    if (stages && ntiles > 0) {
      stage_positions<K>(a, 0, s_pos, s_d, sw, nsw, lane);
    }
    // FISH's next keys in s_wait, which the chain does not read
    unsigned* s_nkey = reinterpret_cast<unsigned*>(s_wait);
    RegChain<SCH, K> ch;
    if (warp == 0) {
      ch.load(s_counts, s_act, s_bl, s_asn, s_ec, s_nkey, lane, nw);
    }
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
      const int buf = t & 1;
      if (warp == 0) {
        const int i0 = t * tile;
        const int tn = min(tile, a.m - i0);
        const RegWords<K>* pb = s_pos + (long long)buf * tile * 32;
        const int* db = s_d + buf * tile;
        int* route = s_route + buf * tile;
        ch.first(pb[lane], db[0]);
        // a step folds the next tuple: its positions and d were read a
        // step earlier, off the chain (past the tile's end they are read
        // from the rest of the block's shared memory, and not used)
        RegWords<K> pv = pb[32 + lane];
        int d = db[1];
        for (int ti = 0; ti < tn; ++ti) {
          const RegWords<K> npv = pb[(ti + 2) * 32 + lane];
          const int nd = db[ti + 2];
          const int w = ch.step(pv, d, s_bl, s_asn, s_ec, s_nkey);
          if (lane == 0) route[ti] = w;
          pv = npv;
          d = nd;
        }
      } else if (stages) {
        // the last tile's routes out, then the next tile in
        const int* rb = s_route + (buf ^ 1) * tile;
        for (int i = (t - 1) * tile + sw * 32 + lane; t > 0 && i < t * tile;
             i += nsw * 32) {
          a.workers[i] = rb[i - (t - 1) * tile];
        }
        if (t + 1 < ntiles) {
          stage_positions<K>(a, t + 1,
                             s_pos + (long long)(buf ^ 1) * tile * 32,
                             s_d + (buf ^ 1) * tile, sw, nsw, lane);
        }
      }
      __syncthreads();
    }
    if (warp == 0) ch.store(s_counts);
    if (ntiles > 0) {
      const int t = ntiles - 1;
      const int* rb = s_route + (t & 1) * tile;
      for (int i = t * tile + tid; i < a.m; i += kRouteThreads) {
        a.workers[i] = rb[i - t * tile];
      }
    }
    __syncthreads();
    if (sch == FISH) {
      // each worker's count raised by its routes, a warp's tuples of one
      // worker with one atomic (integer sums: any order is exact)
      for (int i0 = tid - lane; i0 < a.m; i0 += kRouteThreads) {
        const int i = i0 + lane;
        const int w = i < a.m ? a.workers[i] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        if (w >= 0 && __ffs((int)peers) - 1 == lane) {
          atomicAdd(s_counts + w, __popc(peers));
        }
      }
      __syncthreads();
    }
  } else {
    // the shared-memory walk: every operand of a step in shared memory
    const int ptid = tid - 32;
    const int nprod = kRouteThreads - 32;
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
// pane_update: the routed segment folded into a compact pane table
//
// The open pane is an open-addressing table of C slots (a power of two the
// runner keeps >= 2 x the pane's tuples, so the load stays <= 1/2): a slot
// holds a 64-bit pair key (worker << 32) | key, or kEmptySlot, and int32
// value and count sums in two planes.  At path A's 65,536-tuple panes that
// is 2 MB, resident in L2, against the 203 MB of a dense (workers x key
// capacity) table; a reset clears C slots.  Lanes of a warp that hold the
// same pair find each other (__match_any_sync), sum in the warp, and only
// the group's lowest lane inserts: a CAS on the slot key with linear
// probing, then two int32 atomicAdds.  pane_last is kept per block in
// shared memory (one global atomicMax per (block, worker) seen).  Integer
// atomics make every sum exact in any order; the slot a pair lands in may
// differ from run to run, so readers take the table in canonical form
// (occupied slots sorted by pair key).  The kernel is bound by reading the
// segment's tuples; the table's atomics resolve in L2.
// ---------------------------------------------------------------------------

constexpr int kPaneThreads = 256;
constexpr unsigned long long kEmptySlot = ~0ull;
enum PaneMode { kPaneNone = 0, kPaneTuples = 1, kPaneWeighted = 2 };

// the slot of pair p, claimed by CAS if the pair is new to the table; -1
// when all C slots hold other pairs.  Only a caller past the load bound
// gets there: the pair is dropped, and the table, now full, is refused by
// every reader (the canonical form checks the load)
__device__ __forceinline__ long long pane_slot(
    unsigned long long* slot_keys, int log2c, unsigned long long p) {
  const unsigned long long mask = (1ull << log2c) - 1;
  unsigned long long s = (p * 0x9E3779B97F4A7C15ull) >> (64 - log2c);
  for (unsigned long long probes = 0; probes <= mask; ++probes) {
    // a slot's key goes from empty to its pair once and never changes
    // again, so a stale read can only say "empty" and fall to the CAS
    unsigned long long cur = __ldcg(slot_keys + s);
    if (cur == kEmptySlot) cur = atomicCAS(slot_keys + s, kEmptySlot, p);
    if (cur == kEmptySlot || cur == p) return (long long)s;
    s = (s + 1) & mask;
  }
  return -1;
}

__global__ void __launch_bounds__(kPaneThreads)
pane_update_kernel(int mode, const int* __restrict__ keys,
                   const int* __restrict__ workers,
                   const unsigned long long* __restrict__ pairs,
                   const int* __restrict__ vals, const int* __restrict__ cnts,
                   int n, int w1, int seg_base, int log2c,
                   unsigned long long* __restrict__ slot_keys,
                   int* __restrict__ slot_val, int* __restrict__ slot_cnt,
                   int* __restrict__ pane_last,
                   unsigned char* __restrict__ repl) {
  extern __shared__ int s_last[];  // tuple mode: (w1,) block maxima
  const bool tuples = mode == kPaneTuples;
  if (tuples) {
    for (int w = threadIdx.x; w < w1; w += kPaneThreads) s_last[w] = -1;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kPaneThreads;
  // whole warps walk 32-tuple strides, lanes past n present for the votes
  for (int base = blockIdx.x * kPaneThreads + (threadIdx.x & ~31); base < n;
       base += stride) {
    const int i = base + lane;
    unsigned long long p = kEmptySlot;
    int v = 0, c = 0, w = 0, k = 0;
    if (i < n) {
      if (mode == kPaneWeighted) {
        p = pairs[i];  // an empty slot of the old table stays empty
        v = vals[i];
        c = cnts[i];
      } else {
        w = workers[i];
        k = keys[i];
        p = ((unsigned long long)(unsigned)w << 32) | (unsigned)k;
        v = vals ? vals[i] : 0;
        c = 1;
      }
    }
    const unsigned grp = __match_any_sync(0xffffffffu, p);
    if (p == kEmptySlot) continue;  // no warp-wide step follows
    const bool leader = (__ffs(grp) - 1) == lane;
    if (mode != kPaneNone) {
      // the group's sums: one redux.sync over the group's own mask (each
      // lane waits only for the lanes of its mask); a tuple counts 1
      const int vs = __reduce_add_sync(grp, v);
      const int cs =
          mode == kPaneWeighted ? __reduce_add_sync(grp, c) : __popc(grp);
      if (leader) {
        const long long s = pane_slot(slot_keys, log2c, p);
        if (s >= 0) {
          atomicAdd(slot_val + s, vs);
          atomicAdd(slot_cnt + s, cs);
        }
      }
    }
    if (tuples && leader) {
      // the group's last tuple is its highest lane
      atomicMax(s_last + w, seg_base + base + 31 - __clz(grp));
    }
    // the replica matrix is (kcap1, w1); the weighted re-insert of a grown
    // table adds no tuples and leaves it alone
    if (mode != kPaneWeighted && leader) repl[(long long)k * w1 + w] = 1;
  }
  if (tuples) {
    __syncthreads();
    for (int w = threadIdx.x; w < w1; w += kPaneThreads) {
      if (s_last[w] >= 0) atomicMax(pane_last + w, s_last[w]);
    }
  }
}

using RouteKernel = void (*)(RouteArgs);

template <int K>
RouteKernel route_kernel(int scheme) {
  return scheme == PKG  ? route_scan_kernel<PKG, K>
         : scheme == DC ? route_scan_kernel<DC, K>
         : scheme == WC ? route_scan_kernel<WC, K>
                        : route_scan_kernel<FISH, K>;
}

inline int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// blocks for n items, at most kBlocksPerSm on each of the device's SMs
// (read once): a grid-stride loop covers the rest
inline int capped_blocks(long long n, int per_block) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int b = blocks_for(n, per_block);
  return b < sms * kBlocksPerSm ? b : sms * kBlocksPerSm;
}

}  // namespace

extern "C" {

int ring_rows(const unsigned int* pts, int r_n, const int* cands, int dmax,
              int width, const unsigned int* hashes, const int* keys,
              int n_pad, int m, int* rows, cudaStream_t stream) {
  if (n_pad <= 0 || width <= 0) return (int)cudaGetLastError();
  if (r_n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned int) * ((r_n + kRun - 1) / kRun);
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be asked for; a
    // refused size surfaces here or as the launch's error
    cudaError_t e = cudaFuncSetAttribute(
        ring_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte row copies: whole int4s per row, rows on 16-byte boundaries
  const int vec = width % 4 == 0 && dmax % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(cands) % 16 == 0 &&
                  reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  const int per_block =
      width >= 32 ? kRingThreads / 32 : kRingThreads / width;
  const int blocks = capped_blocks(n_pad, per_block);
  ring_rows_kernel<<<blocks, kRingThreads, smem, stream>>>(
      pts, r_n, cands, dmax, width, vec, hashes, keys, n_pad, m, rows);
  return (int)cudaGetLastError();
}

// tracker_segment's layout for tables of 2^log2k key and 2^log2p pair
// slots: the first of a 16-block cluster (the non-portable size) and an
// 8-block one, with the tables in the blocks' shared memory, then the same
// with the tables in global scratch, of which the card can place at least
// one cluster (cudaOccupancyMaxActiveClusters); *log2c its blocks, *global
// 1 for global tables.  Asked once per table size: the caller keeps it
int tracker_plan(int log2k, int log2p, int* log2c, int* global) {
  if (log2k < 10 || log2p < 10 || log2k > 30 || log2p > 30) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  for (int g = 0; g < 2; ++g) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, trk_kernel(g == 1));
    if (e != cudaSuccess) return (int)e;
    for (int lc = 4; lc >= 3; --lc) {
      const size_t smem = trk_smem_bytes(g == 1, lc, log2k, log2p);
      if (smem + fa.sharedSizeBytes > (size_t)optin) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr[1];
      int n = 0;
      e = trk_config(g == 1, lc, log2k, log2p, nullptr, &cfg, attr);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveClusters(&n, trk_kernel(g == 1), &cfg);
      }
      if (e != cudaSuccess) {
        cudaGetLastError();  // a refused size: not this one
        continue;
      }
      if (n >= 1) {
        *log2c = lc;
        *global = g;
        return (int)cudaSuccess;
      }
    }
  }
  return (int)cudaErrorLaunchOutOfResources;
}

int tracker_segment(const TrackerArgs* args, cudaStream_t stream) {
  const TrackerArgs& a = *args;
  const long long touched = a.m < a.kcap1 ? a.m : a.kcap1;
  if (a.log2c < 0 || (1 << a.log2c) > kTrkMaxCluster ||
      a.log2k - a.log2c < 5 || a.log2p - a.log2c < 5 || a.log2k > 30 ||
      a.log2p > 30 || a.ne < 1 || a.m < 0 ||
      (1ll << a.log2p) < 2ll * a.m || (1ll << a.log2k) < 2 * touched ||
      (a.gkeys == nullptr) != (a.gpairs == nullptr) ||
      (a.gkeys == nullptr) != (a.glocal == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool global = a.gkeys != nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e =
      trk_config(global, a.log2c, a.log2k, a.log2p, stream, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, trk_kernel(global), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int route_scan(const RouteArgs* args, cudaStream_t stream) {
  const RouteArgs& a = *args;
  if (a.scheme != PKG && a.scheme != DC && a.scheme != WC &&
      a.scheme != FISH) {
    return (int)cudaErrorInvalidValue;
  }
  // the register chain: its K slots hold every worker and its positions
  // fit their type; else the shared-memory walk
  const int nw = a.w1 - 1;
  if (a.kreg != 0 &&
      !(a.tile >= 1 && nw >= 1 &&
        a.width <= (1 << 23) &&
        ((a.kreg == 4 && nw <= 128) || (a.kreg == 8 && nw <= 256)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile = a.kreg ? a.tile : route_tile(a.width);
  // per staged tuple: its position words (the walk: its candidates); the
  // register chain keeps two more tuples' words and a route per tuple
  const size_t per = a.kreg ? 32 * sizeof(unsigned) * (size_t)a.kreg
                            : sizeof(int) * (size_t)a.width;
  const size_t smem =
      (2 * (size_t)tile + (a.kreg ? 2 : 0)) * per +
      sizeof(int) * (2 * (size_t)tile * (a.kreg ? 2 : 1) +
                     2 * (size_t)a.w1) +
      sizeof(float) * (4 * (size_t)a.w1 + 2 * (size_t)a.ne);
  // one instantiation per routed scheme and chain: no scheme test on the
  // chain
  const RouteKernel kernel = a.kreg == 4   ? route_kernel<4>(a.scheme)
                             : a.kreg == 8 ? route_kernel<8>(a.scheme)
                                           : route_kernel<0>(a.scheme);
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

int pane_update(int mode, int reset, const int* keys, const int* workers,
                const unsigned long long* pairs, const int* vals,
                const int* cnts, int n, int w1, int seg_base, int log2c,
                unsigned long long* slot_keys, int* slot_vc, int* pane_last,
                unsigned char* repl, cudaStream_t stream) {
  if (mode != kPaneNone && (log2c < 6 || log2c > 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t cap = mode == kPaneNone ? 0 : (size_t)1 << log2c;
  if (mode != kPaneNone && reset) {
    // a fresh table: every slot empty (all bytes 0xff), sums zero; and
    // with tuples pane_last from -1
    cudaMemsetAsync(slot_keys, 0xff, sizeof(unsigned long long) * cap,
                    stream);
    cudaMemsetAsync(slot_vc, 0, sizeof(int) * 2 * cap, stream);
    if (pane_last) {
      cudaMemsetAsync(pane_last, 0xff, sizeof(int) * (size_t)w1, stream);
    }
  }
  if (n > 0) {
    const size_t smem = mode == kPaneTuples ? sizeof(int) * (size_t)w1 : 0;
    const int blocks = capped_blocks(n, kPaneThreads);
    pane_update_kernel<<<blocks, kPaneThreads, smem, stream>>>(
        mode, keys, workers, pairs, vals, cnts, n, w1, seg_base, log2c,
        slot_keys, slot_vc, slot_vc ? slot_vc + cap : nullptr, pane_last,
        repl);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
