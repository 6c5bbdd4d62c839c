// Mamba-2 SSD chunk kernels for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd.py::ssd_chunk_state (K4) and
// ::ssd_chunk_output (K5), the Pallas kernels of ops.ssd_scan that the
// mamba2-780m prefill runs once per layer.  Per (chunk, head), with
// a = the inclusive within-chunk cumsum of the log decay:
//
//   K4: S[n,p] = sum_q exp(a[Q-1] - a[q]) * b[q,n] * x[q,p],  A = a[Q-1]
//   K5: y[i,p] = sum_{j<=i} (c_i . b_j) exp(a[i] - a[j]) x[j,p]
//              + sum_n c[i,n] exp(a[i]) prev[n,p]
//
// Layouts (all float32, contiguous, the JAX package's): x (BC,Q,H,P),
// b and c (BC,Q,G,N), a (BC,Q,H), states and prev (BC,H,N,P), y (BC,Q,H,P);
// head h reads group h / (H/G).
//
// What bounds them on the card.  At mamba2-780m's prefill (BC 128, Q = N =
// 128, P = 64, H = 48, G = 1) K4 moves 414 MB (x in, states out) for 13.0
// GFLOP and K5 624 MB (x and prev in, y out) for 19.9 GFLOP (the scores
// C.B^T counted once per chunk and group: they do not depend on the head).
// Held to the port's bound of 3e-4 (one TF32 pass misses it, bf16 by far),
// the products run in three TF32 passes at 495 TFLOP/s, a third of the
// TF32 rate: K4's least time is its bytes, 0.124 ms against 0.079 ms of
// operations; K5's too, 0.186 ms against 0.120 ms.
//
// The design:
// * Every product runs on the tensor cores as mma.sync m16n8k8 with TF32
//   operands and float32 accumulation, split three ways ("3xTF32"): each
//   float32 operand v becomes hi = v with the low 13 mantissa bits cleared
//   and lo = (v - hi) cleared the same way (v - hi is exact in float32), and
//   each product is lo.hi + hi.lo + hi.hi into the accumulator; the lo.lo
//   term and lo's cut are below 2^-20 |v|.  tests/test_torch_ssd.py holds
//   this arithmetic against float64 and shows that one pass misses 3e-4.
// * Operands reach shared memory by 16-byte cp.async copies, double
//   buffered: the copy of the next tile overlaps the MMAs of this one.
//   Rows past the chunk's end are zero-filled, so a ragged Q needs no
//   other masking.
// * Fragments are loaded from shared memory by index, so the transposes
//   the products need (b^T in K4 and in K5's scores) cost nothing; the row
//   pitches are padded so that each fragment load hits 32 distinct banks.
// * The count of 8-column tiles, P / 8, is a template parameter: with a
//   run-time count every mma.sync is predicated and pays a warp barrier,
//   and the loads cannot be hoisted past the branches.
// * K4: one block of 8 warps per (chunk, head); warp w owns rows
//   [16w, 16w + 16) of the (N, P) state and all P columns (4 P / 8 float32
//   accumulators a thread).  The decay weight w[q] multiplies each staged
//   b element once, as its fragment is loaded (__fmul_rn, as the plain
//   version rounds b * w).
// * K5: one block of 4 warps per (chunk, 64 rows of y, up to 8 heads of
//   one group); warp w owns 16 rows and all P columns.  The raw scores
//   C.B^T of the block's rows are computed once, from 16-row tiles of b,
//   and kept in shared memory for all its heads, which differ only in
//   their decay, prev and x.  Per head the block then streams prev (read
//   once per row tile) through the carried-state product
//   (c_i exp(a_i)) . prev and the causal 32-row tiles of x through
//   (S o L) . x, where each score is masked and decayed as its A fragment
//   is loaded: exp(a_i - a_j) is taken only where j <= i (above the
//   diagonal it would overflow to inf, and inf * 0 is NaN).  Tiles wholly
//   above the diagonal are skipped.
//
// Launch shape at mamba2-780m's widths: K4 54 KB of dynamic shared memory
// a block, K5 90 KB (asked for with cudaFuncSetAttribute; a refusal is the
// launch's error); both declare 2 blocks an SM to ptxas, so that neither
// is squeezed into spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKT = 32;         // rows of a staged tile
constexpr int kStateWarps = 8;  // K4: N / 16 row strips (N <= 128)
constexpr int kOutRows = 64;    // K5: rows of y per block
constexpr int kOutWarps = kOutRows / 16;
constexpr int kOutHeads = 8;    // K5: at most this many heads per block
constexpr int kBT = 16;         // K5: rows of a staged b tile (the scores)
constexpr int kStages = 2;      // the copy ring: double buffered

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of copying rows `width` floats wide (a multiple of 4)
// in 16-byte pieces: its first (row, column) and its step, so that the
// copy loop divides nothing.
struct Stager {
  int r, k, dr, dk, width;
};

__device__ __forceinline__ Stager stager(int width) {
  const int chunks = width / 4;
  return {(int)threadIdx.x / chunks, (int)(threadIdx.x % chunks) * 4,
          (int)blockDim.x / chunks, (int)(blockDim.x % chunks) * 4, width};
}

// Rows [r0, r0 + nrows) of a row-major matrix (row r at src + r * stride)
// into dst (`ld` floats a row) by 16-byte cp.async; rows at or past `rows`
// are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, size_t stride,
                                           int r0, int nrows, int rows,
                                           const Stager& s) {
  for (int r = s.r, k = s.k; r < nrows;) {
    float* d = dst + r * ld + k;
    if (r0 + r < rows)
      cp_async16(d, src + (size_t)(r0 + r) * stride + k);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    r += s.dr;
    k += s.dk;
    if (k >= s.width) {
      k -= s.width;
      ++r;
    }
  }
}

// v = hi + lo + (< 2^-21 |v|), both TF32 (low 13 mantissa bits clear)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(v) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(h))) & 0xffffe000u;
}

// Not volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A.B[j] for the T column tiles in 3xTF32 (lo.hi, hi.lo, hi.hi:
// the small terms first), pass by pass, so that back-to-back MMAs never
// wait on one another's accumulator.  T is a compile-time count: a
// predicated mma.sync would cost a warp barrier each.
template <int T>
__device__ __forceinline__ void mma3_tiles(float (*acc)[4],
                                           const uint32_t* ah,
                                           const uint32_t* al,
                                           uint32_t (*bh)[2],
                                           uint32_t (*bl)[2]) {
#pragma unroll
  for (int j = 0; j < T; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < T; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < T; ++j) mma_tf32(acc[j], ah, bh[j]);
}

// B fragments (8 x 8, k-major rows at stride ld) of T column tiles, tile j
// starting at column 8j: src points at (k = t, column g).
template <int T>
__device__ __forceinline__ void load_b(const float* src, int ld,
                                       uint32_t (*bh)[2], uint32_t (*bl)[2]) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    split(src[8 * j], bh[j][0], bl[j][0]);
    split(src[4 * ld + 8 * j], bh[j][1], bl[j][1]);
  }
}

// An A fragment (16 x 8, row-major) from four values, split.  Value order
// as m16n8k8 wants it: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) for
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void split4(float v0, float v1, float v2,
                                       float v3, uint32_t* h, uint32_t* l) {
  split(v0, h[0], l[0]);
  split(v1, h[1], l[1]);
  split(v2, h[2], l[2]);
  split(v3, h[3], l[3]);
}

// K4: one block per (chunk, head), 8 warps; warp w owns state rows
// [16w, 16w + 16) (A = (b w)^T from bs[q][n]) and every column (B = x).
template <int PT>
__global__ void __launch_bounds__(kStateWarps * 32, 2)
    ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ a_cum, int q_len, int heads,
                     int p_dim, int groups, int n_dim,
                     float* __restrict__ states, float* __restrict__ a_tot) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldb = n_dim + 8, ldx = p_dim + 8;  // pitch = 8 (mod 32) banks
  const int buf = kKT * (ldb + ldx);
  const int tiles = (q_len + kKT - 1) / kKT;
  float* w_s = smem + kStages * buf;
  const int bc = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int g = h / (heads / groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t qbase = (size_t)bc * q_len;
  const Stager sb = stager(n_dim), sx = stager(p_dim);

  auto stage = [&](int t) {
    float* bs = smem + (t % kStages) * buf;
    stage_rows(bs, ldb, b + (qbase * groups + g) * n_dim,
               (size_t)groups * n_dim, t * kKT, kKT, q_len, sb);
    stage_rows(bs + kKT * ldb, ldx, x + (qbase * heads + h) * p_dim,
               (size_t)heads * p_dim, t * kKT, kKT, q_len, sx);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) stage(s);
    cp_async_commit();
  }

  const float total = a_cum[(qbase + q_len - 1) * heads + h];
  for (int q = threadIdx.x; q < tiles * kKT; q += blockDim.x)
    w_s[q] = q < q_len ? expf(total - a_cum[(qbase + q) * heads + h]) : 0.f;
  if (threadIdx.x == 0) a_tot[(size_t)bc * heads + h] = total;

  const int n0 = warp * 16;
  const bool active = n0 < n_dim;
  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed
    __syncthreads();
    if (active) {
      const float* bs = smem + (t % kStages) * buf;
      const float* xs = bs + kKT * ldb;
      const float* w = w_s + t * kKT;
#pragma unroll
      for (int ks = 0; ks < kKT; ks += 8) {
        const float w0 = w[ks + tq], w1 = w[ks + tq + 4];
        const float* r0 = bs + (ks + tq) * ldb + n0 + gq;
        const float* r1 = r0 + 4 * ldb;
        uint32_t ah[4], al[4];
        split4(__fmul_rn(r0[0], w0), __fmul_rn(r0[8], w0),
               __fmul_rn(r1[0], w1), __fmul_rn(r1[8], w1), ah, al);
        uint32_t bh[PT][2], bl[PT][2];
        load_b<PT>(xs + (ks + tq) * ldx + gq, ldx, bh, bl);
        mma3_tiles<PT>(acc, ah, al, bh, bl);
      }
    }
    __syncthreads();  // the buffer is staged again kStages - 1 tiles on
  }

  if (active) {
    float* out = states + ((size_t)bc * heads + h) * n_dim * p_dim;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(out + (n0 + gq) * p_dim + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (n0 + gq + 8) * p_dim + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// K5: one block per (chunk, 64 rows of y, hb heads of one group), 4 warps;
// warp w owns rows i0 + [16w, 16w + 16) and every column.  The raw scores
// C.B^T of the block's rows are computed once and kept in shared memory for
// the hb heads, which differ only in their decay, prev and x.  Tile
// sequence, through one ring of kStages buffers: the causal tiles of b
// (kBT rows each: the scores), then per head the prev tiles (32 state rows
// each) and the causal tiles of x (32 rows each).
template <int PT>
__global__ void __launch_bounds__(kOutWarps * 32, 2)
    ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ a_cum,
                      const float* __restrict__ prev, int q_len, int heads,
                      int p_dim, int groups, int n_dim, int hb,
                      float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row_tiles = (q_len + kOutRows - 1) / kOutRows;
  const int j_cap = row_tiles * kOutRows;
  const int ldc = n_dim + 4;  // pitch = 4 (mod 32) banks: row-indexed loads
  const int ldv = p_dim + 8;  // pitch = 8 (mod 32) banks: k-indexed loads
  const int lds = j_cap + 4;  // raw scores, row-indexed loads
  const int buf = max(kBT * ldc, kKT * ldv);
  float* c_s = smem;
  float* s_raw = c_s + kOutRows * ldc;
  float* bufs = s_raw + kOutRows * lds;
  float* a_s = bufs + kStages * buf;  // (hb, j_cap)
  const int i0 = (blockIdx.x % row_tiles) * kOutRows;
  const int hgroups = heads / hb;
  const int h0 = ((blockIdx.x / row_tiles) % hgroups) * hb;
  const int bc = blockIdx.x / (row_tiles * hgroups);
  const int g = h0 / (heads / groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t qbase = (size_t)bc * q_len;
  const int j_end = min(q_len, i0 + kOutRows);
  const int btiles = (j_end + kBT - 1) / kBT;
  const int ptiles = (n_dim + kKT - 1) / kKT;
  const int per_head = ptiles + (j_end + kKT - 1) / kKT;
  const int tiles = btiles + hb * per_head;
  const Stager sn = stager(n_dim), sv = stager(p_dim);

  auto stage = [&](int t) {
    float* dst = bufs + (t % kStages) * buf;
    if (t < btiles) {
      stage_rows(dst, ldc, b + (qbase * groups + g) * n_dim,
                 (size_t)groups * n_dim, t * kBT, kBT, q_len, sn);
    } else {
      const int hh = h0 + (t - btiles) / per_head;
      const int k = (t - btiles) % per_head;
      if (k < ptiles)
        stage_rows(dst, ldv, prev + ((size_t)bc * heads + hh) * n_dim * p_dim,
                   p_dim, k * kKT, kKT, n_dim, sv);
      else
        stage_rows(dst, ldv, x + (qbase * heads + hh) * p_dim,
                   (size_t)heads * p_dim, (k - ptiles) * kKT, kKT, q_len, sv);
    }
  };
  stage_rows(c_s, ldc, c + (qbase * groups + g) * n_dim,
             (size_t)groups * n_dim, i0, kOutRows, q_len, sn);
  for (int s = 0; s < kStages - 1; ++s) {  // c's rows go with tile 0
    if (s < tiles) stage(s);
    cp_async_commit();
  }

  for (int e = threadIdx.x; e < hb * j_end; e += blockDim.x) {
    const int hh = e / j_end, q = e - hh * j_end;
    a_s[hh * j_cap + q] = a_cum[(qbase + q) * heads + h0 + hh];
  }

  const int r_lo = 16 * warp + gq;         // this thread's rows in c_s
  const int iw = i0 + 16 * warp;           // the warp's first row of y
  const int i_lo = i0 + r_lo, i_hi = i_lo + 8;
  const bool active = iw < q_len;
  const int iw_last = min(iw + 15, q_len - 1);
  float e_lo = 0.f, e_hi = 0.f;
  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed
    __syncthreads();
    const float* ts = bufs + (t % kStages) * buf;
    if (t < btiles) {
      // raw scores C.B^T of the warp's 16 rows x this tile's kBT columns
      const int j0 = t * kBT;
      if (active && j0 <= iw_last) {
        float sc[kBT / 8][4];
#pragma unroll
        for (int u = 0; u < kBT / 8; ++u)
          sc[u][0] = sc[u][1] = sc[u][2] = sc[u][3] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < n_dim; ks += 8) {
          const float* cr = c_s + r_lo * ldc + ks + tq;
          uint32_t ah[4], al[4];
          split4(cr[0], cr[8 * ldc], cr[4], cr[8 * ldc + 4], ah, al);
          uint32_t bh[kBT / 8][2], bl[kBT / 8][2];
#pragma unroll
          for (int u = 0; u < kBT / 8; ++u) {
            const float* br = ts + (8 * u + gq) * ldc + ks + tq;
            split(br[0], bh[u][0], bl[u][0]);
            split(br[4], bh[u][1], bl[u][1]);
          }
          mma3_tiles<kBT / 8>(sc, ah, al, bh, bl);
        }
#pragma unroll
        for (int u = 0; u < kBT / 8; ++u) {
          float* sr = s_raw + r_lo * lds + j0 + 8 * u + 2 * tq;
          *reinterpret_cast<float2*>(sr) = make_float2(sc[u][0], sc[u][1]);
          *reinterpret_cast<float2*>(sr + 8 * lds) =
              make_float2(sc[u][2], sc[u][3]);
        }
      }
    } else {
      const int hh = (t - btiles) / per_head;
      const int k = (t - btiles) % per_head;
      const float* a_h = a_s + hh * j_cap;
      if (active && k < ptiles) {
        // carried state: (c_i exp(a_i)) . prev[n0 : n0 + 32, :]
        if (k == 0) {
          e_lo = i_lo < q_len ? expf(a_h[i_lo]) : 0.f;
          e_hi = i_hi < q_len ? expf(a_h[i_hi]) : 0.f;
        }
        const int n0 = k * kKT;
        const int len = min(kKT, n_dim - n0);
#pragma unroll 2
        for (int ks = 0; ks < len; ks += 8) {
          const float* cr = c_s + r_lo * ldc + n0 + ks + tq;
          uint32_t ah[4], al[4];
          split4(__fmul_rn(cr[0], e_lo), __fmul_rn(cr[8 * ldc], e_hi),
                 __fmul_rn(cr[4], e_lo), __fmul_rn(cr[8 * ldc + 4], e_hi),
                 ah, al);
          uint32_t bh[PT][2], bl[PT][2];
          load_b<PT>(ts + (ks + tq) * ldv + gq, ldv, bh, bl);
          mma3_tiles<PT>(acc, ah, al, bh, bl);
        }
      } else if (active && (k - ptiles) * kKT <= iw_last) {
        // y += (S o L) . x[j0 : j0 + 32, :], the scores masked and decayed
        // as their A fragments are loaded
        const int j0 = (k - ptiles) * kKT;
        const int live = min(kKT / 8, (iw_last - j0) / 8 + 1);
#pragma unroll 2
        for (int u = 0; u < live; ++u) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // A order: (g,t) (g+8,t) (g,t+4)..
            const int r = gq + (e & 1) * 8;
            const int j = j0 + 8 * u + tq + (e >> 1) * 4;
            const int i = iw + r;
            v[e] = (j <= i && i < q_len)
                ? __fmul_rn(s_raw[(16 * warp + r) * lds + j],
                            expf(a_h[i] - a_h[j]))
                : 0.f;
          }
          uint32_t ah[4], al[4];
          split4(v[0], v[1], v[2], v[3], ah, al);
          uint32_t bh[PT][2], bl[PT][2];
          load_b<PT>(ts + (8 * u + tq) * ldv + gq, ldv, bh, bl);
          mma3_tiles<PT>(acc, ah, al, bh, bl);
        }
      }
      if (k == per_head - 1 && active) {  // head h0 + hh is complete
        const int h = h0 + hh;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int col = 8 * j + 2 * tq;
          if (i_lo < q_len)
            *reinterpret_cast<float2*>(
                y + ((qbase + i_lo) * heads + h) * p_dim + col) =
                make_float2(acc[j][0], acc[j][1]);
          if (i_hi < q_len)
            *reinterpret_cast<float2*>(
                y + ((qbase + i_hi) * heads + h) * p_dim + col) =
                make_float2(acc[j][2], acc[j][3]);
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        }
      }
    }
    __syncthreads();  // the buffer is staged again kStages - 1 tiles on
  }
}

// Above 48 KB a block's dynamic shared memory must be asked for; a refused
// size is returned as the launch's error.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the largest divisor of n up to cap
int heads_per_block(int n, int cap) {
  int hb = cap;
  while (n % hb) --hb;
  return hb;
}

template <int PT>
int launch_state(const float* x, const float* b, const float* a_cum, int bc,
                 int q_len, int heads, int p_dim, int groups, int n_dim,
                 float* states, float* a_tot, cudaStream_t stream) {
  const int q_cap = (q_len + kKT - 1) / kKT * kKT;
  const size_t smem =
      sizeof(float) * (kStages * kKT * (n_dim + 8 + p_dim + 8) + q_cap);
  const int e = set_smem(ssd_state_kernel<PT>, smem);
  if (e) return e;
  ssd_state_kernel<PT><<<bc * heads, kStateWarps * 32, smem, stream>>>(
      x, b, a_cum, q_len, heads, p_dim, groups, n_dim, states, a_tot);
  return (int)cudaGetLastError();
}

template <int PT>
int launch_output(const float* x, const float* b, const float* c,
                  const float* a_cum, const float* prev, int bc, int q_len,
                  int heads, int p_dim, int groups, int n_dim, float* y,
                  cudaStream_t stream) {
  const int hb = heads_per_block(heads / groups, kOutHeads);
  const int row_tiles = (q_len + kOutRows - 1) / kOutRows;
  const int j_cap = row_tiles * kOutRows;
  const int buf = kBT * (n_dim + 4) > kKT * (p_dim + 8) ? kBT * (n_dim + 4)
                                                        : kKT * (p_dim + 8);
  const size_t smem =
      sizeof(float) * (kOutRows * (n_dim + 4) + kOutRows * (j_cap + 4) +
                       kStages * buf + hb * j_cap);
  const int e = set_smem(ssd_output_kernel<PT>, smem);
  if (e) return e;
  ssd_output_kernel<PT><<<bc * row_tiles * (heads / hb), kOutWarps * 32,
                          smem, stream>>>(x, b, c, a_cum, prev, q_len, heads,
                                          p_dim, groups, n_dim, hb, y);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes (checked by the wrapper, kernels/ssd.py): N a multiple of 16 up
// to 128, P a multiple of 8 up to 64 (one instance per P / 8), H a multiple
// of G, and every pointer 16-byte aligned.
extern "C" int ssd_chunk_state(const float* x, const float* b,
                               const float* a_cum, int bc, int q_len,
                               int heads, int p_dim, int groups, int n_dim,
                               float* states, float* a_tot,
                               cudaStream_t stream) {
  if (bc <= 0 || heads <= 0) return (int)cudaGetLastError();
#define SSD_STATE(PT)                                                      \
  case PT:                                                                 \
    return launch_state<PT>(x, b, a_cum, bc, q_len, heads, p_dim, groups,  \
                            n_dim, states, a_tot, stream);
  switch (p_dim / 8) {
    SSD_STATE(1) SSD_STATE(2) SSD_STATE(3) SSD_STATE(4)
    SSD_STATE(5) SSD_STATE(6) SSD_STATE(7) SSD_STATE(8)
  }
#undef SSD_STATE
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_chunk_output(const float* x, const float* b,
                                const float* c, const float* a_cum,
                                const float* prev, int bc, int q_len,
                                int heads, int p_dim, int groups, int n_dim,
                                float* y, cudaStream_t stream) {
  if (bc <= 0 || heads <= 0) return (int)cudaGetLastError();
#define SSD_OUTPUT(PT)                                                     \
  case PT:                                                                 \
    return launch_output<PT>(x, b, c, a_cum, prev, bc, q_len, heads,      \
                             p_dim, groups, n_dim, y, stream);
  switch (p_dim / 8) {
    SSD_OUTPUT(1) SSD_OUTPUT(2) SSD_OUTPUT(3) SSD_OUTPUT(4)
    SSD_OUTPUT(5) SSD_OUTPUT(6) SSD_OUTPUT(7) SSD_OUTPUT(8)
  }
#undef SSD_OUTPUT
  return (int)cudaErrorInvalidValue;
}
