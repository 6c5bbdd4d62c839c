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
// What bounds them on the card: operations.  At mamba2-780m's prefill
// (Q = N = 128, P = 64, H = 48, G = 1) K4 does 2QNP = 2.1 MFLOP per
// (chunk, head) over 64 KB of x and states (32 FLOP per byte) and K5
// about 5.3 MFLOP (the causal half of C.B^T and of its product with X,
// plus C.prev) over 96 KB of x, prev and y (55 FLOP per byte); b and c
// are shared by the 48 heads of a group.  Both sit above the float32
// ridge of 20 FLOP per byte (67 TFLOP/s over 3.35 TB/s).  The TPU kernels
// put one (chunk, head) tile through the 128x128 MXU; this first port runs
// on CUDA cores in float32 (the JAX kernels compute in float32 too): each
// block stages its operands in shared-memory tiles and each thread keeps a
// column of outputs in registers, reading the other operand as a
// warp-wide broadcast.  wgmma (tf32 or bf16) is the later step.
//
// K5's operands for one (chunk, head) come to ~224 KB at Q = N = 128,
// P = 64, at the 227 KB shared-memory limit, so each block takes 32 rows
// of the Q x Q score matrix and streams b, x and prev through 32-row tiles
// (45 KB of shared memory).  exp(a[i] - a[j]) is computed only for j <= i:
// above the diagonal it would overflow to inf, and inf * 0 is NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;   // chunk length
constexpr int kMaxN = 128;   // state size
constexpr int kMaxP = 64;    // head dim (must divide kThreads)
constexpr int kTileQ = 32;   // rows of a streamed tile
constexpr int kRows = 32;    // K5: rows of the score matrix per block
constexpr int kMaxJ4 = kMaxN * kMaxP / kThreads;   // K4 outputs per thread
constexpr int kMaxJ5 = kRows * kMaxP / kThreads;   // K5 outputs per thread

// K4: one block per (chunk, head).  Thread t owns column p = t % P and
// rows n = t / P + j * (256 / P) of the (N, P) state.
__global__ void ssd_state_kernel(const float* __restrict__ x,
                                 const float* __restrict__ b,
                                 const float* __restrict__ a_cum, int q_len,
                                 int heads, int p_dim, int groups, int n_dim,
                                 float* __restrict__ states,
                                 float* __restrict__ a_tot) {
  __shared__ float w_s[kMaxQ];
  __shared__ float bw_s[kTileQ][kMaxN];
  __shared__ float x_s[kTileQ][kMaxP];
  const int bc = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int step = kThreads / p_dim;
  const int p = tid % p_dim;
  const int n0 = tid / p_dim;
  const int nj = (n_dim + step - 1) / step;

  const float total = a_cum[((size_t)bc * q_len + q_len - 1) * heads + h];
  for (int q = tid; q < q_len; q += kThreads)
    w_s[q] = expf(total - a_cum[((size_t)bc * q_len + q) * heads + h]);
  float acc[kMaxJ4];
#pragma unroll
  for (int j = 0; j < kMaxJ4; ++j) acc[j] = 0.0f;

  for (int q0 = 0; q0 < q_len; q0 += kTileQ) {
    const int len = min(kTileQ, q_len - q0);
    __syncthreads();
    for (int e = tid; e < len * n_dim; e += kThreads) {
      const int r = e / n_dim, nn = e % n_dim;
      bw_s[r][nn] = __fmul_rn(
          b[(((size_t)bc * q_len + q0 + r) * groups + g) * n_dim + nn],
          w_s[q0 + r]);
    }
    for (int e = tid; e < len * p_dim; e += kThreads) {
      const int r = e / p_dim, pp = e % p_dim;
      x_s[r][pp] = x[(((size_t)bc * q_len + q0 + r) * heads + h) * p_dim + pp];
    }
    __syncthreads();
    for (int r = 0; r < len; ++r) {
      const float xv = x_s[r][p];
#pragma unroll
      for (int j = 0; j < kMaxJ4; ++j) {
        const int nn = n0 + j * step;
        if (j < nj && nn < n_dim) acc[j] = __fmaf_rn(bw_s[r][nn], xv, acc[j]);
      }
    }
  }
  float* out = states + ((size_t)bc * heads + h) * n_dim * p_dim;
#pragma unroll
  for (int j = 0; j < kMaxJ4; ++j) {
    const int nn = n0 + j * step;
    if (j < nj && nn < n_dim) out[nn * p_dim + p] = acc[j];
  }
  if (tid == 0) a_tot[(size_t)bc * heads + h] = total;
}

// K5: one block per (chunk, head, 32 rows).  Thread t owns column
// p = t % P and rows r = t / P + j * (256 / P) of the block's (32, P) tile.
__global__ void ssd_output_kernel(const float* __restrict__ x,
                                  const float* __restrict__ b,
                                  const float* __restrict__ c,
                                  const float* __restrict__ a_cum,
                                  const float* __restrict__ prev, int q_len,
                                  int heads, int p_dim, int groups, int n_dim,
                                  float* __restrict__ y) {
  __shared__ float a_s[kMaxQ];
  __shared__ float c_s[kRows][kMaxN];
  __shared__ float b_s[kTileQ][kMaxN + 1];  // +1: row reads hit 32 banks
  __shared__ float v_s[kTileQ][kMaxP];      // x tile, or a prev tile
  __shared__ float s_s[kRows][kTileQ];      // masked, decayed scores
  const int row_tiles = (q_len + kRows - 1) / kRows;
  const int i0 = (blockIdx.x % row_tiles) * kRows;
  const int h = (blockIdx.x / row_tiles) % heads;
  const int bc = blockIdx.x / (row_tiles * heads);
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int step = kThreads / p_dim;
  const int p = tid % p_dim;
  const int r0 = tid / p_dim;
  const int nj = (kRows + step - 1) / step;
  const size_t qbase = (size_t)bc * q_len;

  for (int q = tid; q < q_len; q += kThreads)
    a_s[q] = a_cum[(qbase + q) * heads + h];
  for (int e = tid; e < kRows * n_dim; e += kThreads) {
    const int r = e / n_dim, nn = e % n_dim;
    c_s[r][nn] = i0 + r < q_len
        ? c[((qbase + i0 + r) * groups + g) * n_dim + nn] : 0.0f;
  }
  __syncthreads();

  // carried state: (c_i * exp(a_i)) . prev[:, p], prev streamed by rows
  float e_i[kMaxJ5], off[kMaxJ5], diag[kMaxJ5];
#pragma unroll
  for (int j = 0; j < kMaxJ5; ++j) {
    const int r = r0 + j * step;
    e_i[j] = (j < nj && r < kRows && i0 + r < q_len) ? expf(a_s[i0 + r])
                                                     : 0.0f;
    off[j] = 0.0f;
    diag[j] = 0.0f;
  }
  const float* pv = prev + ((size_t)bc * heads + h) * n_dim * p_dim;
  for (int n0 = 0; n0 < n_dim; n0 += kTileQ) {
    const int len = min(kTileQ, n_dim - n0);
    __syncthreads();
    for (int e = tid; e < len * p_dim; e += kThreads)
      v_s[e / p_dim][e % p_dim] = pv[(size_t)(n0 + e / p_dim) * p_dim + e % p_dim];
    __syncthreads();
    for (int nn = 0; nn < len; ++nn) {
      const float pval = v_s[nn][p];
#pragma unroll
      for (int j = 0; j < kMaxJ5; ++j) {
        const int r = r0 + j * step;
        if (j < nj && r < kRows) off[j] = __fmaf_rn(__fmul_rn(c_s[r][n0 + nn], e_i[j]),
                                       pval, off[j]);
      }
    }
  }

  // chunk-local part: causal column tiles j0 < i0 + 32
  const int j_end = min(q_len, i0 + kRows);
  for (int j0 = 0; j0 < j_end; j0 += kTileQ) {
    const int len = min(kTileQ, q_len - j0);
    __syncthreads();
    for (int e = tid; e < len * n_dim; e += kThreads) {
      const int r = e / n_dim, nn = e % n_dim;
      b_s[r][nn] = b[((qbase + j0 + r) * groups + g) * n_dim + nn];
    }
    for (int e = tid; e < len * p_dim; e += kThreads) {
      const int r = e / p_dim, pp = e % p_dim;
      v_s[r][pp] = x[((qbase + j0 + r) * heads + h) * p_dim + pp];
    }
    __syncthreads();
    for (int e = tid; e < kRows * kTileQ; e += kThreads) {
      const int r = e / kTileQ, jj = e % kTileQ;
      const int i = i0 + r, j = j0 + jj;
      float s = 0.0f;
      if (i < q_len && jj < len && j <= i) {
        float dot = 0.0f;
        for (int nn = 0; nn < n_dim; ++nn)
          dot = __fmaf_rn(c_s[r][nn], b_s[jj][nn], dot);
        s = __fmul_rn(dot, expf(a_s[i] - a_s[j]));
      }
      s_s[r][jj] = s;
    }
    __syncthreads();
    for (int jj = 0; jj < len; ++jj) {
      const float xv = v_s[jj][p];
#pragma unroll
      for (int j = 0; j < kMaxJ5; ++j) {
        const int r = r0 + j * step;
        if (j < nj && r < kRows) diag[j] = __fmaf_rn(s_s[r][jj], xv, diag[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxJ5; ++j) {
    const int r = r0 + j * step;
    if (j < nj && r < kRows && i0 + r < q_len)
      y[((qbase + i0 + r) * heads + h) * p_dim + p] = __fadd_rn(diag[j], off[j]);
  }
}

}  // namespace

extern "C" int ssd_chunk_state(const float* x, const float* b,
                               const float* a_cum, int bc, int q_len,
                               int heads, int p_dim, int groups, int n_dim,
                               float* states, float* a_tot,
                               cudaStream_t stream) {
  if (bc > 0 && heads > 0) {
    ssd_state_kernel<<<bc * heads, kThreads, 0, stream>>>(
        x, b, a_cum, q_len, heads, p_dim, groups, n_dim, states, a_tot);
  }
  return (int)cudaGetLastError();
}

extern "C" int ssd_chunk_output(const float* x, const float* b,
                                const float* c, const float* a_cum,
                                const float* prev, int bc, int q_len,
                                int heads, int p_dim, int groups, int n_dim,
                                float* y, cudaStream_t stream) {
  const int row_tiles = (q_len + kRows - 1) / kRows;
  if (bc > 0 && heads > 0) {
    ssd_output_kernel<<<bc * heads * row_tiles, kThreads, 0, stream>>>(
        x, b, c, a_cum, prev, q_len, heads, p_dim, groups, n_dim, y);
  }
  return (int)cudaGetLastError();
}
