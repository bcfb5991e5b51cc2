// Fused linear + cross-entropy over a full vocabulary, for Hopper (sm_90a).
//
// Replaces the TPU kernels of genrec_tpu/kernels/fused_ce.py:
//   fused_linear_ce_fwd (pallas_call at :153, body _fwd_kernel at :53),
//   fused_linear_ce_bwd (pallas_calls at :195 and :211, bodies _dx_kernel
//   at :86 and _dw_kernel at :103),
// and, run once per vocab shard, the per-shard work of the vocab-sharded
// sharded_fused_linear_ce (:328; genrec_tpu_torch/kernels/fused_ce.py
// merges the shards over torch.distributed).
// Computes what genrec_tpu_torch/kernels/fused_ce.py::fused_linear_ce_ref,
// fused_linear_ce_dx_ref and fused_linear_ce_dw_ref compute, for x (R, d),
// w (V, d), targets (R,) and a live-vocab limit vlim, with logits
// l = x . w^T in fp32 that never reach device memory. Columns at or past
// lim = min(V, vlim) read -1e30 (the JAX _tile_logits mask: head pad rows
// under tensor parallelism) and stay inside the softmax:
//
//   forward:  lse_r = logsumexp_v l_rv (online over vocab tiles, from
//             -1e30), loss_r = lse_r - l_r,t_r, 0 where t_r == ignore_index;
//             the target logit is read directly (0 for t outside [0, V),
//             -1e30 for t in [lim, V))
//   dx:       dx_r = sum_v g_r (exp(l_rv - lse_r) - [v == t_r]) w_v
//   dW:       dW_v = sum_r g_r (exp(l_rv - lse_r) - [v == t_r]) x_r
//
// with g_r taken as 0 at ignored rows. x and w are float or bf16 (one
// dtype); products and sums are fp32 (TF32 plays no part: plain FFMA);
// dx and dW are rounded to the input dtype at the end, as the Pallas
// wrapper's astype does. d is at most 2048.
//
// Bound on an H100: operations. At the HSTU training shapes (R = 6400,
// V = 12102, d = 64, bf16) the forward is 2*R*V*d = 9.9 GFLOP and each
// backward kernel twice that (the recomputed logits plus one product of
// the same size): 0.010 ms forward on the bf16 tensor cores (989
// TFLOP/s), while the inputs are 2.4 MB (0.7 us). At the LCRec shard
// shapes under tensor_parallel=2 (R = 4088, V = 76608, d = 1536, bf16)
// the forward is 0.96 TFLOP: 0.97 ms on the tensor cores, 14 ms at the
// fp32 FFMA rate (67 TFLOP/s) that these kernels use.
//
// Design (FFMA from shared memory; no mma/wgmma/TMA yet):
//   - a logits tile is 32 rows x 64 vocab columns, computed by 128 threads
//     from shared memory, each thread a 4 x 4 register block (rows
//     4*ty.., columns tx + 16*c, so the 16 threads of a row are one half
//     of a warp and reduce with shuffles). Rows in shared memory are
//     padded by one float so neighbouring threads hit distinct banks.
//     d streams through shared memory in chunks of 64 columns, one fmaf
//     chain over k ascending whatever the chunking; x stays resident when
//     d <= 64.
//   - forward and dx: blockIdx.x picks 32 rows and walks vocab tiles (the
//     Pallas grid's sequential vocab axis); dW: the transposed grid,
//     blockIdx.x picks 64 vocab rows and walks row tiles.
//   - the walked axis is split across blocks (blockIdx.y), so that the
//     grid fills the card. Each split writes fp32 partials (the forward's
//     running max and sum per row; dx's or dW's sums) to a workspace, and
//     a second kernel merges the splits in split order. No atomics: every
//     output has one owner and every sum a fixed order.
//   - the products of the backward (coeff . w for dx, coeff^T . x for dW)
//     are register-blocked too. Narrow (d <= 128): a thread owns 4 (dx)
//     or 8 (dW) output rows ty + 8 i times columns tx + 16 j, j < DJ, with
//     d <= 16 DJ, for the whole walk; splits hold at most 16 tiles.
//     Wide (d > 128): output rows of width d do not fit in registers, and
//     recomputing the logits once per d-chunk would multiply the work by
//     d / 128. So the walk goes in groups of 4 tiles: the group's coeff
//     tiles are computed once (full d) into shared memory, then the
//     product runs over 128-column chunks of d, each thread's 4 x 8 (dx)
//     or 8 x 8 (dW) block of the chunk read from the split's fp32 partial
//     in the workspace, accumulated over the group's tiles and written
//     back (the same thread reads and writes it, so the sum keeps its
//     order). Splits are few (about two blocks per SM in all), since each
//     holds an fp32 partial of the whole output.
//   - the Pallas padding of d to 128 lanes and of R and V to the blocks
//     is gone; ragged edges are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;   // rows per tile
constexpr int kCols = 64;   // vocab columns per tile
constexpr int kMaxDim = 2048;
constexpr int kNarrowDim = 128;     // the backward holds output rows in registers up to here
constexpr int kTilesPerBlock = 16;  // tiles of the walked axis per narrow split
constexpr int kChunk = 64;          // columns of d per logits chunk in shared memory
constexpr int kProdCols = 128;      // columns of d per product chunk of the wide backward
constexpr int kGroup = 4;           // tiles whose coeff the wide backward holds at once
constexpr int kWideBlocks = 264;    // the wide backward's target grid: 2 blocks per SM
constexpr float kNeg = -1e30f;
constexpr int kCStride = kCols + 1;
constexpr int kTileFloats = kRows * kCStride;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* x;
  const void* w;
  const int* tgt;
  const float* lse;   // backward
  const float* g;     // backward
  float* ws;          // fp32 partials, one slice per split
  int R, V, d, ignore_index;
  int lim;            // min(V, vlim): columns at or past it read kNeg
  int n_tiles;        // tiles of the walked axis
  int per_split;      // tiles of the walked axis per split
};

int cdiv(int a, int b) { return (a + b - 1) / b; }
// Splits of a narrow walked axis of n_tiles tiles; an empty axis (R = 0
// for dW) still has one split, of zeros.
int splits_of(int n_tiles) { return n_tiles > 0 ? cdiv(n_tiles, kTilesPerBlock) : 1; }

// (splits, tiles per split) of the wide backward's walked axis of n_tiles
// tiles, beside other_blocks blocks of the other axis: about kWideBlocks
// blocks in all, at least kGroup tiles a split, no split empty.
void wide_split(int n_tiles, int other_blocks, int& splits, int& per) {
  if (n_tiles <= 0) {
    splits = per = 1;
    return;
  }
  int want = cdiv(kWideBlocks, other_blocks > 0 ? other_blocks : 1);
  if (want > cdiv(n_tiles, kGroup)) want = cdiv(n_tiles, kGroup);
  per = cdiv(n_tiles, want);
  splits = cdiv(n_tiles, per);
}

// (splits, tiles per split) of the dx (dw = false) or dW kernel.
void bwd_split(bool dw, int R, int V, int d, int& splits, int& per) {
  const int walked = dw ? cdiv(R, kRows) : cdiv(V, kCols);
  const int other = dw ? cdiv(V, kCols) : cdiv(R, kRows);
  if (d <= kNarrowDim) {
    splits = splits_of(walked);
    per = kTilesPerBlock;
  } else {
    wide_split(walked, other, splits, per);
  }
}

// n rows starting at r0, columns k0 .. k0 + width - 1, of an (N, d) matrix
// into dst, fp32, row stride width + 1; rows past N and columns past d
// read 0.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int r0, int n, int N, int d, int k0,
                          int width) {
  const int ld = width + 1;
  for (int i = threadIdx.x; i < n * width; i += kThreads) {
    const int r = i / width;
    const int k = i - r * width;
    dst[r * ld + k] =
        (r0 + r < N && k0 + k < d) ? to_f(src[(size_t)(r0 + r) * d + k0 + k]) : 0.f;
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// acc[r][c] += x_s[4 ty + r][k] * w_s[tx + 16 c][k] over k < kn, fp32, k
// ascending.
__device__ __forceinline__ void add_logits(const float* x_s, const float* w_s, int ld, int kn,
                                           int ty, int tx, float acc[4][4]) {
  for (int k = 0; k < kn; ++k) {
    float xr[4], wc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xr[r] = x_s[(4 * ty + r) * ld + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) wc[c] = w_s[(tx + 16 * c) * ld + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xr[r], wc[c], acc[r][c]);
  }
}

// acc = the logits tile of x rows [r0, r0 + 32) and w rows [v0, v0 + 64),
// d streamed through x_s [kRows][kChunk + 1] and w_s [kCols][kChunk + 1].
// With x_resident (d <= kChunk) x_s already holds the rows. Starts with a
// barrier, so the caller may reuse x_s and w_s up to the call.
template <typename T>
__device__ void chunked_logits(const Params& p, int r0, int v0, float* x_s, float* w_s,
                               bool x_resident, int ty, int tx, float acc[4][4]) {
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  zero_acc(acc);
  for (int k0 = 0; k0 < p.d; k0 += kChunk) {
    __syncthreads();
    if (!x_resident) load_tile(x_s, x, r0, kRows, p.R, p.d, k0, kChunk);
    load_tile(w_s, w, v0, kCols, p.V, p.d, k0, kChunk);
    __syncthreads();
    add_logits(x_s, w_s, kChunk + 1, min(kChunk, p.d - k0), ty, tx, acc);
  }
}

// Reductions over the 16 lanes of a half warp (the threads of one row).
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g (R,) with ignored rows and rows past R at 0; targets past R at -1.
__device__ void load_row_meta(const Params& p, int r0, int* t_s, float* lse_s,
                              float* g_s) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int rr = r0 + r;
    const bool in = rr < p.R;
    const int t = in ? p.tgt[rr] : -1;
    t_s[r] = t;
    lse_s[r] = in ? p.lse[rr] : 0.f;
    g_s[r] = (in && t != p.ignore_index) ? p.g[rr] : 0.f;
  }
}

// coeff tile g_r (softmax - onehot) of the current logits into c_s
// [kRows][kCols + 1]; columns at or past lim take the logit kNeg.
__device__ __forceinline__ void coeff_tile(const float acc[4][4], int v0, int ty, int tx,
                                           const Params& p, const int* t_s,
                                           const float* lse_s, const float* g_s,
                                           float* c_s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      const int v = v0 + col;
      float coeff = 0.f;
      if (v < p.V) {
        const float logit = v < p.lim ? acc[r][c] : kNeg;
        const float prob = expf(logit - lse_s[row]);
        coeff = g_s[row] * (prob - (v == t_s[row] ? 1.f : 0.f));
      }
      c_s[row * kCStride + col] = coeff;
    }
  }
}

// The tiles [t0, t1) of the walked axis that this block's split owns.
__device__ __forceinline__ void split_range(const Params& p, int& t0, int& t1) {
  t0 = blockIdx.y * p.per_split;
  t1 = min(t0 + p.per_split, p.n_tiles);
}

// Forward, one split: the running max and sum of exp over this split's
// vocab tiles, per row, into ws[2 split][row] and ws[2 split + 1][row].
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* x_s = smem;                        // [kRows][kChunk + 1]
  float* w_s = x_s + kRows * (kChunk + 1);  // [kCols][kChunk + 1]
  const bool x_resident = p.d <= kChunk;
  if (x_resident) load_tile(x_s, static_cast<const T*>(p.x), r0, kRows, p.R, p.d, 0, kChunk);

  float m_run[4], s_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNeg;
    s_run[r] = 0.f;
  }
  int t0, t1;
  split_range(p, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kCols;
    float acc[4][4];
    chunked_logits<T>(p, r0, v0, x_s, w_s, x_resident, ty, tx, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v0 + tx + 16 * c >= p.lim) acc[r][c] = kNeg;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v0 + tx + 16 * c < p.V) mx = fmaxf(mx, acc[r][c]);
      const float m_new = fmaxf(m_run[r], half_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v0 + tx + 16 * c < p.V) e += expf(acc[r][c] - m_new);
      s_run[r] = s_run[r] * expf(m_run[r] - m_new) + half_sum(e);
      m_run[r] = m_new;
    }
  }
  if (tx == 0) {
    float* m_out = p.ws + (size_t)2 * blockIdx.y * p.R;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + 4 * ty + r;
      if (row < p.R) {
        m_out[row] = m_run[r];
        m_out[p.R + row] = s_run[r];
      }
    }
  }
}

// Forward, merge: one thread per row folds the splits' (max, sum) in split
// order into lse, reads the target logit and writes loss and lse.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_lse_kernel(Params p, int splits, float* loss,
                                                         float* lse_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.R) return;
  const float* ws = p.ws;
  const size_t R = p.R;
  float m = kNeg;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ws[2 * s * R + r]);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[(2 * s + 1) * R + r] * expf(ws[2 * s * R + r] - m);
  const float lse = m + logf(sum);
  const int t = p.tgt[r];
  // The target logit, read directly: the same fmaf chain as its tile's.
  float tl = 0.f;
  if (t >= p.lim && t < p.V) {
    tl = kNeg;
  } else if (t >= 0 && t < p.V) {
    const T* xr = static_cast<const T*>(p.x) + (size_t)r * p.d;
    const T* wt = static_cast<const T*>(p.w) + (size_t)t * p.d;
    for (int k = 0; k < p.d; ++k) tl = fmaf(to_f(xr[k]), to_f(wt[k]), tl);
  }
  lse_out[r] = lse;
  loss[r] = (t == p.ignore_index) ? 0.f : lse - tl;
}

// dx, narrow (d <= 16 DJ <= 128), one split: this split's vocab tiles'
// share of dx for 32 rows, fp32, into ws[split] (R, d).
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads) ce_dx_kernel(Params p) {
  constexpr int W = 16 * DJ;
  constexpr int ld = W + 1;
  extern __shared__ float smem[];
  const int d = p.d;
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* x_s = smem;                   // [kRows][W + 1]
  float* w_s = x_s + kRows * ld;       // [kCols][W + 1]
  float* c_s = w_s + kCols * ld;       // [kRows][kCols + 1]
  float* lse_s = c_s + kTileFloats;
  float* g_s = lse_s + kRows;
  int* t_s = reinterpret_cast<int*>(g_s + kRows);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  load_tile(x_s, x, r0, kRows, p.R, d, 0, W);
  load_row_meta(p, r0, t_s, lse_s, g_s);
  float dx[4][DJ];  // rows ty + 8 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dx[i][j] = 0.f;

  int t0, t1;
  split_range(p, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kCols;
    __syncthreads();
    load_tile(w_s, w, v0, kCols, p.V, d, 0, W);
    __syncthreads();
    float acc[4][4];
    zero_acc(acc);
    add_logits(x_s, w_s, ld, d, ty, tx, acc);
    coeff_tile(acc, v0, ty, tx, p, t_s, lse_s, g_s, c_s);
    __syncthreads();
    const int vn = min(kCols, p.V - v0);
    for (int v = 0; v < vn; ++v) {
      float c[4], wv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = c_s[(ty + 8 * i) * kCStride + v];
#pragma unroll
      for (int j = 0; j < DJ; ++j) wv[j] = w_s[v * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dx[i][j] = fmaf(c[i], wv[j], dx[i][j]);
    }
  }
  float* out = p.ws + (size_t)blockIdx.y * p.R * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int k = tx + 16 * j;
      if (row < p.R && k < d) out[(size_t)row * d + k] = dx[i][j];
    }
  }
}

// dW, narrow, one split: this split's row tiles' share of dW for 64 vocab
// rows, fp32, into ws[split] (V, d).
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads) ce_dw_kernel(Params p) {
  constexpr int W = 16 * DJ;
  constexpr int ld = W + 1;
  extern __shared__ float smem[];
  const int d = p.d;
  const int v0 = blockIdx.x * kCols;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* x_s = smem;                   // [kRows][W + 1]
  float* w_s = x_s + kRows * ld;       // [kCols][W + 1]
  float* c_s = w_s + kCols * ld;       // [kRows][kCols + 1]
  float* lse_s = c_s + kTileFloats;
  float* g_s = lse_s + kRows;
  int* t_s = reinterpret_cast<int*>(g_s + kRows);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  load_tile(w_s, w, v0, kCols, p.V, d, 0, W);
  float dw[8][DJ];  // vocab rows ty + 8 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dw[i][j] = 0.f;

  int t0, t1;
  split_range(p, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int r0 = t * kRows;
    __syncthreads();
    load_tile(x_s, x, r0, kRows, p.R, d, 0, W);
    load_row_meta(p, r0, t_s, lse_s, g_s);
    __syncthreads();
    float acc[4][4];
    zero_acc(acc);
    add_logits(x_s, w_s, ld, d, ty, tx, acc);
    coeff_tile(acc, v0, ty, tx, p, t_s, lse_s, g_s, c_s);
    __syncthreads();
    const int rn = min(kRows, p.R - r0);
    for (int r = 0; r < rn; ++r) {
      float c[8], xv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = c_s[r * kCStride + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) xv[j] = x_s[r * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dw[i][j] = fmaf(c[i], xv[j], dw[i][j]);
    }
  }
  float* out = p.ws + (size_t)blockIdx.y * p.V * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = v0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int k = tx + 16 * j;
      if (v < p.V && k < d) out[(size_t)v * d + k] = dw[i][j];
    }
  }
}

// Shared memory of the wide backward: kGroup coeff tiles, the row meta,
// then one buffer that holds the logits chunks (x_s, w_s) while the coeffs
// are made and the product's tile of w (dx) or x (dW) after.
constexpr int kWideBufFloats =
    (kRows + kCols) * (kChunk + 1) > kCols * (kProdCols + 1)
        ? (kRows + kCols) * (kChunk + 1)
        : kCols * (kProdCols + 1);

struct WideSmem {
  float* c_s;    // [kGroup][kRows][kCols + 1]
  float* lse_s;  // [kRows]
  float* g_s;    // [kRows]
  int* t_s;      // [kRows]
  float* x_s;    // [kRows][kChunk + 1]      } the logits chunks
  float* w_s;    // [kCols][kChunk + 1]      }
  float* p_s;    // [kCols or kRows][kProdCols + 1]: the product's tile, over x_s / w_s
};

__device__ __forceinline__ WideSmem wide_smem(float* smem) {
  WideSmem s;
  s.c_s = smem;
  s.lse_s = s.c_s + kGroup * kTileFloats;
  s.g_s = s.lse_s + kRows;
  s.t_s = reinterpret_cast<int*>(s.g_s + kRows);
  s.x_s = reinterpret_cast<float*>(s.t_s + kRows);
  s.w_s = s.x_s + kRows * (kChunk + 1);
  s.p_s = s.x_s;
  return s;
}

// dx, wide (d > 128), one split: 32 rows, this split's vocab tiles in
// groups of kGroup, the fp32 partial accumulated in ws[split] (R, d).
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_dx_wide_kernel(Params p) {
  extern __shared__ float smem[];
  const WideSmem s = wide_smem(smem);
  const int d = p.d;
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* w = static_cast<const T*>(p.w);
  float* out = p.ws + (size_t)blockIdx.y * p.R * d;

  load_row_meta(p, r0, s.t_s, s.lse_s, s.g_s);
  int t0, t1;
  split_range(p, t0, t1);
  for (int tg = t0; tg < t1; tg += kGroup) {
    const int ng = min(kGroup, t1 - tg);
    for (int g = 0; g < ng; ++g) {
      const int v0 = (tg + g) * kCols;
      float acc[4][4];
      chunked_logits<T>(p, r0, v0, s.x_s, s.w_s, false, ty, tx, acc);
      coeff_tile(acc, v0, ty, tx, p, s.t_s, s.lse_s, s.g_s, s.c_s + g * kTileFloats);
    }
    for (int k0 = 0; k0 < d; k0 += kProdCols) {
      float dx[4][8];  // rows ty + 8 i, columns k0 + tx + 16 j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          dx[i][j] = (tg > t0 && row < p.R && k < d) ? out[(size_t)row * d + k] : 0.f;
        }
      }
      for (int g = 0; g < ng; ++g) {
        const int v0 = (tg + g) * kCols;
        __syncthreads();
        load_tile(s.p_s, w, v0, kCols, p.V, d, k0, kProdCols);
        __syncthreads();
        const float* c_g = s.c_s + g * kTileFloats;
        const int vn = min(kCols, p.V - v0);
        for (int v = 0; v < vn; ++v) {
          float c[4], wv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = c_g[(ty + 8 * i) * kCStride + v];
#pragma unroll
          for (int j = 0; j < 8; ++j) wv[j] = s.p_s[v * (kProdCols + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dx[i][j] = fmaf(c[i], wv[j], dx[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          if (row < p.R && k < d) out[(size_t)row * d + k] = dx[i][j];
        }
      }
    }
  }
}

// dW, wide, one split: 64 vocab rows, this split's row tiles in groups of
// kGroup, the fp32 partial accumulated in ws[split] (V, d).
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_dw_wide_kernel(Params p) {
  extern __shared__ float smem[];
  const WideSmem s = wide_smem(smem);
  const int d = p.d;
  const int v0 = blockIdx.x * kCols;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* x = static_cast<const T*>(p.x);
  float* out = p.ws + (size_t)blockIdx.y * p.V * d;

  int t0, t1;
  split_range(p, t0, t1);
  for (int tg = t0; tg < t1; tg += kGroup) {
    const int ng = min(kGroup, t1 - tg);
    for (int g = 0; g < ng; ++g) {
      const int r0 = (tg + g) * kRows;
      __syncthreads();  // the previous tile's coeff_tile has read the row meta
      load_row_meta(p, r0, s.t_s, s.lse_s, s.g_s);
      float acc[4][4];
      chunked_logits<T>(p, r0, v0, s.x_s, s.w_s, false, ty, tx, acc);
      coeff_tile(acc, v0, ty, tx, p, s.t_s, s.lse_s, s.g_s, s.c_s + g * kTileFloats);
    }
    for (int k0 = 0; k0 < d; k0 += kProdCols) {
      float dw[8][8];  // vocab rows ty + 8 i, columns k0 + tx + 16 j
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = v0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          dw[i][j] = (tg > t0 && v < p.V && k < d) ? out[(size_t)v * d + k] : 0.f;
        }
      }
      for (int g = 0; g < ng; ++g) {
        const int r0 = (tg + g) * kRows;
        __syncthreads();
        load_tile(s.p_s, x, r0, kRows, p.R, d, k0, kProdCols);
        __syncthreads();
        const float* c_g = s.c_s + g * kTileFloats;
        const int rn = min(kRows, p.R - r0);
        for (int r = 0; r < rn; ++r) {
          float c[8], xv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) c[i] = c_g[r * kCStride + ty + 8 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[j] = s.p_s[r * (kProdCols + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dw[i][j] = fmaf(c[i], xv[j], dw[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = v0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          if (v < p.V && k < d) out[(size_t)v * d + k] = dw[i][j];
        }
      }
    }
  }
}

// Merge of the backward's splits: out[e] = sum over splits of ws[s][e],
// in split order, rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_sum_kernel(const float* ws, int splits,
                                                         long long n, T* out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += ws[s * n + e];
  out[e] = from_f<T>(a);
}

size_t fwd_smem() { return (size_t)(kRows + kCols) * (kChunk + 1) * sizeof(float); }

size_t bwd_smem(int width) {
  return ((size_t)(kRows + kCols) * (width + 1) + kTileFloats + 2 * kRows) * sizeof(float) +
         kRows * sizeof(int);
}

size_t wide_smem_bytes() {
  return ((size_t)kGroup * kTileFloats + 2 * kRows + kWideBufFloats) * sizeof(float) +
         kRows * sizeof(int);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The backward kernels: narrow, instantiated for d <= 32, 64 and 128, and
// wide for 128 < d <= 2048.
template <typename T>
cudaError_t launch_dx(dim3 grid, cudaStream_t st, const Params& p) {
  if (p.d <= 32) return launch(ce_dx_kernel<T, 2>, grid, bwd_smem(32), st, p);
  if (p.d <= 64) return launch(ce_dx_kernel<T, 4>, grid, bwd_smem(64), st, p);
  if (p.d <= kNarrowDim) return launch(ce_dx_kernel<T, 8>, grid, bwd_smem(128), st, p);
  return launch(ce_dx_wide_kernel<T>, grid, wide_smem_bytes(), st, p);
}

template <typename T>
cudaError_t launch_dw(dim3 grid, cudaStream_t st, const Params& p) {
  if (p.d <= 32) return launch(ce_dw_kernel<T, 2>, grid, bwd_smem(32), st, p);
  if (p.d <= 64) return launch(ce_dw_kernel<T, 4>, grid, bwd_smem(64), st, p);
  if (p.d <= kNarrowDim) return launch(ce_dw_kernel<T, 8>, grid, bwd_smem(128), st, p);
  return launch(ce_dw_wide_kernel<T>, grid, wide_smem_bytes(), st, p);
}

template <typename T>
cudaError_t launch_sum(const float* ws, int splits, long long n, void* out, cudaStream_t st) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  return launch(ce_sum_kernel<T>, grid, 0, st, ws, splits, n, static_cast<T*>(out));
}

Params make_params(const void* x, const void* w, const void* tgt, void* ws, int R, int V,
                   int d, int ignore_index, int vlim) {
  Params p = {};
  p.x = x;
  p.w = w;
  p.tgt = static_cast<const int*>(tgt);
  p.ws = static_cast<float*>(ws);
  p.R = R;
  p.V = V;
  p.d = d;
  p.ignore_index = ignore_index;
  p.lim = vlim < 0 ? 0 : (vlim < V ? vlim : V);
  return p;
}

cudaError_t check_args(int device, int d) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return (d < 1 || d > kMaxDim) ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity): x (R, d) and w (V, d) float or, with `bf16`, bfloat16;
// targets int32; loss, lse and g float; ws a float workspace of
// fused_ce_workspace(...) elements. d must be in [1, 2048]; vlim is the
// live-vocab limit (V for none). Each launches its kernels on `stream`
// without synchronising and returns cudaGetLastError() (0 = ok).

// fp32 workspace elements of fused_ce_fwd (which = 0), fused_ce_dx (1) or
// fused_ce_dw (2) for these sizes.
extern "C" long long fused_ce_workspace(int which, int R, int V, int d) {
  if (which == 0) return 2LL * splits_of(cdiv(V, kCols)) * R;
  int splits, per;
  bwd_split(which == 2, R, V, d, splits, per);
  return (long long)splits * (which == 1 ? R : V) * d;
}

extern "C" int fused_ce_fwd(const void* x, const void* w, const void* tgt, void* loss,
                            void* lse, void* ws, int R, int V, int d, int ignore_index,
                            int vlim, int bf16, void* stream, int device) {
  cudaError_t err = check_args(device, d);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  Params p = make_params(x, w, tgt, ws, R, V, d, ignore_index, vlim);
  p.n_tiles = cdiv(V, kCols);
  p.per_split = kTilesPerBlock;
  const int splits = splits_of(p.n_tiles);
  const dim3 grid(cdiv(R, kRows), splits);
  const dim3 rows(cdiv(R, kThreads));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* loss_f = static_cast<float*>(loss);
  float* lse_f = static_cast<float*>(lse);
  if (bf16) {
    err = launch(ce_fwd_kernel<__nv_bfloat16>, grid, fwd_smem(), st, p);
    if (err == cudaSuccess)
      err = launch(ce_lse_kernel<__nv_bfloat16>, rows, 0, st, p, splits, loss_f, lse_f);
  } else {
    err = launch(ce_fwd_kernel<float>, grid, fwd_smem(), st, p);
    if (err == cudaSuccess)
      err = launch(ce_lse_kernel<float>, rows, 0, st, p, splits, loss_f, lse_f);
  }
  return (int)err;
}

extern "C" int fused_ce_dx(const void* x, const void* w, const void* tgt, const void* lse,
                           const void* g, void* dx, void* ws, int R, int V, int d,
                           int ignore_index, int vlim, int bf16, void* stream, int device) {
  cudaError_t err = check_args(device, d);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  Params p = make_params(x, w, tgt, ws, R, V, d, ignore_index, vlim);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  p.n_tiles = cdiv(V, kCols);
  int splits;
  bwd_split(false, R, V, d, splits, p.per_split);
  const dim3 grid(cdiv(R, kRows), splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_dx<__nv_bfloat16>(grid, st, p) : launch_dx<float>(grid, st, p);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * d;
  err = bf16 ? launch_sum<__nv_bfloat16>(p.ws, splits, n, dx, st)
             : launch_sum<float>(p.ws, splits, n, dx, st);
  return (int)err;
}

extern "C" int fused_ce_dw(const void* x, const void* w, const void* tgt, const void* lse,
                           const void* g, void* dw, void* ws, int R, int V, int d,
                           int ignore_index, int vlim, int bf16, void* stream, int device) {
  cudaError_t err = check_args(device, d);
  if (err != cudaSuccess) return (int)err;
  if (V == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 0 && d > kNarrowDim)  // no rows: dW is 0 (the narrow kernel writes its zeros)
    return (int)cudaMemsetAsync(dw, 0, (size_t)V * d * (bf16 ? 2 : 4), st);
  Params p = make_params(x, w, tgt, ws, R, V, d, ignore_index, vlim);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  p.n_tiles = cdiv(R, kRows);
  int splits;
  bwd_split(true, R, V, d, splits, p.per_split);
  const dim3 grid(cdiv(V, kCols), splits);
  err = bf16 ? launch_dw<__nv_bfloat16>(grid, st, p) : launch_dw<float>(grid, st, p);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)V * d;
  err = bf16 ? launch_sum<__nv_bfloat16>(p.ws, splits, n, dw, st)
             : launch_sum<float>(p.ws, splits, n, dw, st);
  return (int)err;
}

extern "C" const char* fused_ce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
