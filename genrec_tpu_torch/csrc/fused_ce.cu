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
// dtype); products and sums are fp32; dx and dW are rounded to the input
// dtype at the end, as the Pallas wrapper's astype does. d is at most 2048.
//
// Bound on an H100: operations. At the HSTU training shapes (R = 6400,
// V = 12102, d = 64, bf16) the forward is 2*R*V*d = 9.9 GFLOP and each
// backward kernel twice that (the recomputed logits plus one product of
// the same size): 0.010 ms forward and 0.020 ms backward on the bf16
// tensor cores (989 TFLOP/s), while the inputs are 2.4 MB (0.7 us). At
// the LCRec shard shapes under tensor_parallel=2 (R = 4088, V = 76608,
// d = 1536, bf16) the forward is 0.96 TFLOP: 0.97 ms on the tensor cores,
// 14 ms at the fp32 FFMA rate (67 TFLOP/s); each backward 1.95 ms. The
// forward also takes one exp per logit: R V = 77.5M at the HSTU shapes,
// ~0.02 ms at the multi-function units' 16 a clock per SM, twice its
// tensor work there.
//
// Two designs, by input type.
//
// bf16 forward: ce_fwd_tc_kernel, then ce_fwd_merge_kernel. A block of
// 288 threads (two consumer warpgroups of 64 rows, a producer warp) owns
// 128 rows of x and walks a split of consecutive vocab tiles of 256
// columns: the logits tile on wgmma (m64n256k16, x and w K-major from
// 64 x 64 TMA boxes with the 128-byte swizzle, 4 stages), then an
// epilogue that folds it into each row's running max, sum of exps and
// target logit in registers. The producer streams the K-slices of x and
// w for every tile of the split through the ring without draining it at
// tile boundaries, so the loads of the next tile overlap the epilogue.
// In the wgmma D layout a row's 256 columns lie on the 4 lanes of a quad:
// each lane keeps its own state over its 64 columns and the quad combines
// them with two shuffles at the end of the split. The exps are exp2f of
// logits pre-scaled by log2 e. The target logit is read from the same
// accumulator as the row's logsumexp (the Pallas sum-select), so the
// merge reads neither x nor w. Columns at or past lim (and the zero-filled
// ones past V) read -1e30 inside the softmax, set by one compare per
// column against the thread's count of live columns and only in the tile
// that reaches lim: a fallback value kept per column spilled the
// epilogue past the 168 registers a thread that 9 warps allow. The grid
// runs row tiles fastest, so the row blocks of a split read the same w
// tiles at about the same time, and the split count (fwd_split) fills the
// SMs in the fewest waves of one block each (4 splits, 128 blocks, one
// wave, at the LCRec shard; 5 splits, 250 blocks, at the HSTU shapes).
// Each split writes (max, sum, target logit) per row, 3 x splits x R
// floats; the merge folds the splits in split order, so two calls give
// equal bits. On an H100 (chip_smoke.py; ce_bwd_ab.py --mode fwd for the
// variants) this takes 1.31 ms at the LCRec shard, 74% of its 0.97 ms
// bound, and 0.058 ms at the HSTU shapes, where the exps bound it (the
// tensor bound is 0.010 ms); 157 registers, no spills.
//
// bf16 backward (dx and dW): tensor cores (wgmma, bf16 operands, fp32
// accumulators in registers), operands fed by TMA (sm90.cuh). Each kernel
// has 288 threads: two consumer warpgroups of 64 output rows each, and a
// producer warp whose first thread keeps 4 stages of TMA loads in
// flight (64 x 64 boxes, 128-byte swizzle, a full mbarrier per stage
// counting the bytes, an empty one returning it). coeff = g_r (exp(l -
// lse_r) - [v == t_r]) enters the products as two bf16 values, hi =
// bf16(coeff) and lo = bf16(coeff - hi), two products each: one bf16 value
// alone rounds coeff by up to 2^-9 of itself, and a row's target term
// g_r (p - 1) is of the order of g, so its rounding, times x, moves dW
// elements near 0 by more than the 1e-2 tolerance of the HSTU-shape card
// test; hi + lo carries coeff to ~2^-17. bf16, not fp16: a mean loss's g
// of ~1e-9 must not underflow. Ragged edges (R, V, a chunk, d past its tile) read TMA's
// zero fill and are masked at the store. d must be a multiple of 8 (TMA's
// 16-byte rows): the Python wrapper pads x and w with zero columns. No
// float atomics: every output element is summed in one fixed order, so
// two calls give equal bits.
//   - d <= 64 (HSTU): ce_fused_kernel. A block holds 128 rows of x (dx) or
//     of w (dW) in shared memory and walks a split of the other matrix in
//     tiles of 128 rows: the logits tile (m64n128k16 from K-major tiles),
//     coeff in registers, then the product with coeff as the register A
//     operand of m64n64k16 and the walked tile, read MN-major, as B; the
//     128 x d output tile stays in registers for the whole walk. dW's
//     walked rows' meta (lse, g, target) is staged in shared memory a tile
//     at a time. Each split writes an fp32 partial; ce_merge_bf16_kernel
//     adds them in split order (workspace: splits x rows x d fp32, ~10 MB
//     at the HSTU shapes).
//   - d > 64 (LCRec, d = 1536): the output rows do not fit in registers,
//     so the vocabulary goes in chunks of Vc columns (chunk_cols: both
//     coeff planes, 4 R Vc bytes, within kChunkBytes = 64 MB: at the LCRec
//     shard on an H100, ce_bwd_ab.py timed dx 6.49 / 5.91 / 5.76 ms and
//     dW 6.01 / 5.30 / 5.35 ms with 32 / 64 / 128 MB, so fewer chunks
//     outweigh the L2 misses up to 64 MB, and 128 MB buys no more for its
//     67 MB). Per chunk,
//     ce_tc_kernel<kCoeff> computes the logits tile (128 x 256, K = d)
//     and writes the hi and lo planes of coeff (R x Vc) to the workspace;
//     then ce_tc_kernel<kDxProduct>: dx += C (K-major) . w_c (Vc x d, the
//     MN-major B), summed over the chunks in chunk order through an fp32
//     (R, d) accumulator in the workspace (each tile starts its registers
//     from it while its first stages load), the last chunk writing bf16;
//     or ce_tc_kernel<kDwProduct>: dW_c = C^T (the MN-major A) . x
//     (MN-major B), written once. Workspace: 4 R Vc bytes, plus 4 R d for
//     dx over several chunks, whatever V is (67 and 92 MB at the shard).
//
// fp32 (every kernel): FFMA from shared memory, no tensor cores, so that fp32 results agree with the plain versions to
// 1e-5 (TF32 would not):
//   - a logits tile is 32 rows x 64 vocab columns, computed by 128 threads
//     from shared memory, each thread a 4 x 4 register block (rows
//     4*ty.., columns tx + 16*c, so the 16 threads of a row are one half
//     of a warp and reduce with shuffles). Rows in shared memory are
//     padded by one float so neighbouring threads hit distinct banks.
//     d streams through shared memory in chunks of 64 columns, each chunk
//     one fmaf chain over k ascending from 0, the chunks' sums added in
//     order (the rounding error grows with 64 plus the number of chunks,
//     not with d); x stays resident when d <= 64. The narrow backward
//     (d <= 128) runs one chain over all of d.
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
#include <stdint.h>

#include "sm90.cuh"

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

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
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
// into dst, row stride width + 1; rows past N and columns past d read 0.
__device__ void load_tile(float* dst, const float* src, int r0, int n, int N, int d, int k0,
                          int width) {
  const int ld = width + 1;
  for (int i = threadIdx.x; i < n * width; i += kThreads) {
    const int r = i / width;
    const int k = i - r * width;
    dst[r * ld + k] =
        (r0 + r < N && k0 + k < d) ? src[(size_t)(r0 + r) * d + k0 + k] : 0.f;
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
// Each chunk's products are one fmaf chain from 0, added to acc: a single
// chain over d = 2048 put the logits ~4x farther from fp64 than the plain
// version's GEMM. With x_resident (d <= kChunk) x_s already holds the
// rows. Starts with a barrier, so the caller may reuse x_s and w_s up to
// the call.
__device__ void chunked_logits(const Params& p, int r0, int v0, float* x_s, float* w_s,
                               bool x_resident, int ty, int tx, float acc[4][4]) {
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  zero_acc(acc);
  for (int k0 = 0; k0 < p.d; k0 += kChunk) {
    __syncthreads();
    if (!x_resident) load_tile(x_s, x, r0, kRows, p.R, p.d, k0, kChunk);
    load_tile(w_s, w, v0, kCols, p.V, p.d, k0, kChunk);
    __syncthreads();
    float part[4][4];
    zero_acc(part);
    add_logits(x_s, w_s, kChunk + 1, min(kChunk, p.d - k0), ty, tx, part);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
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
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float* x_s = smem;                        // [kRows][kChunk + 1]
  float* w_s = x_s + kRows * (kChunk + 1);  // [kCols][kChunk + 1]
  const bool x_resident = p.d <= kChunk;
  if (x_resident) load_tile(x_s, static_cast<const float*>(p.x), r0, kRows, p.R, p.d, 0, kChunk);

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
    chunked_logits(p, r0, v0, x_s, w_s, x_resident, ty, tx, acc);
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
  // The target logit, read directly: the same chunked fmaf chains as its
  // tile's (chunked_logits), so the same bits.
  float tl = 0.f;
  if (t >= p.lim && t < p.V) {
    tl = kNeg;
  } else if (t >= 0 && t < p.V) {
    const float* xr = static_cast<const float*>(p.x) + (size_t)r * p.d;
    const float* wt = static_cast<const float*>(p.w) + (size_t)t * p.d;
    for (int k0 = 0; k0 < p.d; k0 += kChunk) {
      float part = 0.f;
      for (int k = k0; k < min(k0 + kChunk, p.d); ++k) part = fmaf(xr[k], wt[k], part);
      tl += part;
    }
  }
  lse_out[r] = lse;
  loss[r] = (t == p.ignore_index) ? 0.f : lse - tl;
}

// dx, narrow (d <= 16 DJ <= 128), one split: this split's vocab tiles'
// share of dx for 32 rows, fp32, into ws[split] (R, d).
template <int DJ>
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
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

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
template <int DJ>
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
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

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
__global__ void __launch_bounds__(kThreads) ce_dx_wide_kernel(Params p) {
  extern __shared__ float smem[];
  const WideSmem s = wide_smem(smem);
  const int d = p.d;
  const int r0 = blockIdx.x * kRows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* w = static_cast<const float*>(p.w);
  float* out = p.ws + (size_t)blockIdx.y * p.R * d;

  load_row_meta(p, r0, s.t_s, s.lse_s, s.g_s);
  int t0, t1;
  split_range(p, t0, t1);
  for (int tg = t0; tg < t1; tg += kGroup) {
    const int ng = min(kGroup, t1 - tg);
    for (int g = 0; g < ng; ++g) {
      const int v0 = (tg + g) * kCols;
      float acc[4][4];
      chunked_logits(p, r0, v0, s.x_s, s.w_s, false, ty, tx, acc);
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
__global__ void __launch_bounds__(kThreads) ce_dw_wide_kernel(Params p) {
  extern __shared__ float smem[];
  const WideSmem s = wide_smem(smem);
  const int d = p.d;
  const int v0 = blockIdx.x * kCols;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* x = static_cast<const float*>(p.x);
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
      chunked_logits(p, r0, v0, s.x_s, s.w_s, false, ty, tx, acc);
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

// Merge of the fp32 backward's splits: out[e] = sum over splits of
// ws[s][e], in split order.
__global__ void __launch_bounds__(kThreads) ce_sum_kernel(const float* ws, int splits,
                                                         long long n, float* out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += ws[s * n + e];
  out[e] = a;
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

// The fp32 backward kernels: narrow, instantiated for d <= 32, 64 and
// 128, and wide for 128 < d <= 2048; then the merge of their splits.
cudaError_t launch_ffma_bwd(bool dw, dim3 grid, cudaStream_t st, const Params& p, int splits,
                            void* out) {
  cudaError_t err;
  if (p.d <= 32)
    err = launch(dw ? ce_dw_kernel<2> : ce_dx_kernel<2>, grid, bwd_smem(32), st, p);
  else if (p.d <= 64)
    err = launch(dw ? ce_dw_kernel<4> : ce_dx_kernel<4>, grid, bwd_smem(64), st, p);
  else if (p.d <= kNarrowDim)
    err = launch(dw ? ce_dw_kernel<8> : ce_dx_kernel<8>, grid, bwd_smem(128), st, p);
  else
    err = launch(dw ? ce_dw_wide_kernel : ce_dx_wide_kernel, grid, wide_smem_bytes(), st, p);
  if (err != cudaSuccess) return err;
  const long long n = (long long)(dw ? p.V : p.R) * p.d;
  const dim3 sum_grid((unsigned)((n + kThreads - 1) / kThreads));
  return launch(ce_sum_kernel, sum_grid, 0, st, p.ws, splits, n, static_cast<float*>(out));
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


// ---- bf16 backward on the tensor cores ----

using sm90::kAtomBytes;
using sm90::kBox;
using sm90::kBoxBytes;

constexpr int kTcM = 128;         // output rows of a tile: two consumer warpgroups of 64
constexpr int kTcN = 128;         // output columns of a tile, and walked rows a fused step
constexpr int kTcK = 64;          // depth of a pipeline stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 288;   // two consumer warpgroups, then one producer warp
constexpr long long kChunkBytes = 64LL << 20;  // both coeff planes of a chunk
constexpr int kFusedDim = 64;     // d up to here: the fused kernels
constexpr int kFusedBlocks = 264; // the fused kernels' target grid: two waves of the SMs

// The shared-memory descriptors of a 64-row slice of a tile: K-major (the
// k16 step moves 32 bytes in the swizzle atom) or MN-major (16 rows, 2 KB;
// LBO = the next 64-wide box along M or N).
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  return sm90::desc_sw128(static_cast<const unsigned char*>(tile) + 32 * kk, 16, kAtomBytes);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  return sm90::desc_sw128(static_cast<const unsigned char*>(tile) + 2 * kAtomBytes * kk,
                          kBoxBytes, kAtomBytes);
}

// coeff = g (exp(logit - lse) - [v == t]) for vocab column v, 0 past V;
// columns at or past lim take the logit kNeg.
__device__ __forceinline__ float coeff_of(float logit, int v, float lse, float g, int t,
                                          const int V, const int lim) {
  if (v >= V) return 0.f;
  return g * (expf((v < lim ? logit : kNeg) - lse) - (v == t ? 1.f : 0.f));
}

// (hi, lo) bf16x2 registers of two coeffs: hi = bf16(c), lo = bf16(c - hi).
__device__ __forceinline__ void split_bf16(float c0, float c1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(c0, c1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = sm90::pack_bf16x2(c0 - __low2float(h), c1 - __high2float(h));
}

// The row meta of row r: (lse, g with ignored rows and rows past R at 0,
// target, -1 past R).
struct RowMeta {
  float lse, g;
  int t;
};
__device__ __forceinline__ RowMeta row_meta(int r, int R, const int* tgt, const float* lse,
                                            const float* g, int ignore_index) {
  RowMeta m = {0.f, 0.f, -1};
  if (r < R) {
    m.t = tgt[r];
    m.lse = lse[r];
    m.g = m.t == ignore_index ? 0.f : g[r];
  }
  return m;
}

// ---- d > 64: per vocab chunk, the coeff kernel, then a product kernel ----

enum TcMode { kCoeff = 0, kDxProduct = 1, kDwProduct = 2 };

struct TcParams {
  int R, V, d;      // d a multiple of 8
  int v0, vc;       // this chunk: vocab rows [v0, v0 + vc)
  int ldc;          // row stride of a coeff plane, elements (a multiple of 128)
  int lim, ignore_index;
  const int* tgt;
  const float* lse;
  const float* g;
  __nv_bfloat16* hi;   // coeff planes (R, ldc): hi = bf16(coeff), lo = bf16(coeff - hi)
  __nv_bfloat16* lo;
  float* acc;          // dx: the fp32 sum over the chunks so far (R, d)
  __nv_bfloat16* out;  // dx (R, d) or dW (V, d)
  int first, last;     // dx: this is the first / the last chunk
};

// Tile width and A planes by kernel. The coeff kernel's tiles are 128 x
// 256 (m64n256k16): at the LCRec shard on an H100 (ce_bwd_ab.py) it took
// 2.61 ms a call against 2.82 on 128 x 128 tiles, while the dW product
// ran its 1.92 TFLOP in 2.58 ms. The products keep 128 x 128 tiles, whose
// two A planes (hi, lo) share one B.
template <int Mode>
struct TcShape {
  static constexpr int planes = Mode == kCoeff ? 1 : 2;
  static constexpr int bn = Mode == kCoeff ? 256 : kTcN;
};

// Per stage: A (128 rows x 64, two 64-row boxes) in one plane (coeff
// kernel) or two (hi, lo: the products), B (bn x 64).
template <int Mode>
struct alignas(1024) TcSmem {
  __nv_bfloat16 a[kTcStages][TcShape<Mode>::planes][kTcM * kTcK];
  __nv_bfloat16 b[kTcStages][TcShape<Mode>::bn * kTcK];
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
};

// Columns of a vocab chunk: both bf16 coeff planes (4 R Vc bytes) within
// kChunkBytes, a multiple of 128, at least 128, at most V rounded up.
int chunk_cols(int R, int V) {
  long long vc = kChunkBytes / (4LL * (R > 0 ? R : 1)) / 128 * 128;
  const long long whole = (long long)cdiv(V, 128) * 128;
  if (vc < 128) vc = 128;
  return (int)(vc < whole ? vc : whole);
}

// The producer: the first thread of the producer warp keeps the stages in
// flight.
template <int Mode>
__device__ void tc_produce(TcSmem<Mode>& s, const CUtensorMap* a, const CUtensorMap* a_lo,
                           const CUtensorMap* b, const TcParams& p, int m0, int n0, int nk) {
  constexpr int planes = TcShape<Mode>::planes;
  constexpr int bn = TcShape<Mode>::bn;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kTcStages;
    if (kt >= kTcStages) sm90::mbar_wait(&s.empty[st], ((kt / kTcStages) & 1) ^ 1);
    uint64_t* bar = &s.full[st];
    sm90::mbar_expect_tx(bar, (planes * kTcM + bn) * kTcK * 2);
    const int k0 = kt * kTcK;
    for (int pl = 0; pl < planes; ++pl) {
      const CUtensorMap* map = pl == 0 ? a : a_lo;
      for (int j = 0; j < kTcM / kBox; ++j) {
        __nv_bfloat16* dst = s.a[st][pl] + j * kBox * kBox;
        if (Mode == kDwProduct)  // C^T: the chunk's columns are A's rows
          sm90::tma_load_2d(dst, map, bar, m0 + kBox * j, k0);
        else
          sm90::tma_load_2d(dst, map, bar, k0, m0 + kBox * j);
      }
    }
    for (int j = 0; j < bn / kBox; ++j) {
      __nv_bfloat16* dst = s.b[st] + j * kBox * kBox;
      if (Mode == kCoeff)  // w_c rows, K-major
        sm90::tma_load_2d(dst, b, bar, k0, p.v0 + n0 + kBox * j);
      else if (Mode == kDxProduct)  // w_c rows k, MN-major
        sm90::tma_load_2d(dst, b, bar, n0 + kBox * j, p.v0 + k0);
      else  // x rows k, MN-major
        sm90::tma_load_2d(dst, b, bar, n0 + kBox * j, k0);
    }
  }
}

// One tile of 128 output rows (m0..) by bn columns (n0..):
//   kCoeff      rows of x by the chunk's vocab columns; K = d. Writes the
//               coeff planes. map_a = x, map_b = w.
//   kDxProduct  rows of x by columns of d; K = the chunk's vocab columns.
//               map_a / map_a_lo = the coeff planes, map_b = w.
//   kDwProduct  the chunk's vocab rows by columns of d; K = R.
//               map_a / map_a_lo = the coeff planes, map_b = x.
template <int Mode>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_a_lo,
                 const __grid_constant__ CUtensorMap map_b, const TcParams p) {
  constexpr int stages = kTcStages;
  constexpr int bn = TcShape<Mode>::bn;
  extern __shared__ unsigned char smem_raw[];
  TcSmem<Mode>& s = *reinterpret_cast<TcSmem<Mode>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kTcM;
  const int n0 = blockIdx.x * bn;
  const int depth = Mode == kCoeff ? p.d : Mode == kDxProduct ? p.vc : p.R;
  const int nk = cdiv(depth, kTcK);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(&s.full[i], 1);
      sm90::mbar_init(&s.empty[i], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == 256) tc_produce<Mode>(s, &map_a, &map_a_lo, &map_b, p, m0, n0, nk);
    return;
  }

  constexpr int TA = Mode == kDwProduct;  // A MN-major
  constexpr int TB = Mode != kCoeff;      // B MN-major
  const int c = wg;                       // this warpgroup's 64 rows of the tile
  const int t = threadIdx.x - 128 * wg;
  // acc[4 j + 2 h + q] is row 16 warp + lane / 4 + 8 h of this warpgroup's
  // 64, column 8 j + 2 (lane % 4) + q of the tile (the wgmma D layout).
  const int lane = t & 31;
  const int row0 = m0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float acc[bn / 2];
#pragma unroll
  for (int i = 0; i < bn / 2; ++i) acc[i] = 0.f;
  if (Mode == kDxProduct && !p.first) {
    // dx: start from the earlier chunks' sum, read while the first stages
    // load; this chunk's products then add to it in k order.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
#pragma unroll
      for (int j = 0; j < bn / 8; ++j) {
        const int k = col0 + 8 * j;
        if (r < p.R && k < p.d) {
          const float2 prev = *reinterpret_cast<const float2*>(p.acc + (size_t)r * p.d + k);
          acc[4 * j + 2 * h] = prev.x;
          acc[4 * j + 2 * h + 1] = prev.y;
        }
      }
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % stages;
    sm90::mbar_wait(&s.full[st], (kt / stages) & 1);
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint64_t db = TB ? desc_mnmajor(s.b[st], kk) : desc_kmajor(s.b[st], kk);
#pragma unroll
      for (int pl = 0; pl < TcShape<Mode>::planes; ++pl) {
        const __nv_bfloat16* a_t = s.a[st][pl] + c * kBox * kBox;
        const uint64_t da = TA ? desc_mnmajor(a_t, kk) : desc_kmajor(a_t, kk);
        if constexpr (bn == 256)
          sm90::wgmma_m64n256k16<TA, TB>(acc, da, db);
        else
          sm90::wgmma_m64n128k16<TA, TB>(acc, da, db);
      }
    }
    sm90::wgmma_commit();
    sm90::fence_operands(acc);
    sm90::wgmma_wait<1>();  // the previous stage's products are done: return it
    if (kt > 0 && t == 0) sm90::mbar_arrive(&s.empty[(kt - 1) % stages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;  // kDwProduct: a vocab row of the chunk
    if constexpr (Mode == kCoeff) {
      if (r >= p.R) continue;
      const RowMeta m = row_meta(r, p.R, p.tgt, p.lse, p.g, p.ignore_index);
      const size_t o = (size_t)r * p.ldc;
#pragma unroll
      for (int j = 0; j < bn / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col >= p.vc) continue;
        const int v = p.v0 + col;
        uint32_t hi, lo;
        split_bf16(coeff_of(acc[4 * j + 2 * h], v, m.lse, m.g, m.t, p.V, p.lim),
                   coeff_of(acc[4 * j + 2 * h + 1], v + 1, m.lse, m.g, m.t, p.V, p.lim), hi,
                   lo);
        *reinterpret_cast<uint32_t*>(p.hi + o + col) = hi;
        *reinterpret_cast<uint32_t*>(p.lo + o + col) = lo;
      }
    } else if constexpr (Mode == kDxProduct) {
      if (r >= p.R) continue;
#pragma unroll
      for (int j = 0; j < kTcN / 8; ++j) {
        const int k = col0 + 8 * j;
        if (k >= p.d) continue;
        const size_t o = (size_t)r * p.d + k;
        const float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (p.last)
          *reinterpret_cast<__nv_bfloat162*>(p.out + o) = __floats2bfloat162_rn(v.x, v.y);
        else
          *reinterpret_cast<float2*>(p.acc + o) = v;
      }
    } else {
      if (r >= p.vc) continue;
      const size_t o = (size_t)(p.v0 + r) * p.d;
#pragma unroll
      for (int j = 0; j < kTcN / 8; ++j) {
        const int k = col0 + 8 * j;
        if (k >= p.d) continue;
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + k) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- d <= 64: fused, coeff never leaves the registers ----

struct FusedParams {
  int R, V, d, lim, ignore_index;
  const int* tgt;
  const float* lse;
  const float* g;
  float* part;    // fp32 partials (splits, rows, d); rows = R (dx) or V (dW)
  int n_tiles;    // walked tiles of 128: of the vocabulary (dx) or of the rows (dW)
  int per_split;  // walked tiles a split
};

struct alignas(1024) FusedSmem {
  __nv_bfloat16 res[kTcM * kTcK];           // the resident 128 rows of x (dx) or w (dW)
  __nv_bfloat16 b[kTcStages][kTcN * kTcK];  // walked tiles: 128 rows of w (dx) or x (dW)
  RowMeta meta[2][kTcN];                    // dW: the walked rows' meta, two tiles in turn
  uint64_t res_bar;
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
};

// One block: 128 resident rows (x rows for dx, vocab rows of w for dW) and
// one split of the walked tiles (vocab tiles for dx, row tiles for dW).
// Per walked tile: the logits tile (resident . walked^T, K = d <= 64, on
// the tensor cores from shared memory), coeff in registers, then the
// product coeff . walked (dx: coeff . w; dW: coeff^T . x), with coeff as
// the register A operand (hi, then lo) and the walked tile, MN-major, as
// B; the 128 x d output tile stays in registers for the whole walk and is
// written as this split's fp32 partial.
template <bool DW>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_fused_kernel(const __grid_constant__ CUtensorMap map_res,
                    const __grid_constant__ CUtensorMap map_walk, const FusedParams p) {
  extern __shared__ unsigned char smem_raw[];
  FusedSmem& s = *reinterpret_cast<FusedSmem*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * kTcM;
  const int t0 = blockIdx.y * p.per_split;
  const int nt = min(t0 + p.per_split, p.n_tiles) - t0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&s.res_bar, 1);
    for (int i = 0; i < kTcStages; ++i) {
      sm90::mbar_init(&s.full[i], 1);
      sm90::mbar_init(&s.empty[i], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(&s.res_bar, kTcM * kTcK * 2);
      for (int j = 0; j < kTcM / kBox; ++j)
        sm90::tma_load_2d(s.res + j * kBox * kBox, &map_res, &s.res_bar, 0, m0 + kBox * j);
      for (int kt = 0; kt < nt; ++kt) {
        const int st = kt % kTcStages;
        if (kt >= kTcStages) sm90::mbar_wait(&s.empty[st], ((kt / kTcStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&s.full[st], kTcN * kTcK * 2);
        for (int j = 0; j < kTcN / kBox; ++j)
          sm90::tma_load_2d(s.b[st] + j * kBox * kBox, &map_walk, &s.full[st], 0,
                            (t0 + kt) * kTcN + kBox * j);
      }
    }
    return;
  }

  const int c = wg;
  const int t = threadIdx.x - 128 * wg;
  const int lane = t & 31;
  const int row0 = m0 + 64 * c + 16 * (t >> 5) + (lane >> 2);  // and row0 + 8
  RowMeta rm[2];  // dx: this thread's two rows of x
  if (!DW)
    for (int h = 0; h < 2; ++h)
      rm[h] = row_meta(row0 + 8 * h, p.R, p.tgt, p.lse, p.g, p.ignore_index);
  const __nv_bfloat16* res = s.res + c * kBox * kBox;
  float out[32];  // the output tile: 64 rows x 64 columns of d (the D layout)
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = 0.f;
  sm90::mbar_wait(&s.res_bar, 0);
  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt % kTcStages;
    const int w0 = (t0 + kt) * kTcN;  // the tile's first walked vocab column (dx) or row (dW)
    const RowMeta* meta = s.meta[kt & 1];
    if (DW) {  // the consumers stage the tile's row meta; two buffers in turn
      if (threadIdx.x < kTcN)
        s.meta[kt & 1][threadIdx.x] =
            row_meta(w0 + threadIdx.x, p.R, p.tgt, p.lse, p.g, p.ignore_index);
      sm90::consumer_sync();
    }
    sm90::mbar_wait(&s.full[st], (kt / kTcStages) & 1);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      sm90::wgmma_m64n128k16<0, 0>(acc, desc_kmajor(res, kk), desc_kmajor(s.b[st], kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

    // Register q of k16 block kb of the A fragment holds acc[8 kb + 2 q]
    // and acc[8 kb + 2 q + 1]: row + 8 (q & 1), walked columns
    // 16 kb + 8 (q >> 1) + 2 (lane % 4) + {0, 1}.
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1;
        const int col = 16 * kb + 8 * (q >> 1) + 2 * (lane & 3);
        float cf[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float logit = acc[8 * kb + 2 * q + e];
          if (DW) {  // the column is a row of x; this thread's row is a vocab row
            const RowMeta m = meta[col + e];
            cf[e] = coeff_of(logit, row0 + 8 * h, m.lse, m.g, m.t, p.V, p.lim);
          } else {
            cf[e] = coeff_of(logit, w0 + col + e, rm[h].lse, rm[h].g, rm[h].t, p.V, p.lim);
          }
        }
        split_bf16(cf[0], cf[1], hi[kb][q], lo[kb][q]);
      }
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      const uint64_t db = desc_mnmajor(s.b[st], kb);
      sm90::wgmma_m64n64k16_rs<1>(out, hi[kb], db);
      sm90::wgmma_m64n64k16_rs<1>(out, lo[kb], db);
    }
    sm90::wgmma_commit();
    sm90::fence_operands(out);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(out);
    if (t == 0) sm90::mbar_arrive(&s.empty[st]);
  }

  const int rows = DW ? p.V : p.R;
  float* part = p.part + (size_t)blockIdx.y * rows * p.d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * j + 2 * (lane & 3);
      if (k < p.d)
        *reinterpret_cast<float2*>(part + (size_t)r * p.d + k) =
            make_float2(out[4 * j + 2 * h], out[4 * j + 2 * h + 1]);
    }
  }
}

// out[e] = the sum of the splits' partials part[s][e], in split order, as bf16.
__global__ void __launch_bounds__(kThreads) ce_merge_bf16_kernel(const float* part, int splits,
                                                                long long n,
                                                                __nv_bfloat16* out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += part[s * n + e];
  out[e] = __float2bfloat16_rn(a);
}

// (splits, walked tiles a split) of a fused kernel: about kFusedBlocks
// blocks in all, no split empty.
void fused_split(bool dw, int R, int V, int& splits, int& per) {
  const int walked = cdiv(dw ? R : V, kTcN);
  int want = cdiv(kFusedBlocks, cdiv(dw ? V : R, kTcM));
  if (want > walked) want = walked;
  per = cdiv(walked, want);
  splits = cdiv(walked, per);
}

long long tc_workspace_bytes(bool dx, int R, int V, int d) {
  if (d <= kFusedDim) {
    int splits, per;
    fused_split(!dx, R, V, splits, per);
    return 4LL * splits * (dx ? R : V) * d;
  }
  const int vc = chunk_cols(R, V);
  long long bytes = 4LL * R * vc;
  if (dx && cdiv(V, vc) > 1) bytes += 4LL * R * d;
  return bytes;
}

template <int Mode>
constexpr size_t tc_smem_bytes() {
  return sizeof(TcSmem<Mode>) + 1024;  // + the alignment slack
}

template <typename Kernel, typename... Args>
cudaError_t launch_tc(Kernel kernel, size_t smem, dim3 grid, cudaStream_t st, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// dx (dw = false) or dW of bf16 inputs, d <= 64: the fused kernel, then
// the merge of its splits.
cudaError_t fused_backward(bool dw, const Params& q, const CUtensorMap& mx,
                           const CUtensorMap& mw, void* out, cudaStream_t st) {
  FusedParams p = {};
  p.R = q.R;
  p.V = q.V;
  p.d = q.d;
  p.lim = q.lim;
  p.ignore_index = q.ignore_index;
  p.tgt = q.tgt;
  p.lse = q.lse;
  p.g = q.g;
  p.part = q.ws;
  int splits;
  fused_split(dw, q.R, q.V, splits, p.per_split);
  p.n_tiles = cdiv(dw ? q.R : q.V, kTcN);
  const int rows = dw ? q.V : q.R;
  const dim3 grid(cdiv(rows, kTcM), splits);
  const size_t smem = sizeof(FusedSmem) + 1024;
  const cudaError_t err =
      dw ? launch_tc(ce_fused_kernel<true>, smem, grid, st, mw, mx, p)
         : launch_tc(ce_fused_kernel<false>, smem, grid, st, mx, mw, p);
  if (err != cudaSuccess) return err;
  const long long n = (long long)rows * q.d;
  return launch(ce_merge_bf16_kernel, dim3((unsigned)((n + kThreads - 1) / kThreads)), 0, st,
                static_cast<const float*>(q.ws), splits, n, static_cast<__nv_bfloat16*>(out));
}

// dx (dw = false) or dW of bf16 inputs, d > 64: per vocab chunk, the coeff
// kernel, then the product.
cudaError_t chunked_backward(bool dw, const Params& q, const CUtensorMap& mx,
                             const CUtensorMap& mw, void* out, cudaStream_t st) {
  const int R = q.R, V = q.V;
  const int vc_max = chunk_cols(R, V);
  const int chunks = cdiv(V, vc_max);
  TcParams p = {};
  p.R = R;
  p.V = V;
  p.d = q.d;
  p.ldc = vc_max;
  p.lim = q.lim;
  p.ignore_index = q.ignore_index;
  p.tgt = q.tgt;
  p.lse = q.lse;
  p.g = q.g;
  p.hi = reinterpret_cast<__nv_bfloat16*>(q.ws);
  p.lo = p.hi + (size_t)R * vc_max;
  p.acc = reinterpret_cast<float*>(p.lo + (size_t)R * vc_max);
  p.out = static_cast<__nv_bfloat16*>(out);
  CUtensorMap mhi, mlo;
  for (int ch = 0; ch < chunks; ++ch) {
    p.v0 = ch * vc_max;
    p.vc = V - p.v0 < vc_max ? V - p.v0 : vc_max;
    p.first = ch == 0;
    p.last = ch == chunks - 1;
    // The planes as this chunk's (R, vc) matrices: columns past vc read 0.
    if (!sm90::bf16_map(&mhi, p.hi, R, p.vc, vc_max) ||
        !sm90::bf16_map(&mlo, p.lo, R, p.vc, vc_max))
      return cudaErrorInvalidValue;
    cudaError_t err =
        launch_tc(ce_tc_kernel<kCoeff>, tc_smem_bytes<kCoeff>(),
                  dim3(cdiv(p.vc, TcShape<kCoeff>::bn), cdiv(R, kTcM)), st, mx, mx, mw, p);
    if (err != cudaSuccess) return err;
    err = dw ? launch_tc(ce_tc_kernel<kDwProduct>, tc_smem_bytes<kDwProduct>(),
                         dim3(cdiv(q.d, kTcN), cdiv(p.vc, kTcM)), st, mhi, mlo, mx, p)
             : launch_tc(ce_tc_kernel<kDxProduct>, tc_smem_bytes<kDxProduct>(),
                         dim3(cdiv(q.d, kTcN), cdiv(R, kTcM)), st, mhi, mlo, mw, p);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dx (dw = false) or dW of bf16 inputs (R, V >= 1).
cudaError_t tc_backward(bool dw, const Params& q, void* out, cudaStream_t st) {
  if (q.d % 8 != 0 || !aligned16(q.x) || !aligned16(q.w) || !aligned16(q.ws))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (!sm90::bf16_map(&mx, q.x, q.R, q.d, q.d) || !sm90::bf16_map(&mw, q.w, q.V, q.d, q.d))
    return cudaErrorInvalidValue;
  return q.d <= kFusedDim ? fused_backward(dw, q, mx, mw, out, st)
                          : chunked_backward(dw, q, mx, mw, out, st);
}

// ---- bf16 forward on the tensor cores ----

constexpr int kFwdN = 256;           // vocab columns of a tile (m64n256k16)
constexpr int kFwdSplits = 0;        // 0: fwd_split chooses; else at most this many
constexpr bool kFwdRowsFast = true;  // grid x = row tiles, y = splits (else swapped)
constexpr int kSMs = 132;            // an H100 SXM's SMs: one block each
// The exps run on logits pre-scaled by log2 e, one exp2f each;
// lse = (m + log2 sum) / kFwdScale.
constexpr float kFwdScale = 1.4426950408889634f;
__device__ __forceinline__ float fwd_exp(float v) { return exp2f(v); }
__device__ __forceinline__ float fwd_log(float v) { return log2f(v); }

struct FwdParams {
  int R, V, d, lim;
  int n_tiles, per_split;  // vocab tiles of kFwdN columns; tiles a split
  const int* tgt;
  float* part;  // (splits, 3, R): scaled running max, sum of exps, target logit
};

// Per stage: x (128 rows x 64 of d, two boxes) and w (BN rows x 64).
template <int BN>
struct alignas(1024) FwdSmem {
  __nv_bfloat16 a[kTcStages][kTcM * kTcK];
  __nv_bfloat16 b[kTcStages][BN * kTcK];
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
};

// (splits, tiles a split) of the forward's vocab tiles beside cdiv(R, 128)
// row tiles: the fewest waves of one block an SM times a block's work in
// k-steps (a tile's nk, plus one for its epilogue; plus the pipeline's
// fill), the fewest splits on a tie; no split empty.
int fwd_split(int R, int V, int d, int& per) {
  const int rows = cdiv(R, kTcM), tiles = cdiv(V, kFwdN), nk = cdiv(d, kTcK);
  int splits = kFwdSplits > 0 ? (kFwdSplits < tiles ? kFwdSplits : tiles) : 1;
  if (kFwdSplits <= 0) {
    long long best = -1;
    for (int want = 1; want <= tiles; ++want) {
      const int p = cdiv(tiles, want);
      if (cdiv(tiles, p) != want) continue;
      const long long cost = (long long)cdiv(rows * want, kSMs) * (p * (nk + 1LL) + kTcStages);
      if (best < 0 || cost < best) {
        best = cost;
        splits = want;
      }
    }
  }
  per = cdiv(tiles, splits);
  return cdiv(tiles, per);
}

// Folds one logits tile into this thread's running state of its two rows
// (h = 0, 1: rows row0 and row0 + 8). acc[4 j + 2 h + q] is vocab column
// c0 + 8 j + q. With ragged (the tile reaches lim) columns at or past lim
// read kNeg, those past V too: they add exp(kNeg - m) = 0 to a row with a
// live column, and to a row with none (lim = 0) they add to a sum whose
// log vanishes beside |kNeg| (lse = -1e30 in fp32 either way). The
// target logit is taken from the tile when the row's target is one of
// this thread's columns (kNeg at or past lim, as the plain version reads
// it).
template <int BN>
__device__ __forceinline__ void fwd_fold(float (&acc)[BN / 2], int c0, bool ragged,
                                         const FwdParams& p, const int (&tg)[2], float (&m)[2],
                                         float (&sum)[2], float (&tl)[2]) {
  if (ragged) {  // one compare against this thread's count of live columns
    const int live = p.lim - c0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (8 * j + q >= live) acc[4 * j + 2 * h + q] = kNeg;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tg[h] - c0;
    if (c >= 0 && c < BN && tg[h] < p.V) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (c == 8 * j + q) tl[h] = acc[4 * j + 2 * h + q];
    }
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float& a = acc[4 * j + 2 * h + q];
        a *= kFwdScale;
        mx = fmaxf(mx, a);
      }
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) e += fwd_exp(acc[4 * j + 2 * h + q] - mx);
    sum[h] = sum[h] * fwd_exp(m[h] - mx) + e;
    m[h] = mx;
  }
}

// One block: 128 rows of x against one split of consecutive vocab tiles
// of BN columns. The producer warp's first thread streams (x, w) K-slices
// of every tile of the split through the ring without draining it between
// tiles (at d <= 64 too: x's slice comes from L2 with each tile, and
// loading it once measured no faster); the two consumer
// warpgroups (64 rows each) run the logits tile on wgmma (K-major x and
// w) and fold it into each row's running max, sum of exps and target
// logit in registers. Each lane keeps its own state over its columns; the
// four lanes of a row combine theirs at the end, and the split writes its
// partials for ce_fwd_merge_kernel.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
    ce_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<BN>& s = *reinterpret_cast<FwdSmem<BN>*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int split = kFwdRowsFast ? blockIdx.y : blockIdx.x;
  const int m0 = (kFwdRowsFast ? blockIdx.x : blockIdx.y) * kTcM;
  const int t0 = split * p.per_split;
  const int nt = min(t0 + p.per_split, p.n_tiles) - t0;
  const int nk = cdiv(p.d, kTcK);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) {
      sm90::mbar_init(&s.full[i], 1);
      sm90::mbar_init(&s.empty[i], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int it = 0; it < nt * nk; ++it) {
        const int st = it % kTcStages;
        if (it >= kTcStages) sm90::mbar_wait(&s.empty[st], ((it / kTcStages) & 1) ^ 1);
        const int k0 = (it % nk) * kTcK;
        const int v0 = (t0 + it / nk) * BN;
        uint64_t* bar = &s.full[st];
        sm90::mbar_expect_tx(bar, (kTcM + BN) * kTcK * 2);
        for (int j = 0; j < kTcM / kBox; ++j)
          sm90::tma_load_2d(s.a[st] + j * kBox * kBox, &map_x, bar, k0, m0 + kBox * j);
        for (int j = 0; j < BN / kBox; ++j)
          sm90::tma_load_2d(s.b[st] + j * kBox * kBox, &map_w, bar, k0, v0 + kBox * j);
      }
    }
    return;
  }

  const int t = threadIdx.x - 128 * wg;
  const int lane = t & 31;
  const int row0 = m0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);  // and row0 + 8
  int tg[2];
  float m[2], sum[2], tl[2];  // every tile's columns are finite (masked: kNeg)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tg[h] = row0 + 8 * h < p.R ? p.tgt[row0 + 8 * h] : -1;
    m[h] = -INFINITY;
    sum[h] = 0.f;
    tl[h] = 0.f;
  }
  float acc[BN / 2];
  int it = 0;
  for (int tile = 0; tile < nt; ++tile) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kTcStages;
      sm90::mbar_wait(&s.full[st], (it / kTcStages) & 1);
      const __nv_bfloat16* a_t = s.a[st] + wg * kBox * kBox;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcK / 16; ++kk) {
        if constexpr (BN == 256)
          sm90::wgmma_m64n256k16<0, 0>(acc, desc_kmajor(a_t, kk), desc_kmajor(s.b[st], kk));
        else
          sm90::wgmma_m64n128k16<0, 0>(acc, desc_kmajor(a_t, kk), desc_kmajor(s.b[st], kk));
      }
      sm90::wgmma_commit();
      sm90::fence_operands(acc);
      sm90::wgmma_wait<1>();  // the previous stage's products are done: return it
      if (kt > 0 && t == 0) sm90::mbar_arrive(&s.empty[(it - 1) % kTcStages]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    if (t == 0) sm90::mbar_arrive(&s.empty[(it - 1) % kTcStages]);  // the tile's last stage
    const int v0 = (t0 + tile) * BN;
    fwd_fold<BN>(acc, v0 + 2 * (lane & 3), v0 + BN > p.lim, p, tg, m, sum, tl);
  }

  // The four lanes of each row combine their states; the first writes.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float so = __shfl_xor_sync(0xffffffffu, sum[h], o);
      const float mx = fmaxf(m[h], mo);
      sum[h] = sum[h] * fwd_exp(m[h] - mx) + so * fwd_exp(mo - mx);
      m[h] = mx;
      tl[h] += __shfl_xor_sync(0xffffffffu, tl[h], o);  // one lane at most holds it
    }
    const int r = row0 + 8 * h;
    if ((lane & 3) == 0 && r < p.R) {
      float* out = p.part + (size_t)3 * split * p.R + r;
      out[0] = m[h];
      out[p.R] = sum[h];
      out[2 * (size_t)p.R] = tl[h];
    }
  }
}

// Merge of the bf16 forward's splits: one thread a row folds the splits'
// (max, sum, target logit) in split order into lse and loss.
__global__ void __launch_bounds__(kThreads)
    ce_fwd_merge_kernel(const float* part, int splits, int R, const int* tgt, int ignore_index,
                        float* loss, float* lse_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t n = R;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[3 * s * n + r]);
  float sum = 0.f, tl = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* q = part + 3 * s * n + r;
    sum += q[n] * fwd_exp(q[0] - m);
    tl += q[2 * n];
  }
  const float lse = (m + fwd_log(sum)) / kFwdScale;
  lse_out[r] = lse;
  loss[r] = tgt[r] == ignore_index ? 0.f : lse - tl;
}

constexpr size_t fwd_smem_bytes() { return sizeof(FwdSmem<kFwdN>) + 1024; }

// The forward of bf16 inputs (R, V >= 1): the tensor-core kernel, then
// the merge of its splits.
cudaError_t tc_forward(const Params& q, float* loss, float* lse, cudaStream_t st) {
  if (q.d % 8 != 0 || !aligned16(q.x) || !aligned16(q.w)) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (!sm90::bf16_map(&mx, q.x, q.R, q.d, q.d) || !sm90::bf16_map(&mw, q.w, q.V, q.d, q.d))
    return cudaErrorInvalidValue;
  FwdParams p = {};
  p.R = q.R;
  p.V = q.V;
  p.d = q.d;
  p.lim = q.lim;
  p.n_tiles = cdiv(q.V, kFwdN);
  p.tgt = q.tgt;
  p.part = q.ws;
  const int splits = fwd_split(q.R, q.V, q.d, p.per_split);
  const int rows = cdiv(q.R, kTcM);
  const dim3 grid = kFwdRowsFast ? dim3(rows, splits) : dim3(splits, rows);
  const cudaError_t err =
      launch_tc(ce_fwd_tc_kernel<kFwdN>, fwd_smem_bytes(), grid, st, mx, mw, p);
  if (err != cudaSuccess) return err;
  return launch(ce_fwd_merge_kernel, dim3(cdiv(q.R, kThreads)), 0, st,
                static_cast<const float*>(q.ws), splits, q.R, q.tgt, q.ignore_index, loss, lse);
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity): x (R, d) and w (V, d) float or, with `bf16`, bfloat16;
// targets int32; loss, lse and g float; ws a float workspace of
// fused_ce_workspace(...) elements. d must be in [1, 2048], and for the
// bf16 backward a multiple of 8 with x, w and ws 16-byte aligned; vlim is
// the live-vocab limit (V for none). Each launches its kernels on
// `stream` without synchronising and returns cudaGetLastError() (0 = ok).

// fp32 workspace elements of fused_ce_fwd (which = 0), fused_ce_dx (1) or
// fused_ce_dw (2) for these sizes and input type.
extern "C" long long fused_ce_workspace(int which, int R, int V, int d, int bf16) {
  if (which == 0 && bf16) {
    int per;
    return 3LL * fwd_split(R, V, d, per) * R;
  }
  if (which == 0) return 2LL * splits_of(cdiv(V, kCols)) * R;
  if (bf16) return (tc_workspace_bytes(which == 1, R, V, d) + 3) / 4;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* loss_f = static_cast<float*>(loss);
  float* lse_f = static_cast<float*>(lse);
  if (bf16) return (int)tc_forward(p, loss_f, lse_f, st);
  p.n_tiles = cdiv(V, kCols);
  p.per_split = kTilesPerBlock;
  const int splits = splits_of(p.n_tiles);
  err = launch(ce_fwd_kernel, dim3(cdiv(R, kRows), splits), fwd_smem(), st, p);
  if (err == cudaSuccess)
    err = launch(ce_lse_kernel, dim3(cdiv(R, kThreads)), 0, st, p, splits, loss_f, lse_f);
  return (int)err;
}

// dx (dw = false) or dW: bf16 on the tensor cores, fp32 by FFMA.
static int backward(bool dw, const void* x, const void* w, const void* tgt, const void* lse,
             const void* g, void* out, void* ws, int R, int V, int d, int ignore_index,
             int vlim, int bf16, void* stream, int device) {
  cudaError_t err = check_args(device, d);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || V == 0) {  // no rows: dW is 0; no rows or no vocab: dx is empty or 0
    const size_t n = (size_t)(dw ? V : R) * d * (bf16 ? 2 : 4);
    return n ? (int)cudaMemsetAsync(out, 0, n, static_cast<cudaStream_t>(stream)) : 0;
  }
  Params p = make_params(x, w, tgt, ws, R, V, d, ignore_index, vlim);
  p.lse = static_cast<const float*>(lse);
  p.g = static_cast<const float*>(g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)tc_backward(dw, p, out, st);
  p.n_tiles = dw ? cdiv(R, kRows) : cdiv(V, kCols);
  int splits;
  bwd_split(dw, R, V, d, splits, p.per_split);
  const dim3 grid(dw ? cdiv(V, kCols) : cdiv(R, kRows), splits);
  return (int)launch_ffma_bwd(dw, grid, st, p, splits, out);
}

extern "C" int fused_ce_dx(const void* x, const void* w, const void* tgt, const void* lse,
                           const void* g, void* dx, void* ws, int R, int V, int d,
                           int ignore_index, int vlim, int bf16, void* stream, int device) {
  return backward(false, x, w, tgt, lse, g, dx, ws, R, V, d, ignore_index, vlim, bf16, stream,
                  device);
}

extern "C" int fused_ce_dw(const void* x, const void* w, const void* tgt, const void* lse,
                           const void* g, void* dw, void* ws, int R, int V, int d,
                           int ignore_index, int vlim, int bf16, void* stream, int device) {
  return backward(true, x, w, tgt, lse, g, dw, ws, R, V, d, ignore_index, vlim, bf16, stream,
                  device);
}

// Dynamic shared memory of one block of a bf16 kernel at width d: the
// forward's ce_fwd_tc_kernel (kernel = 2), or the backward's
// ce_fused_kernel (d <= 64, kernel 0 or 1), ce_tc_kernel of the coeff
// (kernel = 0) or of the product (1).
extern "C" long long fused_ce_bf16_smem(int d, int kernel) {
  if (kernel == 2) return (long long)fwd_smem_bytes();
  if (d <= kFusedDim) return (long long)sizeof(FusedSmem) + 1024;
  return (long long)(kernel ? tc_smem_bytes<kDxProduct>() : tc_smem_bytes<kCoeff>());
}

extern "C" const char* fused_ce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
