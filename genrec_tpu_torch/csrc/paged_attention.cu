// Paged decode attention, flash statistics, for Hopper (sm_90a): over
// float32 pools (B1) and over int8 pools dequantised in the kernel (B2),
// with a float32 q; and, where the model computes in bf16, B1 over
// bfloat16 pools and B2 over int8 pools, each with a bfloat16 q.
//
// B1 replaces the TPU kernel genrec_tpu/kernels/paged_attention.py::
// paged_attention_stats_pallas (pallas_call at :227, body _kernel at :43);
// B2 replaces paged_attention_stats_pallas_quantized (pallas_call at :164,
// body _kernel_quant at :78).
// Computes what genrec_tpu/ops/paged.py::_stats_fallback computes (and its
// port, genrec_tpu_torch/kernels/paged_attention.py::
// paged_attention_stats_ref): for every slot s, beam b and head h,
//
//   score_t = (q[s,b,h,:] . K[t,h,:]) * hd^-0.5, t over ALL Pm*page positions
//             read through block_tables[s, :] (entries clamped into [0, P));
//             score_t = -1e9 where t >= seq_lens[s] (filled, and kept
//             inside the softmax)
//   m = max_t score_t,  l = sum_t exp(score_t - m),
//   acc = sum_t exp(score_t - m) * V[t,h,:]
//
// all in fp32, as the Pallas bodies compute it: they cast q, K and V to
// fp32 after the load (genrec_tpu/kernels/paged_attention.py:57-59 and
// :93-95). For int8 pools each element is dequantised first,
// k = float(int8) * scale[page, row], then the dot, then hd^-0.5; the pool
// is never upcast outside the kernel. (JAX's CPU fallback takes the score
// einsum in the input type, so with bf16 inputs it rounds every score to
// bf16; the port follows the kernel it replaces, not the fallback.)
//
// Bound on an H100: memory. A call must read the K and V rows of the
// positions the result depends on: a slot's first min(seq_len, Pm*page)
// positions, or all Pm*page when seq_len <= 0. At the TIGER serving shape
// (S 64, K 10, H 6, hd 64, page 16, Pm 4, served histories) that is ~6.5
// MB of fp32 K/V (8.5 MB with q and the outputs: 2.5 us at 3.35 TB/s),
// ~3.3 MB of bf16 K/V (4.7 MB with a bf16 q and the fp32 outputs: 1.4 us),
// or ~1.6 MB of int8 rows and scales (3.6 MB: 1.1 us). Over the
// speculative tree (K 730 nodes) q in and the fp32 (acc, m, l) out
// dominate: 108 MB with a bf16 q, 34 us. The fp32 arithmetic, 4*K*H*hd
// flops a position, is ~0.5 us at the 67 TFLOP/s of fp32 FFMA at the
// serving shape; with a bf16 q, q.k is a product of bf16 values, exact in
// fp32, and e.V a product of bf16 planes, and both run on the tensor
// cores.
//
// Design of the fp32-q kernel, paged_attention_stats_kernel (the choices
// settled by `python3 ce_bwd_ab.py --mode paged`, whose variants are text
// substitutions of this file):
//   - One block of 8 warps per (slot, head) and up to 32 beams, all of a
//     slot's beams in one block when K <= 32 (splitting them over blocks
//     lost at S 16 and 64). A wider query axis, the speculative tree's
//     nodes (K 180 or 730), spreads over ceil(K / 32) blocks along z, each
//     walking the slot's live pages again (mostly from L2); each node's
//     row is computed as at K <= 32, so the results do not depend on the
//     split. The head dim is a
//     template parameter (32, 64 or 128: q and K zero-padded to it in
//     shared memory, so every hd <= 128 runs and the loops unroll).
//   - Only live positions are walked. Once a beam's running max m exceeds
//     -1e9 + 128, a masked position adds exp(-1e9 - m) = 0 (exactly: fp32's
//     smallest subnormal is exp(-103.3)) to l and acc and leaves m and the
//     correction factor (1) as they are, so positions past
//     min(seq_len, Pm*page) change no bit. The block checks this after the
//     live positions: if any of its beams' m is still <= -1e9 + 128, it
//     walks the rest as well. A slot with seq_len <= 0 walks every position
//     (its result is the mean of V over all of them, null page included).
//     The running max starts at -inf, so a slot whose live scores all lie
//     below -1e9 gets the plain version's max too.
//   - Asynchronous copies, all issued before the first wait. The slot's
//     block-table row and seq_len are read once (one round trip); a stage
//     holds 64 consecutive positions (any page size) of head h's K and V
//     rows; a ring of stages lives in shared memory, and every stage that
//     fits is issued up front with cp.async (16 bytes a thread where rows
//     and pools allow, else 4, else plain byte loads). At the serving shape
//     one stage holds a slot's whole capacity; longer slots stream, the
//     math on stage i overlapping the copies of the stages after it, the
//     online softmax running across stages only.
//   - B2 copies the raw int8 rows and their row scales, and dequantises a
//     landed stage once, for all beams, into fp32 rows in shared memory;
//     from there B1 and B2 run the same math.
//   - Scores: a thread owns one position of the stage and every fourth
//     beam, four at a time, its K row (a 16-byte padded, conflict-free
//     layout) read once for the four, q broadcast from shared memory.
//   - Softmax and e.V: a half-warp owns a beam (16 beams a step for the
//     block's 16 half-warps): one max and one sum over the stage's 64
//     scores (4 a lane), then e.V over the stage's positions with its 16
//     lanes across head_dim (a float4 a lane at hd 64), the accumulators in
//     registers and the weight broadcast from shared memory, a loop with no
//     branch and no dependent load.
//   - Deterministic: no atomics, fixed orders; two calls give equal bits.
//
// Design of the bf16-q kernel, paged_attention_mma_kernel (B1 over bf16
// pages, B2 with a bf16 q; `ce_bwd_ab.py --mode paged` A/Bs its variants
// too): the same walk (live positions, 64-position stages by cp.async,
// block-table row and seq_len read once, clamping, no atomics), the math
// on the tensor cores, and nothing but raw pages and q in shared memory:
//   - The beams, or a tree's nodes, are the tile's M: 16 nodes a tile, a
//     block up to 128 nodes (up to 4 warps, each taking its tiles in
//     turn; 64 when the positions stream through the ring), a wider axis
//     spread evenly over ceil(K / 128) blocks along z (TIGER's 730 nodes:
//     6 blocks, each walking the slot's pages once). Every tile's q rows
//     are copied as the block starts. A block has at least 4 warps at hd
//     <= 64 (2 at hd 128), all issuing the copies: at K <= 16 one warp
//     computes. A node's row is computed the same in any tile or block,
//     so the results do not depend on the split.
//   - q.k: bf16 mma.sync m16n8k16 with fp32 sums, q's A fragments from
//     its rows in shared memory, K's B fragments by ldmatrix straight from
//     the stage cp.async filled (rows padded by 16 bytes: 8 rows hit 8
//     distinct 4-bank groups). bf16 x bf16 products are exact in fp32, so
//     only the order of the fp32 sum differs from the plain version. int8
//     K converts to bf16 in registers (exact: |x| <= 127 fits bf16's 8
//     significant bits); ldmatrix hands a lane 4 consecutive bytes of a
//     row, so the tile's k index runs over head_dim permuted, q's fragments
//     permuted alike; the row's k_scale multiplies the fp32 dot, then
//     hd^-0.5.
//   - The online softmax runs in registers, per row, over the score
//     fragments (two rows a thread, the quad's shuffles for the max and
//     the sum); scores past seq_len are -1e9, past the stage -inf.
//   - e.V: bf16 mma.sync with e in fp32 split into three bf16 planes (hi,
//     mid, lo: together all 24 bits of e, so the products sum the fp32
//     weight exactly; two planes missed 1e-5 elementwise), the score
//     fragments re-used as the A operand register for register, V's B
//     fragments by ldmatrix.trans from the raw stage. int8 V: ldmatrix.trans
//     of the byte rows gives a lane bytes of two neighbouring columns, which
//     become two output tiles of even and odd columns; v_scale folds into
//     the weight (e_t * vs_t) before the split.
//   - acc leaves through the tile's buffer (its q rows spent), 8 rows at a
//     time, as whole 16-byte rows.
//   - The rescue: the masked positions all score exactly -1e9, so a row
//     whose live max is within 128 of -1e9 takes them in closed form after
//     the walk (acc * c + exp(-1e9 - m') * sum of their V rows, l * c +
//     (cap - live) * exp(-1e9 - m'), m' = max(m, -1e9), c = exp(m - m')):
//     the block sums those V rows once and fixes its stored rows.
//   - No widened or dequantised copy of a stage, no score buffer: a
//     block's shared memory is its raw ring (the slot's capacity rounded up
//     to 16 positions while it fits 72 KB), q's rows and the block-table
//     row. COBRA's bf16 shape: 80 positions at hd 128, 52,756 B a block,
//     four blocks an SM.
//   - At hd <= 64 __launch_bounds__ asks for four blocks an SM over bf16
//     pages (128 registers a thread), three over int8; none spills.
// The TPU version's (8, 128) padding of beams and head_dim, its
// lane-replicated m/l blocks and its (P, page, 128) scale plane are tiling
// artefacts and are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageTokens = 64;  // positions a stage holds; divides kThreads, a multiple of 32
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 136 * 1024;  // stages beyond two are added while they fit in this
// Beams (or tree nodes) one block holds at most: a (slot, head) with more
// spreads them over ceil(K / kMaxBeams) blocks along z.
constexpr int kMaxBeams = 32;
constexpr float kNeg = -1e9f;
constexpr float kSkipMargin = 128.f;  // m > kNeg + this: exp(kNeg - m) is exactly 0
// A beam's row of scores in shared memory: a stage's positions and 4
// floats of pad, so that two beams' rows start 4 banks apart.
constexpr int kScRow = kStageTokens + 4;

struct Params {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools: (P, page) row scales; nullptr for fp32
  const float* v_scale;
  const int* block_tables;
  const int* seq_lens;
  float* acc;
  float* m;
  float* l;
  int K, H, hd, P, page, Pm;
  int beams_per_block;  // beams of one block: min(K, kMaxBeams)
  int stages;           // ring depth, 1..kMaxStages
  int copy_bytes;       // 16, 4 or 1
  float scale;
};

// Shared-memory layout of one stage for pages of type T at head width HD.
template <typename T, int HD>
struct Stage {
  static constexpr bool kInt8 = !std::is_same<T, float>::value;
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  // K rows padded by 16 bytes: in the fp32 rows the dot reads, 8 lanes
  // reading 16 bytes of 8 rows hit 8 distinct 4-bank groups.
  static constexpr int kKRow = kRowBytes + 16;
  static constexpr int kVRow = kRowBytes;
  static constexpr int kV = kStageTokens * kKRow;            // V rows' offset
  static constexpr int kScales = kV + kStageTokens * kVRow;  // K then V row scales (int8)
  static constexpr int kBytes = kScales + (kInt8 ? 2 * kStageTokens * 4 : 0);
  static constexpr int kUnits = kRowBytes / 16;  // 16-byte units of a padded row
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's newest copy groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 3: cp_async_wait_group<3>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 1: cp_async_wait_group<1>(); break;
    default: cp_async_wait_group<0>(); break;
  }
}

// Issue the copies of positions t0 .. t0 + n - 1 of head h into one
// stage: K and V rows (and, for int8, their row scales). `pages` is the
// slot's block-table row, clamped, in shared memory.
template <typename T, int HD>
__device__ __forceinline__ void issue_stage(unsigned char* stage, const Params& p,
                                            const int* pages, int h, int t0, int n, int tid) {
  using L = Stage<T, HD>;
  const int row_bytes = p.hd * (int)sizeof(T);
  for (int i = tid; i < n * L::kUnits; i += kThreads) {
    const int r = i / L::kUnits;
    const int b0 = 16 * (i - r * L::kUnits);
    if (b0 >= row_bytes) continue;
    const int pos = t0 + r;
    const int pi = pos / p.page;
    const size_t row =
        (((size_t)pages[pi] * p.page + (pos - pi * p.page)) * p.H + h) * p.hd * sizeof(T) + b0;
    const char* kg = static_cast<const char*>(p.k_pool) + row;
    const char* vg = static_cast<const char*>(p.v_pool) + row;
    unsigned char* kd = stage + r * L::kKRow + b0;
    unsigned char* vd = stage + L::kV + r * L::kVRow + b0;
    if (p.copy_bytes == 16) {
      cp_async_16(kd, kg);
      cp_async_16(vd, vg);
    } else if (p.copy_bytes == 4) {
      for (int w = 0; w < 16 && b0 + w < row_bytes; w += 4) {
        cp_async_4(kd + w, kg + w);
        cp_async_4(vd + w, vg + w);
      }
    } else {
      for (int w = 0; w < 16 && b0 + w < row_bytes; ++w) {
        kd[w] = kg[w];
        vd[w] = vg[w];
      }
    }
  }
  if constexpr (L::kInt8) {
    float* ks = reinterpret_cast<float*>(stage + L::kScales);
    for (int r = tid; r < n; r += kThreads) {
      const int pos = t0 + r;
      const int pi = pos / p.page;
      const size_t at = (size_t)pages[pi] * p.page + (pos - pi * p.page);
      cp_async_4(ks + r, p.k_scale + at);
      cp_async_4(ks + kStageTokens + r, p.v_scale + at);
    }
  }
}

// A lane's N consecutive floats of a row in shared memory (N = 1, 2, 4 or 8).
template <int N>
__device__ __forceinline__ void lane_floats(const float* row, int lane, float (&out)[N]) {
  const float* src = row + lane * N;
  if constexpr (N == 1) {
    out[0] = src[0];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      out[i] = v.x, out[i + 1] = v.y, out[i + 2] = v.z, out[i + 3] = v.w;
    }
  }
}

// B2: a landed stage of int8 rows into fp32 rows, k = float(int8) *
// scale[row] (the plain version's product), once for all beams.
template <int HD>
__device__ __forceinline__ void dequantize_stage(const unsigned char* raw, unsigned char* out,
                                                 int n, int hd, int tid) {
  using R = Stage<int8_t, HD>;
  using F = Stage<float, HD>;
  constexpr int kQuads = HD / 4;  // 4 elements an item
  const float* scales = reinterpret_cast<const float*>(raw + R::kScales);
  for (int i = tid; i < n * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int c = 4 * (i - r * kQuads);
    if (c >= hd) continue;
    const signed char* k = reinterpret_cast<const signed char*>(raw + r * R::kKRow) + c;
    const signed char* v = reinterpret_cast<const signed char*>(raw + R::kV + r * R::kVRow) + c;
    float* kd = reinterpret_cast<float*>(out + r * F::kKRow) + c;
    float* vd = reinterpret_cast<float*>(out + F::kV + r * F::kVRow) + c;
    const float ks = scales[r];
    const float vs = scales[kStageTokens + r];
    if (c + 4 <= hd) {
      const char4 k4 = *reinterpret_cast<const char4*>(k);
      const char4 v4 = *reinterpret_cast<const char4*>(v);
      *reinterpret_cast<float4*>(kd) = make_float4((float)k4.x * ks, (float)k4.y * ks,
                                                   (float)k4.z * ks, (float)k4.w * ks);
      *reinterpret_cast<float4*>(vd) = make_float4((float)v4.x * vs, (float)v4.y * vs,
                                                   (float)v4.z * vs, (float)v4.w * vs);
    } else {
      for (int e = 0; c + e < hd; ++e) {
        kd[e] = (float)k[e] * ks;
        vd[e] = (float)v[e] * vs;
      }
    }
  }
}

// Scores of a stage's (beam, position) pairs into sc_s[b][t], from the
// stage's fp32 K rows: this thread's position t = tid % kStageTokens, its
// beams tid / kStageTokens + j * (kThreads / kStageTokens), four at a
// time, the K row read once for the four. Positions past the stage's n
// take no part in the softmax (-inf); positions past seq_len score -1e9,
// inside it.
template <int HD>
__device__ __forceinline__ void stage_scores(const unsigned char* stage, const float* q_s,
                                             float* sc_s, int Kb, int t0, int n, int seq_len,
                                             float scale, int tid) {
  using F = Stage<float, HD>;
  constexpr int kPosStride = kThreads / kStageTokens;  // beams between a thread's pairs
  const int t = tid % kStageTokens;
  const float* krow = reinterpret_cast<const float*>(stage + t * F::kKRow);
  for (int g0 = tid / kStageTokens; g0 < Kb; g0 += 4 * kPosStride) {
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < n) {
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int b = g0 + g * kPosStride;
          if (b < Kb) {
            const float4 q4 = *reinterpret_cast<const float4*>(q_s + b * HD + d);
            dot[g] = fmaf(q4.x, k4.x, dot[g]);
            dot[g] = fmaf(q4.y, k4.y, dot[g]);
            dot[g] = fmaf(q4.z, k4.z, dot[g]);
            dot[g] = fmaf(q4.w, k4.w, dot[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int b = g0 + g * kPosStride;
      if (b < Kb)
        sc_s[b * kScRow + t] = t >= n ? -INFINITY : (t0 + t >= seq_len ? kNeg : dot[g] * scale);
    }
  }
}

__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The running (m, l, acc) of a block's beams, a half-warp a beam: beam
// b = 2 * warp + half + kHalves * j owns slot j. Each stage, the half-warp
// takes one max and one sum over its beam's scores (4 positions a lane),
// turns the scores into weights in place, then runs e.V over the stage's
// positions with its 16 lanes across head_dim (4 floats a lane at hd 64)
// and the weight broadcast from shared memory: a loop with no branch and
// no dependent load, the accumulators in registers.
template <int HD>
struct HalfWarpBeams {
  static constexpr int kHalves = 2 * kWarps;
  static constexpr int kSlots = kMaxBeams / kHalves;
  static constexpr int kLane = HD / 16;  // head_dim elements a lane owns
  static constexpr int kPer = kStageTokens / 16;  // positions a lane reduces
  static constexpr int kVRow = Stage<float, HD>::kVRow;
  float m[kSlots], l[kSlots], acc[kSlots][kLane];
  int hw, hl;  // the half-warp, the lane in it

  __device__ __forceinline__ explicit HalfWarpBeams(int tid) : hw(tid >> 4), hl(tid & 15) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
#pragma unroll
      for (int w = 0; w < kLane; ++w) acc[j][w] = 0.f;
    }
  }

  // Some beam of this thread's is still within kSkipMargin of -1e9.
  __device__ __forceinline__ bool low(int Kb) const {
    bool r = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (hw + kHalves * j < Kb && m[j] <= kNeg + kSkipMargin) r = true;
    return r;
  }

  __device__ __forceinline__ void stage(float* sc_s, const unsigned char* vrows, int n,
                                        int Kb) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (kHalves * j >= Kb) continue;  // uniform: every lane takes part in the shuffles
      const int b = hw + kHalves * j;
      float* row = sc_s + min(b, Kb - 1) * kScRow;
      float x[kPer];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        x[k] = row[hl + 16 * k];
        mx = fmaxf(mx, x[k]);
      }
      const float m_new = fmaxf(m[j], half_max(mx));
      const float corr = expf(m[j] - m_new);  // 0 on the first stage
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        x[k] = expf(x[k] - m_new);
        sum += x[k];
      }
      sum = half_sum(sum);
      if (b < Kb) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) row[hl + 16 * k] = x[k];
        l[j] = l[j] * corr + sum;
        m[j] = m_new;
#pragma unroll
        for (int w = 0; w < kLane; ++w) acc[j][w] *= corr;
      }
    }
    __syncwarp();  // a half-warp reads back only its own beam's weights
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = hw + kHalves * j;
      if (b < Kb) {
        const float* e = sc_s + b * kScRow;
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
          float v[kLane];
          lane_floats<kLane>(reinterpret_cast<const float*>(vrows + t * kVRow), hl, v);
          const float et = e[t];
#pragma unroll
          for (int w = 0; w < kLane; ++w) acc[j][w] = fmaf(et, v[w], acc[j][w]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Params& p, int s, int h, int b_lo,
                                        int Kb) const {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = hw + kHalves * j;
      if (b < Kb) {
        const size_t o = (size_t)(s * p.K + b_lo + b) * p.H + h;
#pragma unroll
        for (int w = 0; w < kLane; ++w) {
          const int d = hl * kLane + w;
          if (d < p.hd) p.acc[o * p.hd + d] = acc[j][w];
        }
        if (hl == 0) {
          p.m[o] = m[j];
          p.l[o] = l[j];
        }
      }
    }
  }
};

template <int HD>
using Beams = HalfWarpBeams<HD>;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_stats_kernel(const Params p) {
  using L = Stage<T, HD>;
  using F = Stage<float, HD>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b_lo = blockIdx.z * p.beams_per_block;
  const int Kb = min(p.K - b_lo, p.beams_per_block);
  if (Kb <= 0) return;
  const int tid = threadIdx.x;

  float* q_s = reinterpret_cast<float*>(smem);  // [Kb][HD], zero past hd
  float* sc_s = q_s + Kb * HD;                   // [Kb][kScRow] scores, then weights
  unsigned char* ring = reinterpret_cast<unsigned char*>(sc_s + Kb * kScRow);
  // int8: the landed stage dequantised, as fp32 rows
  unsigned char* deq = ring + p.stages * L::kBytes;
  int* pages = reinterpret_cast<int*>(deq + (L::kInt8 ? F::kBytes : 0));  // [Pm], clamped

  // The slot's block-table row and seq_len: one round trip, before any copy.
  for (int i = tid; i < p.Pm; i += kThreads)
    pages[i] = min(max(p.block_tables[(size_t)s * p.Pm + i], 0), p.P - 1);
  const int cap = p.Pm * p.page;
  const int seq_len = p.seq_lens[s];
  const int n_live = seq_len > 0 ? min(seq_len, cap) : cap;
  __syncthreads();

  // Pass 0 walks the live positions [0, n_live); pass 1, taken only when
  // some beam's max is still within kSkipMargin of -1e9, the rest.
  int begin = 0, end = n_live;
  int nst = (end - begin + kStageTokens - 1) / kStageTokens;
  for (int st = 0; st < p.stages; ++st) {
    if (st < nst)
      issue_stage<T, HD>(ring + st * L::kBytes, p, pages, h, begin + st * kStageTokens,
                         min(kStageTokens, end - begin - st * kStageTokens), tid);
    cp_async_commit();
  }

  // While the copies fly: q into shared memory, and the columns past hd
  // of the fp32 K rows the dot reads zeroed (no copy writes them; the dot
  // runs over all HD).
  for (int i = tid; i < Kb * HD; i += kThreads) {
    const int b = i / HD;
    const int d = i - b * HD;
    q_s[i] = d < p.hd ? p.q[((size_t)(s * p.K + b_lo + b) * p.H + h) * p.hd + d] : 0.f;
  }
  if (p.hd < HD) {
    unsigned char* rows = L::kInt8 ? deq : ring;
    const int bufs = L::kInt8 ? 1 : p.stages;
    const int buf_bytes = L::kInt8 ? F::kBytes : L::kBytes;
    const int pad = HD - p.hd;
    for (int i = tid; i < bufs * kStageTokens * pad; i += kThreads) {
      const int r = i / pad;
      reinterpret_cast<float*>(rows + (r / kStageTokens) * buf_bytes +
                               (r % kStageTokens) * F::kKRow)[p.hd + i - r * pad] = 0.f;
    }
  }

  Beams<HD> beams(tid);

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (!__syncthreads_or(beams.low(Kb)) || n_live == cap) break;
      begin = n_live;
      end = cap;
      nst = (end - begin + kStageTokens - 1) / kStageTokens;
      for (int st = 0; st < p.stages; ++st) {
        if (st < nst)
          issue_stage<T, HD>(ring + st * L::kBytes, p, pages, h, begin + st * kStageTokens,
                             min(kStageTokens, end - begin - st * kStageTokens), tid);
        cp_async_commit();
      }
    }

    for (int st = 0; st < nst; ++st) {
      cp_async_wait(p.stages - 1);
      __syncthreads();  // every thread's copies of stage st have landed
      unsigned char* stage = ring + (st % p.stages) * L::kBytes;
      const int t0 = begin + st * kStageTokens;
      const int n = min(kStageTokens, end - t0);

      const unsigned char* rows = stage;  // the stage as fp32 rows
      if constexpr (L::kInt8) {
        dequantize_stage<HD>(stage, deq, n, p.hd, tid);
        __syncthreads();
        rows = deq;
      }

      stage_scores<HD>(rows, q_s, sc_s, Kb, t0, n, seq_len, p.scale, tid);
      __syncthreads();

      beams.stage(sc_s, rows + F::kV, n, Kb);
      __syncthreads();  // stage and scores consumed
      if (st + p.stages < nst)
        issue_stage<T, HD>(stage, p, pages, h, t0 + p.stages * kStageTokens,
                           min(kStageTokens, end - t0 - p.stages * kStageTokens), tid);
      cp_async_commit();
    }
  }

  beams.store(p, s, h, b_lo, Kb);
}

template <typename T, int HD>
int ring_stages(int page, int Pm) {
  const int need = (Pm * page + kStageTokens - 1) / kStageTokens;
  const int fit = max(2, min(kMaxStages, kRingBytes / Stage<T, HD>::kBytes));
  return max(1, min(need, fit));
}

// Dynamic shared memory of a block: q, the scores, the ring, for int8 one
// stage of dequantised rows, the slot's block-table row.
template <typename T, int HD>
size_t block_smem(int beams, int stages, int Pm) {
  return (size_t)beams * (HD + kScRow) * 4 + (size_t)stages * Stage<T, HD>::kBytes +
         (Stage<T, HD>::kInt8 ? Stage<float, HD>::kBytes : 0) + (size_t)Pm * 4;
}

template <typename T, int HD>
int launch_hd(Params p, int S, cudaStream_t stream) {
  p.stages = ring_stages<T, HD>(p.page, p.Pm);
  const size_t smem = block_smem<T, HD>(p.beams_per_block, p.stages, p.Pm);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_stats_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, p.H, (p.K + p.beams_per_block - 1) / p.beams_per_block);
  paged_attention_stats_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Params p, int S, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || p.H == 0) return 0;
  p.beams_per_block = min(p.K, kMaxBeams);
  const int row_bytes = p.hd * (int)sizeof(T);
  const uintptr_t pools =
      reinterpret_cast<uintptr_t>(p.k_pool) | reinterpret_cast<uintptr_t>(p.v_pool);
  p.copy_bytes = row_bytes % 16 == 0 && pools % 16 == 0 ? 16
                 : row_bytes % 4 == 0 && pools % 4 == 0 ? 4
                                                         : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.hd <= 32) return launch_hd<T, 32>(p, S, st);
  if (p.hd <= 64) return launch_hd<T, 64>(p, S, st);
  return launch_hd<T, 128>(p, S, st);
}

// ---- The bf16-q kernel: B1 over bf16 pages, B2 over int8 pages -------------

constexpr int kMmaRows = 16;  // nodes a tile: the M of the m16n8k16 mma
constexpr int kMmaWarps = 4;  // warps holding tiles, at most: each walks its tiles in turn
// Nodes a block at most while the slot's positions fit the ring (each
// warp then takes several tiles, the stage loaded once), and when they
// stream through it (a tile a warp).
constexpr int kMmaNodes = 128;
constexpr int kMmaStreamNodes = kMmaRows * kMmaWarps;
constexpr int kMmaRingBytes = 72 * 1024;  // the raw ring streams in stages past this
constexpr int kEPlanes = 3;  // bf16 planes of e in e.V: hi + mid + lo carry all 24 bits

// Warps a block at least: all issue the copies. An hd-128 warp holds 64
// accumulators a lane, so four would leave COBRA's two-warp blocks two an
// SM instead of four.
__host__ __device__ constexpr int mma_min_warps(int hd) { return hd > 64 ? 2 : 4; }
// Blocks an SM that __launch_bounds__ asks for: at hd <= 64 four blocks
// of four warps over bf16 pages (128 registers a thread: TIGER's 384
// blocks in one wave, 16 warps an SM over the tree), three over int8
// pages (170: at 128 the int8 conversions spill); at hd 128 ptxas is free
// to 255. None spills.
__host__ __device__ constexpr int mma_min_blocks(int hd, bool int8) {
  return hd > 64 ? 1 : int8 ? 3 : 4;
}

// The mma kernel's parameters: the others' with a bf16 q and the ring's rows.
struct MmaParams : Params {
  const __nv_bfloat16* q_bf16;
  int q_units;    // q's rows by 16-byte copies (hd a multiple of 8, q aligned)
  int ring_rows;  // positions the ring holds: the capacity rounded up to 16, or stages * 64
};

// Tiles a block holds, the warps that hold them, and the tile buffers a
// warp has: one a tile it walks, every tile's q copied as the block
// starts.
struct MmaBlock {
  int tiles, node_warps, bufs;
  __host__ __device__ explicit MmaBlock(int nodes)
      : tiles(nodes / kMmaRows),
        node_warps(tiles < kMmaWarps ? tiles : kMmaWarps),
        bufs((tiles + node_warps - 1) / node_warps) {}
};

// Shared memory of a block for pages of type Page (__nv_bfloat16 or
// int8_t) at head width HD: the raw ring's K rows, then its V rows (for
// int8 then the K and V row scales), then the tile buffers of the node
// warps (a tile's 16 bf16 q rows as its walk starts, then its fp32 acc
// rows, 8 at a time: the same bytes), then the masked V rows' sum (the
// rescue's), then the slot's block-table row.
template <typename Page, int HD>
struct RawRing {
  static constexpr bool kInt8 = std::is_same<Page, int8_t>::value;
  static constexpr int kRowBytes = HD * (int)sizeof(Page);
  static constexpr int kRow = kRowBytes + 16;  // ldmatrix: 8 rows hit 8 distinct 4-bank groups
  static constexpr int kUnits = kRowBytes / 16;
  static constexpr int kQRow = 2 * HD + 16;  // a tile's q rows (bf16)
  static constexpr int kORow = HD + 8;  // its fp32 acc rows, in floats
  static constexpr int kTile = kMmaRows * kQRow;  // = 8 acc rows
  static_assert(kTile == 8 * kORow * 4, "a tile buffer holds 16 q rows or 8 acc rows");
  static __host__ __device__ int bytes(int rows) { return 2 * rows * kRow + (kInt8 ? 8 * rows : 0); }
  static __host__ __device__ int tiles(int rows) { return (bytes(rows) + 15) / 16 * 16; }
  static __host__ __device__ int vsum(int rows, const MmaBlock& b) {
    return tiles(rows) + b.node_warps * b.bufs * kTile;
  }
  static size_t smem(int rows, const MmaBlock& b, int Pm) {
    return (size_t)vsum(rows, b) + HD * 4 + (size_t)Pm * 4;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8; r[i]
// is the lane's part of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a . b on a 16 x 8 x 16 tile, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 values of x (bytes lo and hi, each stored xor 0x80) as a bf16
// pair, exactly: 2^23 + (v + 128) as float bits, less 2^23 + 128, is v;
// an integer of magnitude <= 128 is its own bf16 (the float's top half).
__device__ __forceinline__ uint32_t s8_pair(uint32_t x, int lo, int hi) {
  const float a = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | lo)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | hi)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Where stage slot `slot` of the ring lives: its K rows, V rows, K and V
// row scales (int8).
template <typename Page, int HD>
struct Slot {
  unsigned char* k;
  unsigned char* v;
  float* ks;
  float* vs;
  __device__ __forceinline__ Slot(unsigned char* ring, int rows, int slot) {
    using R = RawRing<Page, HD>;
    const int r0 = slot * kStageTokens;
    k = ring + r0 * R::kRow;
    v = ring + (rows + r0) * R::kRow;
    ks = reinterpret_cast<float*>(ring + 2 * rows * R::kRow) + r0;
    vs = ks + rows;
  }
};

// Issue the copies of positions t0 .. t0 + n - 1 of head h into one stage
// slot (K and V rows; for int8 their row scales), and zero the V rows (and
// scales) from n up to the next multiple of 16: e.V reads whole 16-position
// steps, and their weight 0 times a NaN of never-written shared memory
// would be NaN.
template <typename Page, int HD>
__device__ __forceinline__ void issue_slot(const Slot<Page, HD>& sl, const Params& p,
                                           const int* pages, int h, int t0, int n, int tid,
                                           int nthreads) {
  using R = RawRing<Page, HD>;
  const int row_bytes = p.hd * (int)sizeof(Page);
  for (int i = tid; i < n * R::kUnits; i += nthreads) {
    const int r = i / R::kUnits;
    const int b0 = 16 * (i - r * R::kUnits);
    if (b0 >= row_bytes) continue;
    const int pos = t0 + r;
    const int pi = pos / p.page;
    const size_t row = (((size_t)pages[pi] * p.page + (pos - pi * p.page)) * p.H + h) *
                           (size_t)row_bytes + b0;
    const char* kg = static_cast<const char*>(p.k_pool) + row;
    const char* vg = static_cast<const char*>(p.v_pool) + row;
    unsigned char* kd = sl.k + r * R::kRow + b0;
    unsigned char* vd = sl.v + r * R::kRow + b0;
    if (p.copy_bytes == 16) {
      cp_async_16(kd, kg);
      cp_async_16(vd, vg);
    } else if (p.copy_bytes == 4) {
      for (int w = 0; w < 16 && b0 + w < row_bytes; w += 4) {
        cp_async_4(kd + w, kg + w);
        cp_async_4(vd + w, vg + w);
      }
    } else {
      for (int w = 0; w < 16 && b0 + w < row_bytes; ++w) {
        kd[w] = kg[w];
        vd[w] = vg[w];
      }
    }
  }
  const int n16 = min(kStageTokens, (n + 15) & ~15);
  for (int i = tid; i < (n16 - n) * R::kUnits; i += nthreads)
    *reinterpret_cast<uint4*>(sl.v + (n + i / R::kUnits) * R::kRow + 16 * (i % R::kUnits)) =
        make_uint4(0u, 0u, 0u, 0u);
  if constexpr (R::kInt8) {
    for (int r = tid; r < n16; r += nthreads) {
      if (r < n) {
        const int pos = t0 + r;
        const int pi = pos / p.page;
        const size_t row_at = (size_t)pages[pi] * p.page + (pos - pi * p.page);
        cp_async_4(sl.ks + r, p.k_scale + row_at);
        cp_async_4(sl.vs + r, p.v_scale + row_at);
      } else {
        sl.ks[r] = sl.vs[r] = 0.f;
      }
    }
  }
}

// The running (m, l, acc) of a warp's 16 nodes, in mma fragments: lane
// (g, c) = (lane / 4, lane % 4) holds rows g and g + 8 of the tile, and
// of each 8-column tile the columns 2c and 2c + 1.
template <typename Page, int HD>
struct WarpTile {
  using R = RawRing<Page, HD>;
  static constexpr int kSTiles = kStageTokens / 8;  // score tiles of a stage
  const unsigned char* q_s;  // the warp's q rows in shared memory, zero past hd and Kb
  float o[HD / 8][4];  // acc; int8: tiles 2j, 2j + 1 the even, odd columns of 16j .. 16j + 15
  float m[2], l[2];
  int g, c;

  __device__ __forceinline__ WarpTile(const unsigned char* tile, int lane)
      : q_s(tile), g(lane >> 2), c(lane & 3) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Some node of this thread's is still within kSkipMargin of -1e9.
  __device__ __forceinline__ bool low(int row0, int Kb) const {
    return (row0 + g < Kb && m[0] <= kNeg + kSkipMargin) ||
           (row0 + g + 8 < Kb && m[1] <= kNeg + kSkipMargin);
  }

  // q's A fragment of k step kk: k index 2c, 2c + 1 and 2c + 8, 2c + 9 of
  // the step are head_dim 16kk + 2c and 16kk + 8 + 2c; for int8 K (whose
  // ldmatrix hands a lane 4 consecutive bytes) 16kk + 4c and 16kk + 4c + 2.
  __device__ __forceinline__ void q_frag(int kk, uint32_t (&a)[4]) const {
    const int d0 = 16 * kk + (R::kInt8 ? 4 * c : 2 * c);
    const int d1 = d0 + (R::kInt8 ? 2 : 8);
    const unsigned char* r0 = q_s + g * R::kQRow;
    const unsigned char* r1 = r0 + 8 * R::kQRow;
    a[0] = *reinterpret_cast<const uint32_t*>(r0 + 2 * d0);
    a[1] = *reinterpret_cast<const uint32_t*>(r1 + 2 * d0);
    a[2] = *reinterpret_cast<const uint32_t*>(r0 + 2 * d1);
    a[3] = *reinterpret_cast<const uint32_t*>(r1 + 2 * d1);
  }

  // One stage: positions t0 .. t0 + n - 1 in slot sl.
  __device__ __forceinline__ void stage(const Slot<Page, HD>& sl, int t0, int n, int seq_len,
                                        float scale, int lane) {
    const int mi = lane >> 3, rr = lane & 7;
    float sc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    // Scores, a k step at a time: bf16 K by ldmatrix two score tiles at a
    // time (16 positions), int8 K four (32), over the positions < n.
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      q_frag(kk, a);
      if constexpr (R::kInt8) {
#pragma unroll
        for (int j4 = 0; j4 < kSTiles / 4; ++j4) {
          if (32 * j4 >= n) continue;  // uniform
          uint32_t r[4];
          ldsm_x4(r, sl.k + (32 * j4 + 8 * mi + rr) * R::kRow + 16 * kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t x = r[e] ^ 0x80808080u;
            mma_16816(sc[4 * j4 + e], a, s8_pair(x, 0, 1), s8_pair(x, 2, 3));
          }
        }
      } else {
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          if (16 * j2 >= n) continue;  // uniform
          uint32_t r[4];  // tile 2j2: columns 16kk .. +7, +8 .. +15; then tile 2j2 + 1
          ldsm_x4(r, sl.k + (16 * j2 + 8 * (mi >> 1) + rr) * R::kRow + 2 * (16 * kk + 8 * (mi & 1)));
          mma_16816(sc[2 * j2], a, r[0], r[1]);
          mma_16816(sc[2 * j2 + 1], a, r[2], r[3]);
        }
      }
    }
    // Tiles past the stage's positions (8j >= n) take no part: their
    // weights are 0.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      if (8 * j >= n) continue;  // uniform
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + 2 * c + (e & 1);
        float v = sc[j][e];
        if constexpr (R::kInt8) v *= sl.ks[t];
        v = t >= n ? -INFINITY : (t0 + t >= seq_len ? kNeg : v * scale);
        sc[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);  // 0 on the first stage
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      if (8 * j >= n) {  // uniform
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        sum[e >> 1] += sc[j][e];
        if constexpr (R::kInt8) sc[j][e] *= sl.vs[8 * j + 2 * c + (e & 1)];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= corr[0], o[j][1] *= corr[0];
      o[j][2] *= corr[1], o[j][3] *= corr[1];
    }
    // e.V, 16 positions a step: the weights of score tiles 2kt and 2kt + 1
    // are the A fragment, register for register, as kEPlanes bf16 planes.
#pragma unroll
    for (int kt = 0; kt < kStageTokens / 16; ++kt) {
      if (16 * kt >= n) continue;  // uniform
      uint32_t a[kEPlanes][4];
      float w[8] = {sc[2 * kt][0], sc[2 * kt][1], sc[2 * kt][2], sc[2 * kt][3],
                    sc[2 * kt + 1][0], sc[2 * kt + 1][1], sc[2 * kt + 1][2], sc[2 * kt + 1][3]};
#pragma unroll
      for (int pl = 0; pl < kEPlanes; ++pl) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
          a[pl][i] = *reinterpret_cast<const uint32_t*>(&b);
          const float2 back = __bfloat1622float2(b);
          w[2 * i] -= back.x;  // exact: b is w rounded
          w[2 * i + 1] -= back.y;
        }
      }
      const unsigned char* vrow = sl.v + (16 * kt + 8 * (mi & 1) + rr) * R::kRow;
      if constexpr (R::kInt8) {
#pragma unroll
        for (int dq = 0; dq < HD / 32; ++dq) {
          uint32_t r[4];  // positions 0-7 and 8-15 of bytes 32dq .. +15, then of +16 .. +31
          ldsm_x4_trans(r, vrow + 32 * dq + 16 * (mi >> 1));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t x0 = r[2 * half] ^ 0x80808080u, x1 = r[2 * half + 1] ^ 0x80808080u;
            const uint32_t e0 = s8_pair(x0, 0, 2), e1 = s8_pair(x1, 0, 2);  // even columns
            const uint32_t d0 = s8_pair(x0, 1, 3), d1 = s8_pair(x1, 1, 3);  // odd columns
#pragma unroll
            for (int pl = 0; pl < kEPlanes; ++pl) {
              mma_16816(o[4 * dq + 2 * half], a[pl], e0, e1);
              mma_16816(o[4 * dq + 2 * half + 1], a[pl], d0, d1);
            }
          }
        }
      } else {
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t r[4];  // positions 0-7 and 8-15 of columns 16dn .. +7, then of +8 .. +15
          ldsm_x4_trans(r, vrow + 2 * (16 * dn + 8 * (mi >> 1)));
#pragma unroll
          for (int pl = 0; pl < kEPlanes; ++pl) {
            mma_16816(o[2 * dn], a[pl], r[0], r[1]);
            mma_16816(o[2 * dn + 1], a[pl], r[2], r[3]);
          }
        }
      }
    }
  }

  // acc through the tile's buffer (its q rows are spent), 8 rows at a
  // time, into whole rows, 16 bytes a lane; m and l by the quad's first
  // lane.
  __device__ __forceinline__ void store(const Params& p, float* tile, int s, int h, int b_lo,
                                        int row0, int Kb, int lane) const {
    const bool vec = p.hd % 4 == 0;
    const int units = (p.hd + 3) / 4;  // 4 columns a unit
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g + 8r
      float* row = tile + g * R::kORow;
      __syncwarp();  // the buffer's last reads are done
      if constexpr (R::kInt8) {
#pragma unroll
        for (int j = 0; j < HD / 16; ++j)  // columns 16j + 4c .. +3: even, odd, even, odd tiles
          *reinterpret_cast<float4*>(row + 16 * j + 4 * c) =
              make_float4(o[2 * j][2 * r], o[2 * j + 1][2 * r], o[2 * j][2 * r + 1],
                          o[2 * j + 1][2 * r + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * c) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
      const int b = row0 + g + 8 * r;
      if (c == 0 && b < Kb) {
        const size_t at = (size_t)(s * p.K + b_lo + b) * p.H + h;
        p.m[at] = m[r];
        p.l[at] = l[r];
      }
      __syncwarp();
      for (int i = lane; i < 8 * units; i += 32) {
        const int rw = i / units;
        const int d = 4 * (i - rw * units);
        if (row0 + 8 * r + rw >= Kb) break;
        const float* src = tile + rw * R::kORow + d;
        float* dst = p.acc + ((size_t)(s * p.K + b_lo + row0 + 8 * r + rw) * p.H + h) * p.hd + d;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
          for (int e = 0; e < 4 && d + e < p.hd; ++e) dst[e] = src[e];
        }
      }
    }
  }
};

// The warp's q rows into its tile: bf16, zero past hd and past the block's
// nodes; by 16-byte copies where rows and q allow.
template <typename Page, int HD>
__device__ __forceinline__ void stage_q(unsigned char* tile, const MmaParams& p, int s, int h,
                                        int b_lo, int row0, int Kb, int lane) {
  using R = RawRing<Page, HD>;
  constexpr int kUnitsQ = HD / 8;  // 16-byte units of a row
  for (int i = lane; i < kMmaRows * kUnitsQ; i += 32) {
    const int rw = i / kUnitsQ;
    const int d = 8 * (i - rw * kUnitsQ);
    unsigned char* dst = tile + rw * R::kQRow + 2 * d;
    const __nv_bfloat16* src =
        p.q_bf16 + ((size_t)(s * p.K + b_lo + row0 + rw) * p.H + h) * p.hd + d;
    if (row0 + rw < Kb && d < p.hd && p.q_units) {
      cp_async_16(dst, src);
    } else {
      uint32_t v[4];
      for (int e = 0; e < 4; ++e) {
        const bool in = row0 + rw < Kb;
        const uint32_t lo = in && d + 2 * e < p.hd ? __bfloat16_as_ushort(src[2 * e]) : 0u;
        const uint32_t hi = in && d + 2 * e + 1 < p.hd ? __bfloat16_as_ushort(src[2 * e + 1]) : 0u;
        v[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The rows of the block whose max is still within kSkipMargin of -1e9
// take the positions past the live ones: each scores exactly -1e9, so a
// row adds exp(-1e9 - m') times the masked V rows' sum to acc and (cap -
// live) times it to l, m' = max(m, -1e9), after rescaling by exp(m - m').
// Rows above the margin would add exactly 0 (exp underflows) and are left
// as stored. The sum streams the masked rows through the ring's first
// slot, each thread summing its columns in position order.
template <typename Page, int HD>
__device__ __forceinline__ void rescue(const MmaParams& p, unsigned char* ring, float* vsum,
                                    const int* pages, int s, int h, int b_lo, int Kb, int live,
                                    int cap, int tid, int nthreads) {
  using R = RawRing<Page, HD>;
  const Slot<Page, HD> sl(ring, p.ring_rows, 0);
  const int chunk = min(kStageTokens, p.ring_rows);
  for (int d = tid; d < HD; d += nthreads) vsum[d] = 0.f;
  for (int t0 = live; t0 < cap; t0 += chunk) {
    const int n = min(chunk, cap - t0);
    issue_slot<Page, HD>(sl, p, pages, h, t0, n, tid, nthreads);
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    for (int d = tid; d < p.hd; d += nthreads) {
      float sum = vsum[d];
      for (int r = 0; r < n; ++r) {
        const Page* row = reinterpret_cast<const Page*>(sl.v + r * R::kRow);
        if constexpr (R::kInt8)
          sum += (float)row[d] * sl.vs[r];
        else
          sum += __bfloat162float(row[d]);
      }
      vsum[d] = sum;
    }
    __syncthreads();
  }
  const int lane = tid & 31;
  for (int b = tid >> 5; b < Kb; b += nthreads >> 5) {
    const size_t at = (size_t)(s * p.K + b_lo + b) * p.H + h;
    const float mb = p.m[at];
    if (mb > kNeg + kSkipMargin) continue;  // uniform in the warp
    const float m_new = fmaxf(mb, kNeg);
    const float corr = expf(mb - m_new);
    const float e = expf(kNeg - m_new);
    float* acc = p.acc + at * p.hd;
    for (int d = lane; d < p.hd; d += 32) acc[d] = acc[d] * corr + e * vsum[d];
    __syncwarp();  // every lane has read m before it changes
    if (lane == 0) {
      p.l[at] = p.l[at] * corr + (float)(cap - live) * e;
      p.m[at] = m_new;
    }
  }
}

template <typename Page, int HD>
__global__ void __launch_bounds__(32 * (kMmaWarps > mma_min_warps(HD) ? kMmaWarps
                                                                      : mma_min_warps(HD)),
                                  mma_min_blocks(HD, std::is_same<Page, int8_t>::value))
paged_attention_mma_kernel(const MmaParams p) {
  using R = RawRing<Page, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaBlock blk(p.beams_per_block);
  unsigned char* ring = smem;
  float* vsum = reinterpret_cast<float*>(smem + R::vsum(p.ring_rows, blk));
  int* pages = reinterpret_cast<int*>(vsum + HD);  // [Pm], clamped

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b_lo = blockIdx.z * p.beams_per_block;
  const int Kb = min(p.K - b_lo, p.beams_per_block);
  if (Kb < 1) return;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles = (Kb + kMmaRows - 1) / kMmaRows;  // the block's tiles
  // Tile buffer b of this warp (node warps only).
  const auto buf = [&](int b) {
    return smem + R::tiles(p.ring_rows) + (warp * blk.bufs + b) * R::kTile;
  };

  for (int i = tid; i < p.Pm; i += nthreads)
    pages[i] = min(max(p.block_tables[(size_t)s * p.Pm + i], 0), p.P - 1);
  const int cap = p.Pm * p.page;
  const int seq_len = p.seq_lens[s];
  const int live = seq_len > 0 ? min(seq_len, cap) : cap;
  __syncthreads();

  // The warp's first tile, if it holds tiles (t = warp, warp +
  // node_warps, ...); helper warps only copy. The q rows of every tile of
  // the warp's, then the live positions' stages.
  const int first = warp < blk.node_warps ? warp : tiles;
  for (int t = first, i = 0; t < tiles; t += blk.node_warps, ++i)
    stage_q<Page, HD>(buf(i), p, s, h, b_lo, kMmaRows * t, Kb, lane);
  const int nst = (live + kStageTokens - 1) / kStageTokens;
  for (int st = 0; st < p.stages; ++st) {
    if (st < nst)
      issue_slot<Page, HD>(Slot<Page, HD>(ring, p.ring_rows, st), p, pages, h,
                           st * kStageTokens, min(kStageTokens, live - st * kStageTokens), tid,
                           nthreads);
    cp_async_commit();
  }
  // While the copies fly: the K columns past hd zeroed in every slot (no
  // copy writes them; q.k runs over all HD).
  const int row_bytes = p.hd * (int)sizeof(Page);
  if (row_bytes < R::kRowBytes) {
    const int pad = R::kRowBytes - row_bytes;
    for (int i = tid; i < p.ring_rows * pad; i += nthreads) {
      const int r = i / pad;
      ring[r * R::kRow + row_bytes + (i - r * pad)] = 0;
    }
  }

  bool low = false;
  if (nst <= p.stages) {
    // Every live position is in the ring: each node warp walks its tiles
    // in turn.
    cp_async_wait(0);
    __syncthreads();
    for (int t = first, i = 0; t < tiles; t += blk.node_warps, ++i) {
      WarpTile<Page, HD> acc(buf(i), lane);
      for (int st = 0; st < nst; ++st)
        acc.stage(Slot<Page, HD>(ring, p.ring_rows, st), st * kStageTokens,
                  min(kStageTokens, live - st * kStageTokens), seq_len, p.scale, lane);
      low |= acc.low(kMmaRows * t, Kb);
      acc.store(p, reinterpret_cast<float*>(buf(i)), s, h, b_lo, kMmaRows * t, Kb, lane);
    }
  } else {
    // The live positions stream through the ring: a tile a node warp.
    const bool rows_in = first < tiles;  // uniform in the warp
    WarpTile<Page, HD> acc(buf(0), lane);
    for (int st = 0; st < nst; ++st) {
      cp_async_wait(p.stages - 1);  // this thread's copies of stage st
      __syncthreads();  // and every other thread's
      const Slot<Page, HD> sl(ring, p.ring_rows, st % p.stages);
      const int t0 = st * kStageTokens;
      const int n = min(kStageTokens, live - t0);
      if (rows_in) acc.stage(sl, t0, n, seq_len, p.scale, lane);
      __syncthreads();  // the stage consumed
      if (st + p.stages < nst)
        issue_slot<Page, HD>(sl, p, pages, h, t0 + p.stages * kStageTokens,
                             min(kStageTokens, live - t0 - p.stages * kStageTokens), tid,
                             nthreads);
      cp_async_commit();
    }
    if (rows_in) {
      low = acc.low(kMmaRows * warp, Kb);
      acc.store(p, reinterpret_cast<float*>(buf(0)), s, h, b_lo, kMmaRows * warp, Kb, lane);
    }
  }
  // __syncthreads_or also makes every warp's stores visible to the block.
  if (__syncthreads_or(low) && live < cap)
    rescue<Page, HD>(p, ring, vsum, pages, s, h, b_lo, Kb, live, cap, tid, nthreads);
}

// Stages of the ring: every stage of a slot's capacity while they fit in
// kMmaRingBytes (then the ring holds the capacity rounded up to 16
// positions), else as many 64-position stages as fit, streaming.
template <typename Page, int HD>
void mma_ring(int page, int Pm, int* stages, int* rows) {
  using R = RawRing<Page, HD>;
  const int cap = Pm * page;
  const int need = (cap + kStageTokens - 1) / kStageTokens;
  const int fit = max(1, min(kMaxStages, kMmaRingBytes / R::bytes(kStageTokens)));
  *stages = max(1, min(need, fit));
  *rows = *stages == need ? (cap + 15) / 16 * 16 : *stages * kStageTokens;
}

// Nodes a block: K spread evenly over the fewest blocks of at most
// kMmaNodes nodes (kMmaStreamNodes when the positions stream), in whole
// tiles of kMmaRows.
int mma_nodes_per_block(int K, bool streams) {
  const int most = streams ? kMmaStreamNodes : kMmaNodes;
  const int blocks = (K + most - 1) / most;
  const int per = (K + blocks - 1) / blocks;
  return (per + kMmaRows - 1) / kMmaRows * kMmaRows;
}

template <int HD>
int mma_threads(int nodes) { return 32 * max(MmaBlock(nodes).node_warps, mma_min_warps(HD)); }

// The launch's ring, nodes a block and dynamic shared memory.
template <typename Page, int HD>
size_t mma_setup(MmaParams& p) {
  mma_ring<Page, HD>(p.page, p.Pm, &p.stages, &p.ring_rows);
  p.beams_per_block = mma_nodes_per_block(p.K, p.stages * kStageTokens < p.Pm * p.page);
  return RawRing<Page, HD>::smem(p.ring_rows, MmaBlock(p.beams_per_block), p.Pm);
}

template <typename Page, int HD>
int launch_mma_hd(MmaParams p, int S, cudaStream_t stream) {
  const size_t smem = mma_setup<Page, HD>(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_mma_kernel<Page, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, p.H, (p.K + p.beams_per_block - 1) / p.beams_per_block);
  paged_attention_mma_kernel<Page, HD><<<grid, mma_threads<HD>(p.beams_per_block), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Page>
int launch_mma(const Params& base, int S, void* stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || base.H == 0) return 0;
  MmaParams p{};
  static_cast<Params&>(p) = base;
  p.q_bf16 = reinterpret_cast<const __nv_bfloat16*>(base.q);
  const int row_bytes = p.hd * (int)sizeof(Page);
  const uintptr_t pools =
      reinterpret_cast<uintptr_t>(p.k_pool) | reinterpret_cast<uintptr_t>(p.v_pool);
  p.copy_bytes = row_bytes % 16 == 0 && pools % 16 == 0 ? 16
                 : row_bytes % 4 == 0 && pools % 4 == 0 ? 4
                                                         : 1;
  p.q_units = p.hd % 8 == 0 && reinterpret_cast<uintptr_t>(p.q_bf16) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.hd <= 32) return launch_mma_hd<Page, 32>(p, S, st);
  if (p.hd <= 64) return launch_mma_hd<Page, 64>(p, S, st);
  return launch_mma_hd<Page, 128>(p, S, st);
}

Params params(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
              const void* v_scale, const void* block_tables, const void* seq_lens, void* acc,
              void* m, void* l, int K, int H, int hd, int P, int page, int Pm, float scale) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_tables = static_cast<const int*>(block_tables);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.K = K, p.H = H, p.hd = hd, p.P = P, p.page = page, p.Pm = Pm;
  p.scale = scale;
  return p;
}

// A block of the kernel at these shapes: threads, nodes (beams) it holds,
// blocks along z, dynamic shared memory, and blocks an SM can hold on the
// current device (the occupancy calculator, registers included).
int put_shape(const void* kernel, int K, int nodes, int threads, size_t smem, long long* out) {
  out[0] = threads, out[1] = nodes, out[2] = (K + nodes - 1) / nodes, out[3] = (long long)smem;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[4] = blocks;
  return (int)err;
}

template <typename T, int HD>
int fp32q_shape(int K, int page, int Pm, long long* out) {
  const int nodes = min(K, kMaxBeams);
  return put_shape((const void*)paged_attention_stats_kernel<T, HD>, K, nodes, kThreads,
                   block_smem<T, HD>(nodes, ring_stages<T, HD>(page, Pm), Pm), out);
}

template <typename Page, int HD>
int mma_shape(int K, int page, int Pm, long long* out) {
  MmaParams p{};
  p.K = K, p.page = page, p.Pm = Pm;
  const size_t smem = mma_setup<Page, HD>(p);
  return put_shape((const void*)paged_attention_mma_kernel<Page, HD>, K, p.beams_per_block,
                   mma_threads<HD>(p.beams_per_block), smem, out);
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity; K >= 1, hd <= 128); `stream` is the caller's cudaStream_t.
// Each launches on that stream without synchronising and returns
// cudaGetLastError() (0 = ok).
extern "C" int paged_attention_stats_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch<float>(params(q, k_pool, v_pool, nullptr, nullptr, block_tables, seq_lens,
                              acc, m, l, K, H, hd, P, page, Pm, scale),
                       S, stream, device);
}

// B1 over bf16 pools (P, page, H, hd) with a bf16 q: the mma kernel.
extern "C" int paged_attention_stats_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch_mma<__nv_bfloat16>(params(q, k_pool, v_pool, nullptr, nullptr, block_tables,
                                          seq_lens, acc, m, l, K, H, hd, P, page, Pm, scale),
                                   S, stream, device);
}

// B2: int8 pools (P, page, H, hd) with fp32 scales (P, page).
extern "C" int paged_attention_stats_q8(
    const void* q, const void* k_data, const void* k_scale, const void* v_data,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch<int8_t>(params(q, k_data, v_data, k_scale, v_scale, block_tables, seq_lens,
                               acc, m, l, K, H, hd, P, page, Pm, scale),
                        S, stream, device);
}

// B2 with a bf16 q (a bf16 model over int8 pools): the mma kernel.
extern "C" int paged_attention_stats_q8_bf16q(
    const void* q, const void* k_data, const void* k_scale, const void* v_data,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch_mma<int8_t>(params(q, k_data, v_data, k_scale, v_scale, block_tables,
                                   seq_lens, acc, m, l, K, H, hd, P, page, Pm, scale),
                            S, stream, device);
}

// The launch shape of the kernel that serves these shapes (K the query
// axis, beams or tree nodes) over pages and q of `kind`: 0 fp32 pages, 1
// int8 pages (fp32 q), 2 bf16 pages (bf16 q), 3 int8 pages with a bf16 q.
// out[0..4]: threads a block, nodes a block, blocks along z, dynamic
// shared memory a block, blocks an SM on the current device. Returns a
// CUDA error code (0 = ok).
extern "C" int paged_attention_block_shape(int K, int hd, int page, int Pm, int kind,
                                           long long* out) {
  const int w = hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
  if (kind == 0)
    return w == 32   ? fp32q_shape<float, 32>(K, page, Pm, out)
           : w == 64 ? fp32q_shape<float, 64>(K, page, Pm, out)
                     : fp32q_shape<float, 128>(K, page, Pm, out);
  if (kind == 1)
    return w == 32   ? fp32q_shape<int8_t, 32>(K, page, Pm, out)
           : w == 64 ? fp32q_shape<int8_t, 64>(K, page, Pm, out)
                     : fp32q_shape<int8_t, 128>(K, page, Pm, out);
  if (kind == 2)
    return w == 32   ? mma_shape<__nv_bfloat16, 32>(K, page, Pm, out)
           : w == 64 ? mma_shape<__nv_bfloat16, 64>(K, page, Pm, out)
                     : mma_shape<__nv_bfloat16, 128>(K, page, Pm, out);
  return w == 32   ? mma_shape<int8_t, 32>(K, page, Pm, out)
         : w == 64 ? mma_shape<int8_t, 64>(K, page, Pm, out)
                   : mma_shape<int8_t, 128>(K, page, Pm, out);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
