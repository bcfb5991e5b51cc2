// Paged decode attention, flash statistics, for Hopper (sm_90a): over
// float32 or bfloat16 pools (B1) and over int8 pools dequantised in the
// kernel (B2), with a float32 or, where the model computes in bf16, a
// bfloat16 q (B1 over bf16 pages takes a bf16 q, B2 either).
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
// :93-95), so the TPU kernel serves a pool of any float type. Here a
// bfloat16 q or bf16 K/V element is converted exactly to fp32, and for
// int8 pools each element is dequantised, k = float(int8) * scale[page,
// row]; then the dot, then hd^-0.5, in the plain version's order. No pool
// is ever upcast outside the kernel. (JAX's CPU fallback takes the score
// einsum in the input type, so with bf16 inputs it rounds every score to
// bf16; the port follows the kernel it replaces, not the fallback.)
//
// Bound on an H100: memory. A call must read the K and V rows of the
// positions the result depends on: a slot's first min(seq_len, Pm*page)
// positions, or all Pm*page when seq_len <= 0. At the TIGER serving shape
// (S 64, K 10, H 6, hd 64, page 16, Pm 4, served histories) that is ~6.5
// MB of fp32 K/V (8.5 MB with q and the outputs: 2.5 us at 3.35 TB/s),
// ~3.3 MB of bf16 K/V (4.7 MB with a bf16 q and the fp32 outputs: 1.4 us),
// or ~1.6 MB of int8 rows and scales (3.6 MB: 1.1 us). The arithmetic,
// 4*K*H*hd flops a position, is ~0.5 us at the 67 TFLOP/s of fp32 FFMA;
// tensor cores do not apply (fp32, no TF32).
//
// Design (the choices settled by `python3 ce_bwd_ab.py --mode paged`, whose
// variants are text substitutions of this file):
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
//     bf16 pages take the same path with the scale fixed at 1: the raw
//     rows are copied (16 bytes a thread: 8 values), and a landed stage is
//     widened once into fp32 rows (bf16 -> fp32 is exact). From there
//     every page type runs the same math. A bf16 q is widened as it is
//     staged into shared memory.
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
  const void* q;  // float or __nv_bfloat16
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

// Shared-memory layout of one stage for pages of type T (float,
// __nv_bfloat16 or int8_t) at head width HD.
template <typename T, int HD>
struct Stage {
  static constexpr bool kFloat = std::is_same<T, float>::value;  // read as they land
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;  // rows carry a scale
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

// bf16 pages: a landed stage of bf16 rows into fp32 rows, exactly, once
// for all beams (B2's dequantisation with the scale fixed at 1), 8 values
// (16 bytes) an item where the row allows.
template <int HD>
__device__ __forceinline__ void widen_stage(const unsigned char* raw, unsigned char* out,
                                            int n, int hd, int tid) {
  using R = Stage<__nv_bfloat16, HD>;
  using F = Stage<float, HD>;
  constexpr int kOcts = HD / 8;  // 8 elements an item
  for (int i = tid; i < n * kOcts; i += kThreads) {
    const int r = i / kOcts;
    const int c = 8 * (i - r * kOcts);
    if (c >= hd) continue;
    const __nv_bfloat16* k = reinterpret_cast<const __nv_bfloat16*>(raw + r * R::kKRow) + c;
    const __nv_bfloat16* v =
        reinterpret_cast<const __nv_bfloat16*>(raw + R::kV + r * R::kVRow) + c;
    float* kd = reinterpret_cast<float*>(out + r * F::kKRow) + c;
    float* vd = reinterpret_cast<float*>(out + F::kV + r * F::kVRow) + c;
    if (c + 8 <= hd) {  // pairs straight from shared memory (4-byte aligned)
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(k);
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(v);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float2 k0 = __bfloat1622float2(kp[j]), k1 = __bfloat1622float2(kp[j + 1]);
        const float2 v0 = __bfloat1622float2(vp[j]), v1 = __bfloat1622float2(vp[j + 1]);
        *reinterpret_cast<float4*>(kd + 2 * j) = make_float4(k0.x, k0.y, k1.x, k1.y);
        *reinterpret_cast<float4*>(vd + 2 * j) = make_float4(v0.x, v0.y, v1.x, v1.y);
      }
    } else {
      for (int e = 0; c + e < hd; ++e) {
        kd[e] = __bfloat162float(k[e]);
        vd[e] = __bfloat162float(v[e]);
      }
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T, typename TQ, int HD>
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
  // int8 and bf16: the landed stage dequantised (widened), as fp32 rows
  unsigned char* deq = ring + p.stages * L::kBytes;
  int* pages = reinterpret_cast<int*>(deq + (L::kFloat ? 0 : F::kBytes));  // [Pm], clamped

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

  // While the copies fly: q into shared memory (a bf16 q widened to
  // fp32), and the columns past hd of the fp32 K rows the dot reads
  // zeroed (no copy writes them; the dot runs over all HD).
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = tid; i < Kb * HD; i += kThreads) {
    const int b = i / HD;
    const int d = i - b * HD;
    q_s[i] = d < p.hd ? to_float(q[((size_t)(s * p.K + b_lo + b) * p.H + h) * p.hd + d]) : 0.f;
  }
  if (p.hd < HD) {
    unsigned char* rows = L::kFloat ? ring : deq;
    const int bufs = L::kFloat ? p.stages : 1;
    const int buf_bytes = L::kFloat ? L::kBytes : F::kBytes;
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
      if constexpr (!L::kFloat) {
        if constexpr (L::kInt8)
          dequantize_stage<HD>(stage, deq, n, p.hd, tid);
        else
          widen_stage<HD>(stage, deq, n, p.hd, tid);
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

// Dynamic shared memory of a block: q, the scores, the ring, for int8 and
// bf16 pages one stage of dequantised (widened) rows, the slot's
// block-table row.
template <typename T, int HD>
size_t block_smem(int beams, int stages, int Pm) {
  return (size_t)beams * (HD + kScRow) * 4 + (size_t)stages * Stage<T, HD>::kBytes +
         (Stage<T, HD>::kFloat ? 0 : Stage<float, HD>::kBytes) + (size_t)Pm * 4;
}

template <typename T, typename TQ, int HD>
int launch_hd(Params p, int S, cudaStream_t stream) {
  p.stages = ring_stages<T, HD>(p.page, p.Pm);
  const size_t smem = block_smem<T, HD>(p.beams_per_block, p.stages, p.Pm);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_stats_kernel<T, TQ, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, p.H, (p.K + p.beams_per_block - 1) / p.beams_per_block);
  paged_attention_stats_kernel<T, TQ, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TQ>
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
  if (p.hd <= 32) return launch_hd<T, TQ, 32>(p, S, st);
  if (p.hd <= 64) return launch_hd<T, TQ, 64>(p, S, st);
  return launch_hd<T, TQ, 128>(p, S, st);
}

Params params(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
              const void* v_scale, const void* block_tables, const void* seq_lens, void* acc,
              void* m, void* l, int K, int H, int hd, int P, int page, int Pm, float scale) {
  Params p{};
  p.q = q;
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
  return launch<float, float>(params(q, k_pool, v_pool, nullptr, nullptr, block_tables,
                                     seq_lens, acc, m, l, K, H, hd, P, page, Pm, scale),
                              S, stream, device);
}

// B1 over bf16 pools (P, page, H, hd) with a bf16 q.
extern "C" int paged_attention_stats_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      params(q, k_pool, v_pool, nullptr, nullptr, block_tables, seq_lens, acc, m, l, K, H,
             hd, P, page, Pm, scale),
      S, stream, device);
}

// B2: int8 pools (P, page, H, hd) with fp32 scales (P, page).
extern "C" int paged_attention_stats_q8(
    const void* q, const void* k_data, const void* k_scale, const void* v_data,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch<int8_t, float>(params(q, k_data, v_data, k_scale, v_scale, block_tables,
                                      seq_lens, acc, m, l, K, H, hd, P, page, Pm, scale),
                               S, stream, device);
}

// B2 with a bf16 q (a bf16 model over int8 pools).
extern "C" int paged_attention_stats_q8_bf16q(
    const void* q, const void* k_data, const void* k_scale, const void* v_data,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  return launch<int8_t, __nv_bfloat16>(
      params(q, k_data, v_data, k_scale, v_scale, block_tables, seq_lens, acc, m, l, K, H,
             hd, P, page, Pm, scale),
      S, stream, device);
}

// Dynamic shared memory a block of the kernel takes for these shapes, with
// `beams` beams a block, over pages of `kind`: 0 float32, 1 int8, 2 bf16
// (q's type does not change it).
extern "C" long long paged_attention_block_smem(int beams, int hd, int page, int Pm, int kind) {
  const auto of = [&](auto t) -> long long {
    using T = decltype(t);
    if (hd <= 32) return block_smem<T, 32>(beams, ring_stages<T, 32>(page, Pm), Pm);
    if (hd <= 64) return block_smem<T, 64>(beams, ring_stages<T, 64>(page, Pm), Pm);
    return block_smem<T, 128>(beams, ring_stages<T, 128>(page, Pm), Pm);
  };
  return kind == 1 ? of(int8_t{}) : kind == 2 ? of(__nv_bfloat16{}) : of(float{});
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
