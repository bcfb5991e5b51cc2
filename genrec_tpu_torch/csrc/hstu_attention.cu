// HSTU SiLU attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels genrec_tpu/kernels/hstu_attention.py::
// hstu_attention_pallas (pallas_call at :187, body _kernel at :60) and
// hstu_attention_bwd_pallas (pallas_call at :322, body _bwd_kernel at :215).
// Computes what genrec_tpu_torch/kernels/hstu_attention.py::
// hstu_attention_ref / hstu_attention_bwd_ref compute, for every batch row
// b, head h, query position i and key position j of q, k, v (B, H, L, hd):
//
//   s_ij = q_i . k_j + pos_table[h, pos_bucket(j - i)]
//                    + time_table[h, time_bucket(t_i - t_j)]   (if timestamps)
//   masked_ij = j > i  or  pad[b, j]  or  seg[b, i] != seg[b, j]  (if segments)
//   out_i = sum_j silu(s_ij) v_j, with masked s_ij = -1e9, so silu = -0
//
// with no softmax and no 1/sqrt(hd) scale. The position bucket keeps the
// reference quirk: rel = key - query is clamped to >= 0, so every visible
// pair reads bucket 0. The time bucket is int(log(max(|dt|, 1)) / 0.693f),
// clipped to the table, with the float32 log correctly rounded, as on the
// CPU. No kernel takes that log: every one reads the bucket from an edge
// table (time_bucket_edges), exact on every int32 |dt|, so a bucket edge
// never moves by an ulp (CUDA's logf is one ulp off on some inputs), and
// no pair pays for a double-precision log. Scores and sums are fp32 from
// fp32 or bf16 inputs; with bf16 inputs silu(s) is rounded to bf16 once
// before it meets v, as the Pallas kernel's attn.astype(v.dtype) does.
//
// Backward (flash style, nothing saved but the inputs): recompute s, then
//   ds_ij = (g_i . v_j) sig(s) (1 + s (1 - sig(s))), exactly 0 where masked
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i silu(s_ij) g_i
//   dpos[h, n] = sum over pairs in bucket n of ds, dtime likewise,
// written per (b, h) and summed over b by a second launch of the same call
// (a warp per (h, bucket), rows in a fixed order).
//
// Bound on an H100 at the HSTU training shapes (B=128, H=2, L=50, hd=32,
// bf16): memory for the forward (3.3 MB of q/k/v/out, ~1 us) and the
// backward (~5.8 MB, ~1.7 us); the causal half of 4*L*L*hd*B*H FLOP is
// ~41 MFLOP, far below either. At these sizes launch and latency decide.
//
// fp32 inputs, forward and backward (FFMA, the parity path: a TF32 product
// would miss its 1e-5):
//   - tiles of 32 queries x 32 keys; 128 threads (4 warps). Phase 1 of a
//     tile: each warp takes query rows, one key per lane, and computes the
//     masked score and its silu (backward: also ds) into shared memory.
//     Phase 2: each thread owns fixed (row, dim) outputs and sums over the
//     tile's 32 entries in order. No atomics anywhere, so every sum has an
//     order that is fixed from run to run.
//   - forward grid (B*H, query tiles); a block walks the key tiles up to
//     its causal limit. Any L works: nothing holds more than one tile.
//   - backward grid (B*H): one block per (b, h) walks key tiles (outer)
//     and, for each, the query tiles at or after it (inner). dk/dv of the
//     key tile stay in registers; dq sums across key tiles in an fp32
//     scratch row in device memory that only this block touches; the
//     block rounds dq to the input dtype at the end. This replaces the
//     Pallas grid's revisited dk/dv output blocks, which count on the TPU
//     running the grid in order.
//   - per-bucket sums of ds (the Pallas one-hot select loops): lanes of a
//     warp holding the same bucket are grouped by shuffling the keys, each
//     group is summed in lane order through shuffles, and the group's
//     first lane adds the sum to the warp's own bins in shared memory
//     (32 + 64 per head at the trainer's shapes). The four warps' bins are
//     added in warp order at the end.
//   - the TPU version's padding of L to the q block and of hd to 128 lanes
//     is gone: rows and keys past L are skipped, hd keeps its width.
//
// Forward of bf16 inputs (hstu_fwd_tc_kernel, on the tensor cores):
//   - grid (B*H, query tiles of 64); a block per (b, h) and query tile
//     walks the key tiles up to its own (the trainer's L 50 is one tile,
//     so a (b, h) is one block: 256 blocks, one wave). q, k and v tiles
//     come in by 16-byte cp.async (zero-filled past L and hd, head dim
//     padded to 16, 32, 64 or 128), the tiles' timestamps, segments and
//     padding alongside;
//   - each 16 query rows are shared by two warps taking alternate 16-key
//     steps (at hd 128, by one warp: 128 registers a thread would not hold
//     it), as under the causal mask the last rows see four times the keys
//     of the first; the second warp's sums join the first's through
//     shared memory at the end, in a fixed order;
//   - a step: S = Q.K^T on mma.sync.m16n8k16 (bf16 in, fp32 sums, Q's
//     fragments kept in registers), then bias, masks and silu in the sums'
//     registers (a masked pair is exactly 0, as silu(-1e9) = -0 is in the
//     Pallas kernel), the time bias by one 16-byte read a pair of a table
//     that holds each power of two's bucket edge and both buckets' biases,
//     silu by the fast exponential and division, rounded once to bf16 (one
//     plane: a second would take the kernel away from the Pallas numbers),
//     then out += P.V with P straight from those registers (the m16n8
//     accumulator layout is the m16n8k16 A layout) and V by ldmatrix.trans;
//   - no softmax, so no rescaling: the sums stay in registers across key
//     tiles and leave as bf16 in paired stores. No atomics: equal bits.
//   - ce_bwd_ab.py --mode hstu_fwd measures the alternatives (PERF.md).
//
// Backward of bf16 inputs (hstu_bwd_tc_kernel, on the tensor cores):
//   - one block of 4 warps per (b, h) holds q, g, k and v of a 64-position
//     tile in shared memory (the trainer's L 50 is one tile; beyond, key
//     tiles outer and query tiles inner, as above), copied with 16-byte
//     cp.async (zero-filled past L and hd) while the tiles' timestamps,
//     segments and padding come into registers; head dim padded to 16, 32,
//     64 or 128 (a template parameter). ~92 KB a block at hd 32: 2 an SM,
//     the trainer's 256 blocks in one wave;
//   - S = Q.K^T and dP = G.V^T on mma.sync.m16n8k16 (bf16 in, fp32 sums),
//     the warp owning 16 query rows and skipping the key tiles its rows
//     cannot see; bias, masks, silu and dS in the sums' registers, every
//     pair without branches so the pairs' chains overlap. The time bucket
//     takes no log: e = floor(log2 |dt|) by a leading-zero count, then one
//     comparison with an edge table found on the plain version's own
//     function (time_bucket_edges): the double log on every pair was the
//     costliest variant measured (ce_bwd_ab.py --mode hstu);
//   - dq = dS.K with the sums' registers as the A operand (the m16n8
//     accumulator layout is the m16n8k16 A layout); dk = dS^T.Q and dv =
//     silu(S)^T.G by ldmatrix.trans of dS and silu(S) stored in shared
//     memory, the warp owning 16 keys. dS and silu(S) enter every product
//     as a bf16 hi + lo pair (two MMAs, ~16 bits of each), as the Pallas
//     backward multiplies them in fp32; q, k, v and g are exact in bf16.
//     One rounding was off by more than a tenth of the 1e-2 tolerance on
//     the card, so it is not taken;
//   - where L fits one tile, dq, dk and dv go from registers to the output;
//     beyond, their sums across tiles go through an fp32 scratch that only
//     the block touches (hstu_attention_bwd_scratch);
//   - dpos: every visible pair reads position bucket 0, so one register a
//     thread; dtime: a bin per (bucket, thread) in shared memory, each
//     row's visible pairs added in runs of one bucket. No atomics: equal
//     bits over two calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // queries and keys per tile
constexpr int kMaxHeadDim = 128;
constexpr int kOwn = kTile * kMaxHeadDim / kThreads;  // outputs a thread owns
constexpr int kStride = kTile + 1;  // row stride of the score tiles

constexpr int kTimeEdges = 32;  // edges[0] unused; a < 2^31 has e <= 30

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;               // backward: cotangent of the output
  const int* ts;               // (B, L) or null
  const unsigned char* pad;    // (B, L), nonzero = padding
  const int* seg;              // (B, L) or null
  const float* ptab;           // (H, nb)
  const float* ttab;           // (H, ntb) or null
  void* out;                   // forward output (B, H, L, hd)
  float* dq32;                 // backward: fp32 scratch, planes of (B, H, L, hd)
  size_t plane;                // floats of one scratch plane (bf16 backward)
  void* dq;
  void* dk;
  void* dv;
  float* dpt;                  // (B*H, nb) partials
  float* dtt;                  // (B*H, ntb) partials or null
  int H, L, hd, nb, ntb, max_exact;
  int BH;                      // B * H: (b, h) pairs of the call
  float log_ratio;             // log(max_position_distance / max_exact)
  int time_edges[kTimeEdges];  // see time_bucket_edges; set when ttab is
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// The value the input dtype would hold (Pallas: attn.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// genrec_tpu/ops/buckets.py::hstu_position_bucket, float32 as there (the log
// taken in double and rounded: the correctly rounded logf of the CPU).
__device__ __forceinline__ int pos_bucket(int rel, const Params& p) {
  const int rp = rel > 0 ? rel : 0;
  if (rp < p.max_exact) return rp;
  const float x = (float)(rp > 1 ? rp : 1) / (float)p.max_exact;
  const float f = (float)log((double)x) / p.log_ratio *
                  (float)(p.nb - p.max_exact);
  const int large = p.max_exact + (int)f;
  return large < p.nb - 1 ? large : p.nb - 1;
}

__device__ __forceinline__ float sigmoid(float s) { return 1.f / (1.f + expf(-s)); }

// genrec_tpu/ops/buckets.py::hstu_log_bucket of t_q - t_k (int32 wrap as
// there) without a log: as 0.693 < ln 2, the bucket of a = |dt| >= 1
// is e = floor(log2 a) or e + 1 (below 2^31, e * (ln 2 / 0.693 - 1) < 1),
// so it is e + (a >= edges[e + 1]), where edges[n] is the least a whose
// bucket is n or more (kTimeEdges of them, from the plain version's own
// function; the wrapper finds them and checks 2^(n-1) <= edges[n] <= 2^n).
// a <= 1, and |INT_MIN|, which wraps negative, read bucket 0 as there.
__device__ __forceinline__ int time_bucket_edges(int tq, int tk, const int* edges, int ntb) {
  const int diff = (int)((unsigned)tq - (unsigned)tk);
  const int a = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);
  const int e = 31 - __clz(a > 1 ? a : 1);
  const int b = e + (a >= edges[e + 1]);
  return b < ntb - 1 ? b : ntb - 1;
}

// Shared memory common to both directions, carved from the front.
struct Tiles {
  float* ptab;   // [nb]
  float* ttab;   // [ntb]
  int* tq;       // [kTile] query timestamps, segments
  int* sq;
  int* tk;       // [kTile] key timestamps, segments, padding
  int* sk;
  int* pk;
  int* edges;    // [kTimeEdges] time-bucket edges
  float* rest;
};

__device__ Tiles carve(float* smem, const Params& p) {
  Tiles t;
  t.ptab = smem;
  t.ttab = t.ptab + p.nb;
  t.tq = reinterpret_cast<int*>(t.ttab + p.ntb);
  t.sq = t.tq + kTile;
  t.tk = t.sq + kTile;
  t.sk = t.tk + kTile;
  t.pk = t.sk + kTile;
  t.edges = t.pk + kTile;
  t.rest = reinterpret_cast<float*>(t.edges + kTimeEdges);
  return t;
}

__device__ void load_tables(const Tiles& t, const Params& p, int h) {
  for (int i = threadIdx.x; i < p.nb; i += kThreads) t.ptab[i] = p.ptab[h * p.nb + i];
  if (p.ttab) {
    for (int i = threadIdx.x; i < p.ntb; i += kThreads) t.ttab[i] = p.ttab[h * p.ntb + i];
    for (int i = threadIdx.x; i < kTimeEdges; i += kThreads) t.edges[i] = p.time_edges[i];
  }
}

__device__ void load_query_meta(const Tiles& t, const Params& p, int b, int q0) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int qi = q0 + i;
    const bool in = qi < p.L;
    t.tq[i] = (p.ts && in) ? p.ts[b * p.L + qi] : 0;
    t.sq[i] = (p.seg && in) ? p.seg[b * p.L + qi] : 0;
  }
}

__device__ void load_key_meta(const Tiles& t, const Params& p, int b, int k0) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int kj = k0 + j;
    const bool in = kj < p.L;
    t.tk[j] = (p.ts && in) ? p.ts[b * p.L + kj] : 0;
    t.sk[j] = (p.seg && in) ? p.seg[b * p.L + kj] : 0;
    t.pk[j] = in ? (p.pad[b * p.L + kj] != 0) : 1;  // keys past L are masked
  }
}

// rows [r0, r0 + kTile) of a (L, hd) matrix into dst with row stride ld, as fp32.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int r0, const Params& p) {
  for (int x = threadIdx.x; x < kTile * p.hd; x += kThreads) {
    const int r = x / p.hd;
    const int d = x - r * p.hd;
    dst[r * ld + d] = (r0 + r < p.L) ? to_f(src[(size_t)(r0 + r) * p.hd + d]) : 0.f;
  }
}

// Whether query i and key j of the current tiles see each other.
__device__ __forceinline__ bool visible(const Tiles& t, const Params& p, int qi, int kj,
                                        int i, int j) {
  return qi < p.L && kj < p.L && kj <= qi && !t.pk[j] && (!p.seg || t.sq[i] == t.sk[j]);
}

// The score of a visible pair: dot + position bias (+ time bias).
__device__ __forceinline__ float biased(const Tiles& t, const Params& p, float dot, int qi,
                                        int kj, int i, int j, int* pb, int* tb) {
  *pb = pos_bucket(kj - qi, p);
  float s = dot + t.ptab[*pb];
  if (p.ttab && p.ts) {
    *tb = time_bucket_edges(t.tq[i], t.tk[j], t.edges, p.ntb);
    s = s + t.ttab[*tb];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hstu_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int hd = p.hd;
  const int ks = hd + 1;  // odd stride: lanes reading rows j hit distinct banks
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const Tiles t = carve(smem, p);
  float* q_s = t.rest;                // [kTile][hd]
  float* k_s = q_s + kTile * hd;      // [kTile][hd + 1]
  float* v_s = k_s + kTile * ks;      // [kTile][hd]
  float* p_s = v_s + kTile * hd;      // [kTile][kStride] silu of the scores

  const size_t base = (size_t)bh * p.L * hd;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;

  load_tables(t, p, h);
  load_query_meta(t, p, b, q0);
  load_rows(q_s, hd, q, q0, p);

  float acc[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) acc[e] = 0.f;

  const int k_end = min(p.L, q0 + kTile);  // causal: later keys are masked
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows(k_s, ks, k, k0, p);
    load_rows(v_s, hd, v, k0, p);
    load_key_meta(t, p, b, k0);
    __syncthreads();

    for (int i = warp; i < kTile; i += kWarps) {
      const int qi = q0 + i;
      const int kj = k0 + lane;
      float a = 0.f;  // silu(-1e9) is -0: a masked pair adds nothing
      if (visible(t, p, qi, kj, i, lane)) {
        const float* qr = q_s + i * hd;
        const float* kr = k_s + lane * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        int pb, tb;
        const float s = biased(t, p, dot, qi, kj, i, lane, &pb, &tb);
        a = round_as<T>(s * sigmoid(s));
      }
      p_s[i * kStride + lane] = a;
    }
    __syncthreads();

    const int kn = min(kTile, p.L - k0);
#pragma unroll
    for (int e = 0; e < kOwn; ++e) {
      const int x = tid + e * kThreads;
      if (x < kTile * hd) {
        const int i = x / hd;
        const int d = x - i * hd;
        const float* pr = p_s + i * kStride;
        float a = acc[e];
        for (int j = 0; j < kn; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
        acc[e] = a;
      }
    }
  }

  T* out = static_cast<T*>(p.out) + base;
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    const int x = tid + e * kThreads;
    if (x < kTile * hd) {
      const int i = x / hd;
      const int d = x - i * hd;
      if (q0 + i < p.L) out[(size_t)(q0 + i) * hd + d] = from_f<T>(acc[e]);
    }
  }
}

// Adds val into bins[key] for every distinct key >= 0 held by the warp's
// lanes: lanes with equal keys are summed in lane order, and the group's
// first lane writes, so no two lanes touch one bin. The group is found by
// shuffling the keys, not with __match_any_sync: ptxas 12.8 at -O3 fails
// to allocate registers for this kernel with it (C7600).
__device__ __forceinline__ void group_add(float* bins, int key, float val, int lane) {
  unsigned grp = 0;
  for (int src = 0; src < 32; ++src)
    grp |= (unsigned)(__shfl_sync(0xffffffffu, key, src) == key) << src;
  float sum = 0.f;
  for (int src = 0; src < 32; ++src) {
    const float x = __shfl_sync(0xffffffffu, val, src);
    if ((grp >> src) & 1u) sum += x;
  }
  if (key >= 0 && lane == __ffs(grp) - 1) bins[key] += sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hstu_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hd = p.hd;
  const int ks = hd + 1;
  const int nbins = p.nb + p.ntb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool use_time = p.ttab && p.ts;

  const Tiles t = carve(smem, p);
  float* bins = t.rest;                   // [kWarps][nb + ntb]
  float* q_s = bins + kWarps * nbins;     // [kTile][hd]
  float* g_s = q_s + kTile * hd;          // [kTile][hd]
  float* k_s = g_s + kTile * hd;          // [kTile][hd + 1]
  float* v_s = k_s + kTile * ks;          // [kTile][hd + 1]
  float* ds_s = v_s + kTile * ks;         // [kTile][kStride]
  float* at_s = ds_s + kTile * kStride;   // [kTile][kStride]

  const size_t base = (size_t)bh * p.L * hd;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* g = static_cast<const T*>(p.g) + base;
  float* dq32 = p.dq32 + base;

  load_tables(t, p, h);
  for (int i = tid; i < kWarps * nbins; i += kThreads) bins[i] = 0.f;
  float* bins_w = bins + warp * nbins;

  for (int k0 = 0; k0 < p.L; k0 += kTile) {
    __syncthreads();
    load_rows(k_s, ks, k, k0, p);
    load_rows(v_s, ks, v, k0, p);
    load_key_meta(t, p, b, k0);
    float dk[kOwn], dv[kOwn];
#pragma unroll
    for (int e = 0; e < kOwn; ++e) dk[e] = dv[e] = 0.f;

    // Query tiles before k0 see none of these keys (kTile is both sizes).
    for (int q0 = k0; q0 < p.L; q0 += kTile) {
      __syncthreads();
      load_rows(q_s, hd, q, q0, p);
      load_rows(g_s, hd, g, q0, p);
      load_query_meta(t, p, b, q0);
      __syncthreads();

      for (int i = warp; i < kTile; i += kWarps) {
        const int qi = q0 + i;
        const int kj = k0 + lane;
        float ds = 0.f, at = 0.f;
        int pb = -1, tb = -1;  // -1: no bin (masked pairs have ds == 0)
        if (visible(t, p, qi, kj, i, lane)) {
          const float* qr = q_s + i * hd;
          const float* gr = g_s + i * hd;
          const float* kr = k_s + lane * ks;
          const float* vr = v_s + lane * ks;
          float dot = 0.f, dattn = 0.f;
          for (int d = 0; d < hd; ++d) {
            dot = fmaf(qr[d], kr[d], dot);
            dattn = fmaf(gr[d], vr[d], dattn);
          }
          const float s = biased(t, p, dot, qi, kj, i, lane, &pb, &tb);
          const float sig = sigmoid(s);
          at = s * sig;
          ds = dattn * sig * (1.f + s * (1.f - sig));
        }
        ds_s[i * kStride + lane] = ds;
        at_s[i * kStride + lane] = at;
        group_add(bins_w, pb, ds, lane);
        if (use_time) group_add(bins_w + p.nb, tb, ds, lane);
      }
      __syncthreads();

      const int kn = min(kTile, p.L - k0);
      const int qn = min(kTile, p.L - q0);
#pragma unroll
      for (int e = 0; e < kOwn; ++e) {
        const int x = tid + e * kThreads;
        if (x < kTile * hd) {
          const int r = x / hd;  // query row for dq, key row for dk/dv
          const int d = x - r * hd;
          if (r < qn) {
            const float* dr = ds_s + r * kStride;
            float a = 0.f;
            for (int j = 0; j < kn; ++j) a = fmaf(dr[j], k_s[j * ks + d], a);
            float* dst = dq32 + (size_t)(q0 + r) * hd + d;
            *dst = (k0 == 0 ? 0.f : *dst) + a;  // key tile 0 visits every row
          }
          float a = dk[e], c = dv[e];
          for (int i = 0; i < qn; ++i) {
            a = fmaf(ds_s[i * kStride + r], q_s[i * hd + d], a);
            c = fmaf(at_s[i * kStride + r], g_s[i * hd + d], c);
          }
          dk[e] = a;
          dv[e] = c;
        }
      }
    }

    T* dk_out = static_cast<T*>(p.dk) + base;
    T* dv_out = static_cast<T*>(p.dv) + base;
#pragma unroll
    for (int e = 0; e < kOwn; ++e) {
      const int x = tid + e * kThreads;
      if (x < kTile * hd) {
        const int j = x / hd;
        const int d = x - j * hd;
        if (k0 + j < p.L) {
          dk_out[(size_t)(k0 + j) * hd + d] = from_f<T>(dk[e]);
          dv_out[(size_t)(k0 + j) * hd + d] = from_f<T>(dv[e]);
        }
      }
    }
  }
  __syncthreads();  // dq32 and the bins are complete

  T* dq = static_cast<T*>(p.dq) + base;
  for (int x = tid; x < p.L * hd; x += kThreads) dq[x] = from_f<T>(dq32[x]);
  for (int n = tid; n < p.nb; n += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += bins[w * nbins + n];
    p.dpt[(size_t)bh * p.nb + n] = s;
  }
  if (p.dtt)
    for (int n = tid; n < p.ntb; n += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += bins[w * nbins + p.nb + n];
      p.dtt[(size_t)bh * p.ntb + n] = s;
    }
}

// ---- the bf16 backward on the tensor cores (hstu_bwd_tc_kernel) ----

constexpr int kTcTile = 64;      // query and key positions of a tile
constexpr int kTcThreads = 128;  // 4 warps; in each product a warp owns 16 rows
constexpr int kDsStride = kTcTile + 8;  // bf16 row stride of the dS and silu(S) planes
constexpr int kBinStride = kTcThreads + 1;  // floats between time bins
// dS and silu(S) enter the products as bf16 hi + lo planes (1: one rounding).
constexpr int kPlanes = 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes, of which the first src_bytes (16 or 0) come from src and the
// rest are zero.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// d += a . b on a 16 x 8 x 16 tile, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two fp32 values as bf16x2 planes: out[0] the rounded pair, out[1] the
// rounded remainder (x - hi), which together carry ~16 bits of each.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[kPlanes]) {
  const bf16 h0 = __float2bfloat16_rn(x0);
  const bf16 h1 = __float2bfloat16_rn(x1);
  out[0] = bf16x2_bits(h0, h1);
  if (kPlanes > 1)
    out[kPlanes - 1] = bf16x2_bits(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                                   __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// A fragments (rows of the warp x 16 keys, kPlanes planes) of the fp32
// accumulators of key tiles 2kk and 2kk + 1: the m16n8 sums' layout is the
// m16n8k16 A operand's, register for register.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[kPlanes][4]) {
  uint32_t t0[kPlanes], t1[kPlanes], t2[kPlanes], t3[kPlanes];
  split_pair(c0[0], c0[1], t0);  // row g, keys 2t, 2t + 1
  split_pair(c0[2], c0[3], t1);  // row g + 8
  split_pair(c1[0], c1[1], t2);  // row g, keys 8 + 2t, 8 + 2t + 1
  split_pair(c1[2], c1[3], t3);  // row g + 8
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl) {
    a[pl][0] = t0[pl];
    a[pl][1] = t1[pl];
    a[pl][2] = t2[pl];
    a[pl][3] = t3[pl];
  }
}

// Smem layout of the block, in bytes from the front.
template <int HDP>
struct TcSmem {
  static constexpr int kRow = HDP + 8;  // bf16 row stride of the q, g, k, v tiles (load_tile's)
  static constexpr int kMat = kTcTile * kRow * 2;
  static constexpr int kPlane = kTcTile * kDsStride * 2;
  static constexpr int kQ = 0, kG = kMat, kK = 2 * kMat, kV = 3 * kMat;
  static constexpr int kDs = 4 * kMat;               // kPlanes planes of dS
  static constexpr int kAt = kDs + kPlanes * kPlane;  // kPlanes planes of silu(S)
  static constexpr int kMeta = kAt + kPlanes * kPlane;  // kTcTile int4 and int2, 4 floats
  static constexpr int kTtab = kMeta + kTcTile * 24 + 16 + kTimeEdges * 4;
  static size_t bytes(int ntb) {
    return (size_t)kTtab + (size_t)ntb * 4 + (size_t)ntb * kBinStride * 4;
  }
};

// Rows [r0, r0 + kRows) of a (L, hd) bf16 matrix into a tile of HDP
// columns with row stride HDP + 8, rows past L and columns past hd zero;
// thread t of kCopiers.
template <int HDP, int kRows, int kCopiers>
__device__ void load_tile(bf16* dst, const bf16* src, int r0, int L, int hd, int t) {
  constexpr int kRow = HDP + 8;
  if (hd % 8 == 0) {  // 16-byte rows: cp.async, zero-filling what is outside
    constexpr int kChunks = HDP / 8;
    for (int x = t; x < kRows * kChunks; x += kCopiers) {
      const int r = x / kChunks;
      const int c = x - r * kChunks;
      const bool in = r0 + r < L && 8 * c < hd;
      cp_async_16(dst + r * kRow + 8 * c, in ? src + (size_t)(r0 + r) * hd + 8 * c : src,
                  in ? 16 : 0);
    }
  } else {
    for (int x = t; x < kRows * HDP; x += kCopiers) {
      const int r = x / HDP;
      const int d = x - r * HDP;
      dst[r * kRow + d] = (r0 + r < L && d < hd) ? src[(size_t)(r0 + r) * hd + d]
                                                 : __float2bfloat16_rn(0.f);
    }
  }
}

// One 16-row x 8-column sum fragment (rows r and r + 8 of `row0`, columns
// 2t, 2t + 1 of `col0`) of a (L, hd) output: added to the fp32 scratch
// unless `first`, then written in bf16 if `last`, else to the scratch; a
// column pair as one 4- or 8-byte store where hd is even.
__device__ __forceinline__ void emit_frag(const float (&acc)[4], int row0, int col0, int lane,
                                          int L, int hd, bool first, bool last, float* scratch,
                                          bf16* out) {
  const int col = col0 + 2 * (lane & 3);
  if (col >= hd) return;
  const bool pair = hd % 2 == 0;  // then col + 1 < hd too
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= L) continue;
    const size_t o = (size_t)row * hd + col;
    float x0 = acc[2 * half], x1 = acc[2 * half + 1];
    if (pair) {
      if (!first) {
        const float2 s2 = *reinterpret_cast<const float2*>(scratch + o);
        x0 = s2.x + x0;
        x1 = s2.y + x1;
      }
      if (last)
        *reinterpret_cast<uint32_t*>(out + o) =
            bf16x2_bits(__float2bfloat16_rn(x0), __float2bfloat16_rn(x1));
      else
        *reinterpret_cast<float2*>(scratch + o) = make_float2(x0, x1);
    } else {
      for (int e = 0; e < 2 && col + e < hd; ++e) {
        float x = e ? x1 : x0;
        if (!first) x = scratch[o + e] + x;
        if (last) out[o + e] = __float2bfloat16_rn(x);
        else scratch[o + e] = x;
      }
    }
  }
}

// ---- the bf16 forward on the tensor cores (hstu_fwd_tc_kernel) ----

constexpr int kFwdTile = 64;  // query and key positions of a tile
constexpr int kFwdHeads = 1;  // (b, h) pairs a block
constexpr int kFwdRowWarps = kFwdTile / 16;  // 16-row groups of a query tile

// The block of head width HDP. kSplit warps share 16 query rows, taking
// alternate 16-key steps: two where 128 registers a thread hold the
// kernel (HDP <= 64; two blocks of 8 warps an SM), else one.
template <int HDP>
struct FwdCfg {
  static constexpr int kSplit = HDP <= 64 ? 2 : 1;
  static constexpr int kGroup = 32 * kFwdRowWarps * kSplit;  // threads of one (b, h)
  static constexpr int kThreads = kFwdHeads * kGroup;
  static constexpr int kSteps = kFwdTile / 16 / kSplit;  // 16-key steps a warp takes a tile
  static_assert(kGroup >= kFwdTile + kTimeEdges - 1, "a thread a key and a time-bias entry");
};

// A group's shared memory, in bytes from its front.
template <int HDP>
struct FwdSmem {
  static constexpr int kRow = HDP + 8;  // bf16 row stride of the q, k, v tiles (load_tile's)
  static constexpr int kMat = kFwdTile * kRow * 2;
  static constexpr int kQ = 0, kK = kMat, kV = 2 * kMat;
  static constexpr int kMeta = 3 * kMat;  // kFwdTile int4 (keys) and int2 (queries)
  static constexpr int kBias = kMeta + kFwdTile * 24;  // kTimeEdges int4: the time bias
  static constexpr int kBytes = kBias + kTimeEdges * 16;
  // The second warps' sums, handed to the first after the last key tile,
  // fit in the k and v tiles they have consumed.
  static_assert(kFwdRowWarps * 32 * HDP / 2 * 4 <= 2 * kMat, "exchange fits in k and v");
};

// silu(s) = s / (1 + e^-s) with the fast exponential and division (a
// few ulp of fp32, far inside the bf16 rounding that follows; -0 when e^-s
// overflows). The fp32 kernels keep s * sigmoid(s).
__device__ __forceinline__ float silu_fast(float s) { return __fdividef(s, 1.f + __expf(-s)); }

// One 16-key step of the warp's rows: S (two n-tiles of 8 keys, both B
// fragments by one ldmatrix) into sa, then P = silu(S + bias), masked
// pairs exactly 0, rounded once to bf16 as the step's A fragment for P.V
// (n-tile 0 gives registers 0 and 1, n-tile 1 registers 2 and 3). Every
// pair of a live n-tile without branches, so the pairs' chains overlap.
// The time bias is one 16-byte read a pair: tbias[e] = (edges[e + 1],
// bias of bucket e, bias of bucket e + 1), e = floor(log2 |dt|) (see
// time_bucket_edges).
template <int HDP>
__device__ __forceinline__ void fwd_step(uint32_t (&pf)[4], const uint32_t (&aq)[HDP / 16][4],
                                         const bf16* k_s, const int4* km, int2 qa, int2 qb,
                                         const int4* tbias, bool use_time, float pbias, int k0,
                                         int kc, int qrow0, int qmax, int lane) {
  constexpr int kRow = HDP + 8;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  float sa[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const bool second = k0 + kc + 8 <= qmax;  // causal: later keys are all masked
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t bk[4];  // matrices: (keys 0-7, dims 0-7), (0-7, 8-15), then keys 8-15
    ldsm_x4(bk, k_s + (kc + (lane & 7) + (lane >> 4) * 8) * kRow + 16 * kk +
                    ((lane >> 3) & 1) * 8);
    const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
    mma_16816(sa[0], aq[kk], b0);
    if (second) mma_16816(sa[1], aq[kk], b1);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + kc + 8 * n <= qmax) {
      const int j0 = kc + 8 * n + 2 * t4;
      const int4 ka = km[j0], kb = km[j0 + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 qr = (e >> 1) ? qb : qa;
        const int4 kr = (e & 1) ? kb : ka;
        const int qi = qrow0 + g8 + 8 * (e >> 1);  // rows past L are never stored
        const int kj = k0 + j0 + (e & 1);
        const bool vis = (kj <= qi) & (kr.z == 0) & (qr.y == kr.y);
        float s = sa[n][e] + pbias;
        if (use_time) {
          const int diff = (int)((unsigned)qr.x - (unsigned)kr.x);
          const int a = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);
          const int4 tb = tbias[31 - __clz(a > 1 ? a : 1)];
          s = s + __int_as_float(a >= tb.x ? tb.z : tb.y);
        }
        x[e] = vis ? silu_fast(s) : 0.f;
      }
    }
    pf[2 * n] = bf16x2_bits(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]));
    pf[2 * n + 1] = bf16x2_bits(__float2bfloat16_rn(x[2]), __float2bfloat16_rn(x[3]));
  }
}

// Two blocks an SM: 128 registers a thread at 8 warps a block, 255 at 4
// (aiming at more blocks on its own, ptxas spilled at hd 16).
template <int HDP>
__global__ void __launch_bounds__(FwdCfg<HDP>::kThreads, 2) hstu_fwd_tc_kernel(Params p) {
  using Sm = FwdSmem<HDP>;
  using Cfg = FwdCfg<HDP>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const bool use_time = p.ttab && p.ts;
  const int tid = threadIdx.x;
  const int grp = tid / Cfg::kGroup;  // which of the block's (b, h) pairs
  const int gt = tid - grp * Cfg::kGroup;
  const int lane = tid & 31;
  const int rgrp = (gt >> 5) % kFwdRowWarps;  // the warp's 16 rows of the query tile
  const int half = (gt >> 5) / kFwdRowWarps;  // and which of their key steps it takes
  unsigned char* sm = tc_smem + grp * Sm::kBytes;
  bf16* q_s = reinterpret_cast<bf16*>(sm + Sm::kQ);
  bf16* k_s = reinterpret_cast<bf16*>(sm + Sm::kK);
  bf16* v_s = reinterpret_cast<bf16*>(sm + Sm::kV);
  int4* km = reinterpret_cast<int4*>(sm + Sm::kMeta);  // key tile: time, segment, masked
  int2* qm = reinterpret_cast<int2*>(km + kFwdTile);     // query tile: time, segment
  int4* tbias = reinterpret_cast<int4*>(sm + Sm::kBias);

  const int bh = blockIdx.x * kFwdHeads + grp;
  const bool live = bh < p.BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int L = p.L;
  const int hd = p.hd;
  const int q0 = blockIdx.y * kFwdTile;
  const int rw = 16 * rgrp;                   // the warp's first row in the query tile
  const int qmax = min(q0 + rw + 15, L - 1);  // its last query that exists
  const bool rows_in = live && q0 + rw < L;
  const size_t base = (size_t)bh * L * hd;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* v = static_cast<const bf16*>(p.v) + base;

  float pbias = 0.f;  // a visible pair has key <= query: position bucket of 0
  uint32_t aq[HDP / 16][4];
  float oacc[HDP / 8][4];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += kFwdTile) {  // causal: later key tiles are all masked
    if (k0 > 0) __syncthreads();  // every warp is done with the previous key tile
    if (live) {
      if (k0 == 0) load_tile<HDP, kFwdTile, Cfg::kGroup>(q_s, q, q0, L, hd, gt);
      load_tile<HDP, kFwdTile, Cfg::kGroup>(k_s, k, k0, L, hd, gt);
      load_tile<HDP, kFwdTile, Cfg::kGroup>(v_s, v, k0, L, hd, gt);
      // The tiles' metadata while the copies fly (thread i: key k0 + i and,
      // on the first key tile, query q0 + i); keys past L are masked.
      if (gt < kFwdTile) {
        const int kj = k0 + gt;
        int4 mk = make_int4(0, 0, 1, 0);
        if (kj < L)
          mk = make_int4(use_time ? p.ts[b * L + kj] : 0, p.seg ? p.seg[b * L + kj] : 0,
                         p.pad[b * L + kj] != 0, 0);
        km[gt] = mk;
        if (k0 == 0) {
          const int qi = q0 + gt;
          int2 mq = make_int2(0, 0);
          if (qi < L)
            mq = make_int2(use_time ? p.ts[b * L + qi] : 0, p.seg ? p.seg[b * L + qi] : 0);
          qm[gt] = mq;
        }
      } else if (k0 == 0 && use_time && gt < kFwdTile + kTimeEdges - 1) {
        const int e = gt - kFwdTile;  // once: the time bias of e = floor(log2 |dt|)
        const float* row = p.ttab + h * p.ntb;
        tbias[e] = make_int4(p.time_edges[e + 1], __float_as_int(row[min(e, p.ntb - 1)]),
                             __float_as_int(row[min(e + 1, p.ntb - 1)]), 0);
      }
      if (k0 == 0) pbias = p.ptab[h * p.nb + pos_bucket(0, p)];
    }
    cp_async_wait_all();  // this thread's copies have landed
    __syncthreads();      // and every thread's, with the metadata
    if (!rows_in) continue;

    if (k0 == 0)  // the warp's rows of Q as A fragments, for every key tile
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        ldsm_x4(aq[kk], q_s + (rw + (lane & 7) + ((lane >> 3) & 1) * 8) * Sm::kRow + 16 * kk +
                            (lane >> 4) * 8);
    const int2 qa = qm[rw + (lane >> 2)], qb = qm[rw + (lane >> 2) + 8];
#pragma unroll
    for (int st = 0; st < Cfg::kSteps; ++st) {
      const int kc = 16 * (st * Cfg::kSplit + half);  // the step's first key in the tile
      if (k0 + kc > qmax) continue;
      uint32_t pf[4];
      fwd_step<HDP>(pf, aq, k_s, km, qa, qb, tbias, use_time, pbias, k0, kc, q0 + rw, qmax,
                    lane);
      // out += P.V over the step's 16 keys, two dim tiles a B load.
#pragma unroll
      for (int dn = 0; dn < HDP / 8; dn += 2) {
        uint32_t b4[4];  // matrices: (keys 0-7, dn), (keys 8-15, dn), then dn + 1
        ldsm_x4_trans(b4, v_s + (kc + (lane & 15)) * Sm::kRow + 8 * dn + (lane >> 4) * 8);
        const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
        mma_16816(oacc[dn], pf, b0);
        mma_16816(oacc[dn + 1], pf, b1);
      }
    }
  }

  if (Cfg::kSplit > 1) {  // the second warps' sums to the first, through the k and v tiles
    float* xch = reinterpret_cast<float*>(sm + Sm::kK) + rgrp * 32 * (HDP / 2) + lane;
    __syncthreads();  // every warp is done with the last key tile
    if (rows_in && half == 1)
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * dn + e) * 32] = oacc[dn][e];
    __syncthreads();
    if (half == 1) return;
    if (rows_in)
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[dn][e] += xch[(4 * dn + e) * 32];
  }
  if (rows_in) {
    bf16* out = static_cast<bf16*>(p.out) + base;
#pragma unroll
    for (int dn = 0; dn < HDP / 8; ++dn)
      emit_frag(oacc[dn], q0 + rw, 8 * dn, lane, L, hd, true, true, nullptr, out);
  }
}

// Shared memory allows 2 blocks an SM at hd <= 64; saying so lets ptxas
// keep its registers (aiming at 3 blocks, it spilled at hd 64 and 128).
template <int HDP>
__global__ void __launch_bounds__(kTcThreads, 2) hstu_bwd_tc_kernel(Params p) {
  using Sm = TcSmem<HDP>;
  constexpr int kRow = Sm::kRow;
  constexpr int kDimTiles = HDP / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem + Sm::kQ);
  bf16* g_s = reinterpret_cast<bf16*>(tc_smem + Sm::kG);
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem + Sm::kK);
  bf16* v_s = reinterpret_cast<bf16*>(tc_smem + Sm::kV);
  bf16* ds_s = reinterpret_cast<bf16*>(tc_smem + Sm::kDs);
  bf16* at_s = reinterpret_cast<bf16*>(tc_smem + Sm::kAt);
  int4* km = reinterpret_cast<int4*>(tc_smem + Sm::kMeta);  // key tile: time, segment, masked
  int2* qm = reinterpret_cast<int2*>(km + kTcTile);           // query tile: time, segment
  float* red = reinterpret_cast<float*>(qm + kTcTile);        // 4 warp sums
  int* edges = reinterpret_cast<int*>(red + 4);          // kTimeEdges time-bucket edges
  float* ttab = reinterpret_cast<float*>(tc_smem + Sm::kTtab);
  const bool use_time = p.ttab && p.ts;
  const int ntb = use_time ? p.ntb : 0;
  float* bins = ttab + ntb;  // [ntb][kBinStride]: a bin per thread per time bucket

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int L = p.L;
  const int hd = p.hd;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  // Every visible pair has key <= query, so rel <= 0 reads the bucket of 0.
  const int pb0 = pos_bucket(0, p);
  float pbias = 0.f;
  float dpos = 0.f;  // this thread's sum of ds over its visible pairs

  const size_t base = (size_t)bh * L * hd;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* v = static_cast<const bf16*>(p.v) + base;
  const bf16* g = static_cast<const bf16*>(p.g) + base;
  bf16* dq_out = static_cast<bf16*>(p.dq) + base;
  bf16* dk_out = static_cast<bf16*>(p.dk) + base;
  bf16* dv_out = static_cast<bf16*>(p.dv) + base;
  // fp32 sums across tiles, used only where L > kTcTile
  float* dq32 = p.dq32 + base;
  float* dk32 = p.dq32 + p.plane + base;
  float* dv32 = p.dq32 + 2 * p.plane + base;

  const int nt = (L + kTcTile - 1) / kTcTile;
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTcTile;
    for (int qt = kt; qt < nt; ++qt) {  // earlier query tiles see none of these keys
      const int q0 = qt * kTcTile;
      __syncthreads();  // the previous pair's tiles and planes are consumed
      if (qt == kt) {
        load_tile<HDP, kTcTile, kTcThreads>(k_s, k, k0, L, hd, tid);
        load_tile<HDP, kTcTile, kTcThreads>(v_s, v, k0, L, hd, tid);
      }
      load_tile<HDP, kTcTile, kTcThreads>(q_s, q, q0, L, hd, tid);
      load_tile<HDP, kTcTile, kTcThreads>(g_s, g, q0, L, hd, tid);
      // The tiles' metadata, loaded into registers while the copies fly
      // (thread i: query q0 + i, key k0 + i; keys past L are masked).
      int2 mq = make_int2(0, 0);
      int4 mk = make_int4(0, 0, 1, 0);
      if (tid < kTcTile) {
        const int qi = q0 + tid;
        const int kj = k0 + tid;
        if (qi < L) mq = make_int2(use_time ? p.ts[b * L + qi] : 0, p.seg ? p.seg[b * L + qi] : 0);
        if (qt == kt && kj < L)
          mk = make_int4(use_time ? p.ts[b * L + kj] : 0, p.seg ? p.seg[b * L + kj] : 0,
                         p.pad[b * L + kj] != 0, 0);
      }
      if (kt == 0 && qt == 0) {  // once: the time table, the bins, the edges, the bias
        float tv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)  // ntb <= 255
          tv[r] = tid + r * kTcThreads < ntb ? p.ttab[h * p.ntb + tid + r * kTcThreads] : 0.f;
        pbias = p.ptab[h * p.nb + pb0];
        for (int i = tid; i < ntb * kBinStride; i += kTcThreads) bins[i] = 0.f;
        if (tid < kTimeEdges) edges[tid] = p.time_edges[tid];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (tid + r * kTcThreads < ntb) ttab[tid + r * kTcThreads] = tv[r];
      }
      if (tid < kTcTile) {
        qm[tid] = mq;
        if (qt == kt) km[tid] = mk;
      }
      cp_async_wait_all();
      __syncthreads();

      // Scores: the warp's 16 query rows against the tile's 64 keys, S =
      // Q.K^T and dP = G.V^T, then silu(S) and dS in place.
      const int rw = 16 * warp;  // the warp's first row in the tile
      const int qmax = min(q0 + rw + 15, L - 1);  // its last query that exists
      float sa[8][4], pa[8][4];
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[nn][e] = pa[nn][e] = 0.f;
      if (q0 + rw < L) {
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          uint32_t aq[4], ag[4];
          const int ar = rw + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int ac = 16 * kk + (lane >> 4) * 8;
          ldsm_x4(aq, q_s + ar * kRow + ac);
          ldsm_x4(ag, g_s + ar * kRow + ac);
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            if (k0 + 8 * nn <= qmax) {  // causal: later keys are all masked
              uint32_t bk[2], bv[2];
              const int br = 8 * nn + (lane & 7);
              const int bc = 16 * kk + ((lane >> 3) & 1) * 8;
              ldsm_x2(bk, k_s + br * kRow + bc);
              ldsm_x2(bv, v_s + br * kRow + bc);
              mma_16816(sa[nn], aq, bk);
              mma_16816(pa[nn], ag, bv);
            }
          }
        }
      }
      // Every pair of the n-tiles the causal mask leaves, without branches,
      // so the pairs' chains (bucket, bias, exp, reciprocal) overlap; the
      // visible ones are kept. The bucket of each pair, 255 where masked,
      // is packed 4 to a register.
      const bool rows_in = q0 + rw < L;
      const int2 qa = qm[rw + g8], qb = qm[rw + g8 + 8];
      uint32_t tbp[8];
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        tbp[nn] = 0xffffffffu;
        if (rows_in && k0 + 8 * nn <= qmax) {
          const int j0 = 8 * nn + 2 * t4;
          const int4 ka = km[j0], kb = km[j0 + 1];
          uint32_t packed = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int2 qr = (e >> 1) ? qb : qa;
            const int4 kr = (e & 1) ? kb : ka;
            const int qi = q0 + rw + g8 + 8 * (e >> 1);
            const int kj = k0 + j0 + (e & 1);
            const bool vis = (qi < L) & (kj <= qi) & (kr.z == 0) & (qr.y == kr.y);
            float s = sa[nn][e] + pbias;
            int tb = 0;
            if (use_time) {
              tb = time_bucket_edges(qr.x, kr.x, edges, p.ntb);
              s = s + ttab[tb];
            }
            const float sig = sigmoid(s);
            const float at = s * sig;
            const float ds = pa[nn][e] * sig * (1.f + s * (1.f - sig));
            sa[nn][e] = vis ? at : 0.f;  // masked pairs: exactly 0, in no bin
            pa[nn][e] = vis ? ds : 0.f;
            packed |= (uint32_t)(vis ? tb : 255) << (8 * e);
          }
          tbp[nn] = packed;
        }
      }
      // The sums of ds: dpos in pair order; dtime row by row, in runs of
      // one bucket (keys in order meet few buckets), each run added to its
      // bin once.
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpos += pa[nn][e];
      if (use_time) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int run_tb = 255;
          float run = 0.f;
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * half + c;
              const int tb = (tbp[nn] >> (8 * e)) & 255;
              if (tb != 255) {
                if (tb != run_tb) {
                  if (run_tb != 255) bins[run_tb * kBinStride + tid] += run;
                  run_tb = tb;
                  run = 0.f;
                }
                run += pa[nn][e];
              }
            }
          }
          if (run_tb != 255) bins[run_tb * kBinStride + tid] += run;
        }
      }

      // dq of the warp's rows: dS (16 x 64 keys) . K (64 keys x HDP), the A
      // operand straight from the sums' registers.
      {
        uint32_t a[4][kPlanes][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[2 * kk], pa[2 * kk + 1], a[kk]);
#pragma unroll
        for (int dn = 0; dn < kDimTiles; ++dn) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (q0 + rw < L && k0 + 16 * kk <= qmax) {
              uint32_t bk[2];
              ldsm_x2_trans(bk, k_s + (16 * kk + (lane & 15)) * kRow + 8 * dn);
#pragma unroll
              for (int pl = 0; pl < kPlanes; ++pl) mma_16816(acc, a[kk][pl], bk);
            }
          }
          // query tile qt meets key tiles 0 .. qt: first at kt 0, last at qt
          emit_frag(acc, q0 + rw, 8 * dn, lane, L, hd, kt == 0, kt == qt, dq32, dq_out);
        }
      }

      // The planes of dS and silu(S) for the key-owned products.
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (rw + g8 + 8 * half) * kDsStride + 8 * nn + 2 * t4;
          uint32_t d2[kPlanes], a2[kPlanes];
          split_pair(pa[nn][2 * half], pa[nn][2 * half + 1], d2);
          split_pair(sa[nn][2 * half], sa[nn][2 * half + 1], a2);
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl) {
            *reinterpret_cast<uint32_t*>(ds_s + pl * kTcTile * kDsStride + o) = d2[pl];
            *reinterpret_cast<uint32_t*>(at_s + pl * kTcTile * kDsStride + o) = a2[pl];
          }
        }
      }
      __syncthreads();

      // dk and dv of the warp's 16 keys: dS^T . Q and silu(S)^T . G over
      // the tile's queries, A by transposing loads of the planes.
      const int kw = k0 + rw;  // the warp's first key
      if (kw < L) {
        // query tile qt is key tile kt's last at nt - 1, first at kt
        const bool first = qt == kt, last = qt == nt - 1;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const bf16* plane = which == 0 ? ds_s : at_s;
          const bf16* rhs = which == 0 ? q_s : g_s;
          uint32_t a[4][kPlanes][4];
          bool live[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            live[kk] = q0 + 16 * kk < L && q0 + 16 * kk + 15 >= kw;
            if (live[kk]) {
              const int r = 16 * kk + (lane & 7) + (lane >> 4) * 8;
              const int c = rw + ((lane >> 3) & 1) * 8;
#pragma unroll
              for (int pl = 0; pl < kPlanes; ++pl)
                ldsm_x4_trans(a[kk][pl], plane + pl * kTcTile * kDsStride + r * kDsStride + c);
            }
          }
#pragma unroll
          for (int dn = 0; dn < kDimTiles; dn += 2) {  // two dim tiles a B load
            float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if (live[kk]) {
                uint32_t b4[4];  // matrices: (k 0-7, dn), (k 8-15, dn), then dn + 1
                ldsm_x4_trans(b4, rhs + (16 * kk + (lane & 15)) * kRow + 8 * dn + (lane >> 4) * 8);
                const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
#pragma unroll
                for (int pl = 0; pl < kPlanes; ++pl) {
                  mma_16816(acc[0], a[kk][pl], b0);
                  mma_16816(acc[1], a[kk][pl], b1);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
              emit_frag(acc[j], kw, 8 * (dn + j), lane, L, hd, first, last,
                        which == 0 ? dk32 : dv32, which == 0 ? dk_out : dv_out);
          }
        }
      }
    }
  }

  // The tables: dpos gets every visible ds in bucket pb0 (a fixed xor tree
  // in the warp, the warps in order), dtime each bucket's bins in thread
  // order, 4 partial sums.
  float s = dpos;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();
  if (lane == 0) red[warp] = s;
  __syncthreads();
  const float total = (red[0] + red[1]) + (red[2] + red[3]);
  for (int n = tid; n < p.nb; n += kTcThreads)
    p.dpt[(size_t)bh * p.nb + n] = n == pb0 ? total : 0.f;  // no other bucket is visible
  for (int n = tid; n < ntb; n += kTcThreads) {
    const float* row = bins + n * kBinStride;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < kTcThreads; i += 4)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[j] += row[i + j];
    p.dtt[(size_t)bh * ntb + n] = (part[0] + part[1]) + (part[2] + part[3]);
  }
}

// The per-(b, h) table sums summed over b: a warp per (h, bucket) of dpos
// then dtime, lane j adding rows b = j, j + 32, ... in order, then a fixed
// xor tree.
__global__ void __launch_bounds__(256) hstu_tables_sum_kernel(Params p, float* dpos,
                                                               float* dtime, int B) {
  const int w = (blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n_pos = p.H * p.nb;
  if (w >= n_pos + p.H * p.ntb) return;
  const bool pos = w < n_pos;
  const int x = pos ? w : w - n_pos;
  const int width = pos ? p.nb : p.ntb;
  const int h = x / width;
  const float* part = (pos ? p.dpt : p.dtt) + (size_t)h * width + (x - h * width);
  float s = 0.f;
  for (int b = lane; b < B; b += 32) s += part[(size_t)b * p.H * width];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) (pos ? dpos : dtime)[x] = s;
}

size_t meta_bytes(const Params& p) {
  return (size_t)(p.nb + p.ntb) * sizeof(float) + (size_t)(5 * kTile + kTimeEdges) * sizeof(int);
}

size_t fwd_smem(const Params& p) {
  return meta_bytes(p) +
         (size_t)(kTile * p.hd + kTile * (p.hd + 1) + kTile * p.hd + kTile * kStride) *
             sizeof(float);
}

size_t bwd_smem(const Params& p) {
  return meta_bytes(p) +
         (size_t)(kWarps * (p.nb + p.ntb) + 2 * kTile * p.hd + 2 * kTile * (p.hd + 1) +
                  2 * kTile * kStride) *
             sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& p, int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_tc(dim3 grid, cudaStream_t stream, const Params& p) {
  return launch(hstu_bwd_tc_kernel<HDP>, grid, TcSmem<HDP>::bytes(p.ntb), stream, p,
                kTcThreads);
}

template <int HDP>
cudaError_t launch_fwd_tc(dim3 grid, cudaStream_t stream, const Params& p) {
  return launch(hstu_fwd_tc_kernel<HDP>, grid, kFwdHeads * FwdSmem<HDP>::kBytes, stream, p,
                FwdCfg<HDP>::kThreads);
}

Params make_params(const void* q, const void* k, const void* v, const void* ts,
                   const void* pad, const void* seg, const void* ptab, const void* ttab,
                   const int* time_edges, int B, int H, int L, int hd, int nb, int ntb,
                   int max_exact, float log_ratio) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ts = static_cast<const int*>(ts);
  p.pad = static_cast<const unsigned char*>(pad);
  p.seg = static_cast<const int*>(seg);
  p.ptab = static_cast<const float*>(ptab);
  p.ttab = static_cast<const float*>(ttab);
  p.H = H;
  p.L = L;
  p.hd = hd;
  p.nb = nb;
  p.ntb = ttab ? ntb : 0;
  p.max_exact = max_exact;
  p.BH = B * H;
  p.log_ratio = log_ratio;
  if (ttab)
    for (int i = 0; i < kTimeEdges; ++i) p.time_edges[i] = time_edges[i];
  return p;
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity); ts, seg and ttab may be null. `bf16` selects
// __nv_bfloat16 for q, k, v, g and the outputs (else float); tables,
// partials and the dq scratch are float, timestamps and segments int32,
// pad uint8. time_edges: kTimeEdges ints in host memory
// (time_bucket_edges), required with ttab. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = ok); hd must be in
// [1, 128].
extern "C" int hstu_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* ts, const void* pad, const void* seg,
                                  const void* ptab, const void* ttab, void* out,
                                  const int* time_edges, int B, int H, int L, int hd, int nb,
                                  int ntb, int max_exact, float log_ratio, int bf16,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || L == 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim || (ttab && !time_edges)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, ts, pad, seg, ptab, ttab, time_edges, B, H, L, hd, nb, ntb,
                         max_exact, log_ratio);
  p.out = out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return (int)launch(hstu_fwd_kernel<float>, dim3(B * H, (L + kTile - 1) / kTile),
                       fwd_smem(p), st, p);
  const dim3 grid((B * H + kFwdHeads - 1) / kFwdHeads, (L + kFwdTile - 1) / kFwdTile);
  if (hd <= 16) return (int)launch_fwd_tc<16>(grid, st, p);
  if (hd <= 32) return (int)launch_fwd_tc<32>(grid, st, p);
  if (hd <= 64) return (int)launch_fwd_tc<64>(grid, st, p);
  return (int)launch_fwd_tc<128>(grid, st, p);
}

// The fp32 scratch the backward takes, in floats: fp32 inputs, dq's sums
// (B, H, L, hd), which dq may alias; bf16 inputs, the sums of dq, dk and
// dv across tiles, three such planes where L > kTcTile, else none.
extern "C" long long hstu_attention_bwd_scratch(int B, int H, int L, int hd, int bf16) {
  const long long n = (long long)B * H * L * hd;
  return bf16 ? (L > kTcTile ? 3 * n : 0) : n;
}

// dq32: the scratch above (null when it is empty). dpt (B*H, nb) and dtt
// (B*H, ntb, null without a time table) receive the per-(b, h) bucket
// sums; where dpos is not null, a second launch sums them over b into
// dpos (H, nb) and dtime (H, ntb). time_edges as for the forward.
extern "C" int hstu_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* ts, const void* pad,
                                  const void* seg, const void* ptab, const void* ttab,
                                  void* dq32, void* dq, void* dk, void* dv, void* dpt,
                                  void* dtt, void* dpos, void* dtime, const int* time_edges,
                                  int B, int H, int L, int hd, int nb, int ntb, int max_exact,
                                  float log_ratio, int bf16, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || L == 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim || (ttab && !time_edges)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, ts, pad, seg, ptab, ttab, time_edges, B, H, L, hd, nb, ntb,
                         max_exact, log_ratio);
  p.g = g;
  p.dq32 = static_cast<float*>(dq32);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dpt = static_cast<float*>(dpt);
  p.dtt = ttab ? static_cast<float*>(dtt) : nullptr;
  const dim3 grid(B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.plane = (size_t)B * H * L * hd;
  if (!bf16) err = launch(hstu_bwd_kernel<float>, grid, bwd_smem(p), st, p);
  else if (p.ntb > 255) err = cudaErrorInvalidValue;  // buckets are packed in bytes
  else if (hd <= 16) err = launch_tc<16>(grid, st, p);
  else if (hd <= 32) err = launch_tc<32>(grid, st, p);
  else if (hd <= 64) err = launch_tc<64>(grid, st, p);
  else err = launch_tc<128>(grid, st, p);
  if (err != cudaSuccess || !dpos) return (int)err;
  const int warps = H * (nb + p.ntb);
  hstu_tables_sum_kernel<<<(warps + 7) / 8, 256, 0, st>>>(p, static_cast<float*>(dpos),
                                                           static_cast<float*>(dtime), B);
  return (int)cudaGetLastError();
}

extern "C" const char* hstu_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
