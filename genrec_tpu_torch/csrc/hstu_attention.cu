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
// clipped to the table, with the float32 log correctly rounded (taken in
// double) as on the CPU, and the library is built without --use_fast_math,
// so a bucket edge never moves by an ulp. Scores and sums
// are fp32 from fp32 or bf16 inputs; with bf16 inputs silu(s) is rounded to
// bf16 before it meets v, as the Pallas kernel's attn.astype(v.dtype) does.
//
// Backward (flash style, nothing saved but the inputs): recompute s, then
//   ds_ij = (g_i . v_j) sig(s) (1 + s (1 - sig(s))), exactly 0 where masked
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i silu(s_ij) g_i
//   dpos[h, n] = sum over pairs in bucket n of ds, dtime likewise,
// written per (b, h) and summed over b by the wrapper (fixed order).
//
// Bound on an H100 at the HSTU training shapes (B=128, H=2, L=50, hd=32,
// bf16): memory for the forward (3.3 MB of q/k/v/out, ~1 us) and the
// backward (~6.6 MB, ~2 us); the causal half of 4*L*L*hd*B*H FLOP is
// ~41 MFLOP, far below either. At these sizes launch and latency decide.
//
// Design (simple and right first; no wgmma/TMA):
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // queries and keys per tile
constexpr int kMaxHeadDim = 128;
constexpr int kOwn = kTile * kMaxHeadDim / kThreads;  // outputs a thread owns
constexpr int kStride = kTile + 1;  // row stride of the score tiles

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
  float* dq32;                 // backward: fp32 dq scratch (B, H, L, hd)
  void* dq;
  void* dk;
  void* dv;
  float* dpt;                  // (B*H, nb) partials
  float* dtt;                  // (B*H, ntb) partials or null
  int H, L, hd, nb, ntb, max_exact;
  float log_ratio;             // log(max_position_distance / max_exact)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value the input dtype would hold (Pallas: attn.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// genrec_tpu/ops/buckets.py::hstu_position_bucket, float32 as there (the log
// correctly rounded, as in time_bucket).
__device__ __forceinline__ int pos_bucket(int rel, const Params& p) {
  const int rp = rel > 0 ? rel : 0;
  if (rp < p.max_exact) return rp;
  const float x = (float)(rp > 1 ? rp : 1) / (float)p.max_exact;
  const float f = (float)log((double)x) / p.log_ratio *
                  (float)(p.nb - p.max_exact);
  const int large = p.max_exact + (int)f;
  return large < p.nb - 1 ? large : p.nb - 1;
}

// genrec_tpu/ops/buckets.py::hstu_log_bucket of t_q - t_k, int32 wrap as there.
// The float32 log is taken in double and rounded, which gives the correctly
// rounded logf the CPU computes: CUDA's logf is off by one ulp on some
// inputs, and one ulp moves thousands of large |dt| across a bucket edge.
__device__ __forceinline__ int time_bucket(int tq, int tk, int ntb) {
  const int diff = (int)((unsigned)tq - (unsigned)tk);
  const int a = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);
  const float lg = (float)log((double)(float)(a > 1 ? a : 1));
  const int b = (int)(lg / 0.693f);
  return b < 0 ? 0 : (b > ntb - 1 ? ntb - 1 : b);
}

__device__ __forceinline__ float sigmoid(float s) { return 1.f / (1.f + expf(-s)); }

// Shared memory common to both directions, carved from the front.
struct Tiles {
  float* ptab;   // [nb]
  float* ttab;   // [ntb]
  int* tq;       // [kTile] query timestamps, segments
  int* sq;
  int* tk;       // [kTile] key timestamps, segments, padding
  int* sk;
  int* pk;
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
  t.rest = reinterpret_cast<float*>(t.pk + kTile);
  return t;
}

__device__ void load_tables(const Tiles& t, const Params& p, int h) {
  for (int i = threadIdx.x; i < p.nb; i += kThreads) t.ptab[i] = p.ptab[h * p.nb + i];
  if (p.ttab)
    for (int i = threadIdx.x; i < p.ntb; i += kThreads) t.ttab[i] = p.ttab[h * p.ntb + i];
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
    *tb = time_bucket(t.tq[i], t.tk[j], p.ntb);
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

size_t meta_bytes(const Params& p) {
  return (size_t)(p.nb + p.ntb) * sizeof(float) + (size_t)5 * kTile * sizeof(int);
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
                   const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* ts,
                   const void* pad, const void* seg, const void* ptab, const void* ttab,
                   int H, int L, int hd, int nb, int ntb, int max_exact, float log_ratio) {
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
  p.log_ratio = log_ratio;
  return p;
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity); ts, seg and ttab may be null. `bf16` selects
// __nv_bfloat16 for q, k, v, g and the outputs (else float); tables,
// partials and the dq scratch are float, timestamps and segments int32,
// pad uint8. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = ok); hd must be in [1, 128].
extern "C" int hstu_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* ts, const void* pad, const void* seg,
                                  const void* ptab, const void* ttab, void* out, int B,
                                  int H, int L, int hd, int nb, int ntb, int max_exact,
                                  float log_ratio, int bf16, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || L == 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, ts, pad, seg, ptab, ttab, H, L, hd, nb, ntb, max_exact,
                         log_ratio);
  p.out = out;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch(hstu_fwd_kernel<__nv_bfloat16>, grid, fwd_smem(p), st, p)
             : launch(hstu_fwd_kernel<float>, grid, fwd_smem(p), st, p);
  return (int)err;
}

// dq32: fp32 scratch (B, H, L, hd), fully written; dq may alias it when
// the inputs are float. dpt (B*H, nb) and dtt (B*H, ntb, null without a
// time table) receive the per-(b, h) bucket sums.
extern "C" int hstu_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* ts, const void* pad,
                                  const void* seg, const void* ptab, const void* ttab,
                                  void* dq32, void* dq, void* dk, void* dv, void* dpt,
                                  void* dtt, int B, int H, int L, int hd, int nb, int ntb,
                                  int max_exact, float log_ratio, int bf16, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || L == 0) return 0;
  if (hd < 1 || hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, ts, pad, seg, ptab, ttab, H, L, hd, nb, ntb, max_exact,
                         log_ratio);
  p.g = g;
  p.dq32 = static_cast<float*>(dq32);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dpt = static_cast<float*>(dpt);
  p.dtt = ttab ? static_cast<float*>(dtt) : nullptr;
  const dim3 grid(B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch(hstu_bwd_kernel<__nv_bfloat16>, grid, bwd_smem(p), st, p)
             : launch(hstu_bwd_kernel<float>, grid, bwd_smem(p), st, p);
  return (int)err;
}

extern "C" const char* hstu_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
