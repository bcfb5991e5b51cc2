// Paged decode attention, flash statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel genrec_tpu/kernels/paged_attention.py::
// paged_attention_stats_pallas (pallas_call at :227, body _kernel at :43).
// Computes exactly what genrec_tpu/ops/paged.py::_stats_fallback computes
// (and its port, genrec_tpu_torch/kernels/paged_attention.py::
// paged_attention_stats_ref): for every slot s, beam b and head h,
//
//   score_t = (q[s,b,h,:] . K[t,h,:]) * hd^-0.5, t over ALL Pm*page positions
//             read through block_tables[s, :]; score_t = -1e9 where
//             t >= seq_lens[s] (filled, and kept inside the softmax)
//   m = max_t score_t,  l = sum_t exp(score_t - m),
//   acc = sum_t exp(score_t - m) * V[t,h,:]
//
// all in fp32. Walking every page (never stopping at seq_len) is what the
// contract needs for a fully masked slot: m stays -1e9, every position
// weighs exp(0) = 1, and acc / l is the mean of V over all positions.
//
// Bound on an H100: memory. One call must read the K and V rows of every
// page it walks, S*Pm*page*H*hd*2*4 bytes at float32 (at the serving shapes
// S=64, Pm=4, page=16, H=6, hd=64 that is 12.6 MB, 3.8 us at 3.35 TB/s);
// the arithmetic, 4*S*K*H*Pm*page*hd flops, is ~1 us at the 67 TFLOP/s of
// fp32 outside the tensor cores.
//
// Design (simple and right first; no wgmma/TMA yet):
//   - one thread block per (slot, head), 4 warps. The slot's K beam
//     queries for head h stay in shared memory for the whole walk, so the
//     K beams that share a slot's pages read each page once;
//   - a loop over all Pm block-table entries replaces the TPU's sequential
//     page grid axis: the block loads page block_tables[s,p]'s K and V rows
//     of head h into shared memory (one row is hd contiguous floats), then
//     each warp updates the running max, sum and accumulator of its beams
//     (beam b belongs to warp b % 4) with an online softmax, 32 positions
//     at a time, one position per lane;
//   - the TPU version's (8,128) padding of beams/head_dim and its
//     lane-replicated m/l blocks are tiling artefacts and are gone.
// Block-table entries are clamped into [0, P) like a JAX gather.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory, in floats:
//   q_s   [K][hd]         the slot's beam queries for head h
//   k_s   [page][hd + 1]  one page of keys; the row is padded by one float
//                         so lanes reading different rows at the same
//                         column fall in different banks
//   v_s   [page][hd]      one page of values
//   acc_s [K][hd]         unnormalised accumulators
//   m_s   [K], l_s [K]    running max and sum
//   e_s   [kWarps][32]    per-warp softmax weights of the current 32 rows
size_t smem_floats(int K, int hd, int page) {
  return (size_t)2 * K * hd + (size_t)page * (hd + 1) + (size_t)page * hd +
         (size_t)2 * K + (size_t)kWarps * 32;
}

__global__ void __launch_bounds__(kThreads)
paged_attention_stats_kernel(const float* __restrict__ q,
                             const float* __restrict__ k_pool,
                             const float* __restrict__ v_pool,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ seq_lens,
                             float* __restrict__ acc,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             int K, int H, int hd, int P, int page, int Pm,
                             float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kstride = hd + 1;

  float* q_s = smem;
  float* k_s = q_s + K * hd;
  float* v_s = k_s + page * kstride;
  float* acc_s = v_s + page * hd;
  float* m_s = acc_s + K * hd;
  float* l_s = m_s + K;
  float* e_s = l_s + K + warp * 32;

  for (int i = tid; i < K * hd; i += kThreads) {
    const int b = i / hd;
    const int d = i - b * hd;
    q_s[i] = q[((size_t)(s * K + b) * H + h) * hd + d];
    acc_s[i] = 0.f;
  }
  // -1e9 start (as the TPU kernel): a fully masked slot keeps m == -1e9.
  for (int b = tid; b < K; b += kThreads) {
    m_s[b] = kNeg;
    l_s[b] = 0.f;
  }
  const int seq_len = seq_lens[s];
  const size_t row_stride = (size_t)H * hd;

  for (int p = 0; p < Pm; ++p) {
    int pg = block_tables[s * Pm + p];
    pg = min(max(pg, 0), P - 1);
    __syncthreads();  // the previous page is consumed; init is visible
    const float* k_page = k_pool + (size_t)pg * page * row_stride + (size_t)h * hd;
    const float* v_page = v_pool + (size_t)pg * page * row_stride + (size_t)h * hd;
    for (int i = tid; i < page * hd; i += kThreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      k_s[j * kstride + d] = k_page[j * row_stride + d];
      v_s[i] = v_page[j * row_stride + d];
    }
    __syncthreads();

    for (int b = warp; b < K; b += kWarps) {
      const float* qb = q_s + b * hd;
      float m_run = m_s[b];
      float l_run = l_s[b];
      for (int j0 = 0; j0 < page; j0 += 32) {
        const int j = j0 + lane;
        float sc = -INFINITY;  // rows past the page take no part
        if (j < page) {
          const float* kj = k_s + j * kstride;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qb[d], kj[d], dot);
          sc = dot * scale;
          if (p * page + j >= seq_len) sc = kNeg;
        }
        const float m_new = fmaxf(m_run, warp_max(sc));
        const float corr = expf(m_run - m_new);
        const float e = (j < page) ? expf(sc - m_new) : 0.f;
        l_run = l_run * corr + warp_sum(e);
        m_run = m_new;
        e_s[lane] = e;
        __syncwarp();
        const int n = min(32, page - j0);
        for (int d = lane; d < hd; d += 32) {
          float a = acc_s[b * hd + d] * corr;
          for (int jj = 0; jj < n; ++jj) a = fmaf(e_s[jj], v_s[(j0 + jj) * hd + d], a);
          acc_s[b * hd + d] = a;
        }
        __syncwarp();
      }
      if (lane == 0) {
        m_s[b] = m_run;
        l_s[b] = l_run;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = tid; i < K * hd; i += kThreads) {
    const int b = i / hd;
    const int d = i - b * hd;
    acc[((size_t)(s * K + b) * H + h) * hd + d] = acc_s[i];
  }
  for (int b = tid; b < K; b += kThreads) {
    const size_t o = (size_t)(s * K + b) * H + h;
    m_out[o] = m_s[b];
    l_out[o] = l_s[b];
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity); `stream` is the caller's cudaStream_t. Launches on that
// stream without synchronising and returns cudaGetLastError() (0 = ok).
extern "C" int paged_attention_stats_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* seq_lens,
    void* acc, void* m, void* l,
    int S, int K, int H, int hd, int P, int page, int Pm, float scale,
    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || H == 0) return 0;
  const size_t smem = smem_floats(K, hd, page) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_attention_stats_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, H);
  paged_attention_stats_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)block_tables, (const int*)seq_lens,
      (float*)acc, (float*)m, (float*)l, K, H, hd, P, page, Pm, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
