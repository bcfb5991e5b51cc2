// Residual-quantisation cascade (semantic-id extraction) for Hopper (sm_90a).
//
// Replaces the TPU kernel genrec_tpu/kernels/rq_cascade.py::
// rq_cascade_pallas (pallas_call at :99, body _kernel at :38). Computes
// what genrec_tpu_torch/kernels/rq_cascade.py::rq_cascade_ref computes:
// for every row b of x (B, D) and every level l of codebooks (L, K, D),
// in order,
//
//   dist_k = |c_k|^2 - 2 * (res . c_k)      (no |res|^2: constant per row)
//   id     = first-occurrence argmin_k dist_k
//   res   -= c_id;   qsum += c_id
//
// with res starting at x and qsum at 0, all in fp32; outputs ids (B, L)
// int32 and qsum (B, D) fp32.
//
// Precision: plain fp32 FFMA, no TF32 and no tensor cores. A reduced
// precision distance flips near-tie argmins, and a flip at level 0
// changes every later level (the Pallas kernel's HIGHEST precision, for
// the same reason). Each distance is one sequential FMA chain over d, so
// it is the same on every run; it differs from the plain version's
// matrix product only in summation order (callers compare ids outside
// near ties).
//
// Bound on an H100: operations. 2*B*K*D*L fp32 FLOPs (0.60 GFLOP for the
// 12,101-item export at K=256, D=32, L=3: ~9 us at 67 TFLOP/s) against
// B*D*8 + L*K*D*4 + B*L*4 bytes (~3.3 MB, ~1 us at 3.35 TB/s).
//
// Design (simple and right first):
//   - one block of 8 warps per kRows = 32 rows; each warp owns 4 rows;
//   - the rows' residuals and running sums sit in shared memory for the
//     whole cascade; one level's codebook at a time is staged in shared
//     memory with rows padded to D + 1 floats (lanes reading codewords
//     lane, lane + 32, ... at one d fall in distinct banks), with its
//     |c_k|^2 (a sequential sum over d);
//   - per row, lane j scores codewords j, j + 32, ... in chunks of 256
//     (8 accumulators a lane, the residual element read once per d for
//     all 8), keeps its first minimum (strict <, increasing k), and a warp
//     shuffle takes the minimum across lanes, ties to the lower index;
//   - the TPU's one-hot matmul gather, its (L, B) id layout and its pads
//     of B, D and K to 128 are gone: the chosen codeword is read by index,
//     and ragged B and K are masked.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;          // rows per block
constexpr int kPerLane = 8;        // codewords a lane scores per chunk
constexpr int kChunk = 32 * kPerLane;

// Dynamic shared memory, in floats:
//   cb_s  [K][D + 1]   one level's codebook
//   c2_s  [K]          its squared norms
//   res_s [kRows][D]   the block's residuals
//   qs_s  [kRows][D]   the block's running sums
size_t smem_floats(int K, int D) {
  return (size_t)K * (D + 1) + (size_t)K + (size_t)2 * kRows * D;
}

__global__ void __launch_bounds__(kThreads)
rq_cascade_kernel(const float* __restrict__ x, const float* __restrict__ codebooks,
                  int* __restrict__ ids, float* __restrict__ qsum,
                  int B, int D, int L, int K) {
  extern __shared__ float smem[];
  const int cstride = D + 1;
  float* cb_s = smem;
  float* c2_s = cb_s + (size_t)K * cstride;
  float* res_s = c2_s + K;
  float* qs_s = res_s + kRows * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  for (int i = tid; i < nrows * D; i += kThreads) {
    res_s[i] = x[(size_t)row0 * D + i];
    qs_s[i] = 0.f;
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the previous level's codebook is no longer read
    const float* cb = codebooks + (size_t)l * K * D;
    for (int i = tid; i < K * D; i += kThreads) {
      const int k = i / D;
      cb_s[k * cstride + (i - k * D)] = cb[i];
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      const float* ck = cb_s + k * cstride;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(ck[d], ck[d], s);
      c2_s[k] = s;
    }
    __syncthreads();

    for (int r = warp; r < nrows; r += kWarps) {
      const float* res = res_s + r * D;
      float best = INFINITY;
      int best_k = K;  // beats nothing: any real codeword replaces it
      for (int k0 = 0; k0 < K; k0 += kChunk) {
        float acc[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float rd = res[d];
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int k = k0 + lane + 32 * i;
            if (k < K) acc[i] = fmaf(rd, cb_s[k * cstride + d], acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int k = k0 + lane + 32 * i;
          if (k < K) {
            const float dist = c2_s[k] - 2.0f * acc[i];
            if (dist < best) {  // strict: the lane keeps its first minimum
              best = dist;
              best_k = k;
            }
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k, o);
        if (ob < best || (ob == best && ok < best_k)) {
          best = ob;
          best_k = ok;
        }
      }
      // Every lane holds the same (best, best_k). A row whose distances
      // are all NaN keeps best_k == K and takes codeword 0, so the read
      // below stays inside the codebook.
      const int id = best_k < K ? best_k : 0;
      const float* cid = cb_s + id * cstride;
      float* rr = res_s + r * D;
      float* qq = qs_s + r * D;
      for (int d = lane; d < D; d += 32) {
        const float c = cid[d];
        rr[d] = rr[d] - c;
        qq[d] = qq[d] + c;
      }
      if (lane == 0) ids[(size_t)(row0 + r) * L + l] = id;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += kThreads) qsum[(size_t)row0 * D + i] = qs_s[i];
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity); `stream` is the caller's cudaStream_t. Launches on that
// stream without synchronising and returns cudaGetLastError() (0 = ok).
extern "C" int rq_cascade_f32(const void* x, const void* codebooks, void* ids, void* qsum,
                              int B, int D, int L, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  const size_t smem = smem_floats(K, D) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rq_cascade_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kRows - 1) / kRows;
  rq_cascade_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)codebooks, (int*)ids, (float*)qsum, B, D, L, K);
  return (int)cudaGetLastError();
}

extern "C" const char* rq_cascade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
