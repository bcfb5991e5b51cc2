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
// the same reason). Each distance is one sequential FMA chain over d in
// increasing order and each |c_k|^2 a sequential sum, so the result is the
// same on every run; it differs from the plain version's matrix product
// only in summation order (callers compare ids outside near ties).
//
// Bound on an H100: operations. 2*B*K*D*L fp32 FLOPs (0.20 GFLOP for one
// 4,096-row export chunk at K=256, D=32, L=3: 3 us at 67 TFLOP/s) against
// B*D*8 + L*K*D*4 + B*L*4 bytes (~1.2 MB, ~0.4 us at 3.35 TB/s).
//
// Design (register tiles; the first design, one warp a row and one FMA a
// shared-memory load, waited on every level's staging):
//   - a block of kBlockRows = 32 rows and 8 warps (one block an SM at the
//     export's widths); a warp owns 4 rows for the whole cascade (their
//     residuals and running sums in shared memory), so levels need no
//     block-wide barrier once the codebooks are staged;
//   - every level's codebook is copied into shared memory at block start
//     (level 0 first, the rest landing while level 0 is scored), and each
//     |c_k|^2 is computed once. At the export's widths (D = 32, K <= 256, K
//     a multiple of 8) one TMA box a level does it: 16-byte cp.async from
//     every thread reached only ~16 bytes a ns an SM (a request limit, not
//     bandwidth). Elsewhere cp.async, and where the L codebooks do not fit
//     a block (K x D x L x 4 bytes above ~220 KB), one level at a time
//     behind barriers;
//   - each thread scores a register tile of kTileRows = 4 rows x
//     kTileCols = 8 codewords (lane j takes codewords j, j + 32, ..., as
//     the first design did): per 4 values of d, 4 float4 reads of the
//     rows (the same address across the warp: a broadcast) and 8 float4
//     reads of codewords feed 128 FMAs. Codeword rows are kept conflict-
//     free for the float4 reads by an XOR of their 16-byte chunks with
//     k & 7 where a row is a multiple of 32 floats (the TMA's 128-byte
//     swizzle lays a 128-byte row out so), else by padding it to an odd
//     multiple of 4 floats. d is padded with zeros to a multiple of 4,
//     which adds exact zeros to every chain;
//   - each lane keeps its first minimum (strict <, increasing k), and a
//     warp shuffle takes the minimum across lanes, ties to the lower
//     index: the first-occurrence argmin, with the first design's bits;
//   - the TPU's one-hot matmul gather, its (L, B) id layout and its pads
//     of B, D and K to 128 are gone: the chosen codeword is read by index,
//     and ragged B and K are masked.

#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kTileRows = 4;   // rows a thread scores
constexpr int kTileCols = 8;   // codewords a thread scores per chunk
constexpr int kBlockRows = 32;  // rows a block
constexpr int kWarps = kBlockRows / kTileRows;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32 * kTileCols;  // codewords a warp scores per chunk

__host__ __device__ inline int round4(int d) { return (d + 3) & ~3; }

// Floats between codeword rows in shared memory: a multiple of 32 (its
// 16-byte chunks XOR-swizzled by k & 7), else an odd multiple of 4.
__host__ __device__ inline int row_stride(int D) {
  const int d4 = round4(D);
  return d4 % 32 == 0 ? d4 : ((d4 + 7) & ~7) + 4;
}

// Offset of element d of codeword k's row.
__device__ __forceinline__ int at(int k, int d, bool swz) {
  return swz ? ((((d >> 2) ^ (k & 7)) << 2) | (d & 3)) : d;
}

// Dynamic shared memory, in floats (each array 16-byte aligned but c2_s):
//   res_s [kBlockRows][D4]  the block's residuals
//   qs_s  [kBlockRows][D4]  the block's running sums
//   cb_s  [staged][K][S]    the staged codebooks
//   c2_s  [staged][K]       their squared norms
size_t smem_floats(int staged, int K, int D) {
  return (size_t)2 * kBlockRows * round4(D) + (size_t)staged * K * (row_stride(D) + 1);
}

// The dynamic shared memory a block asks: the arrays above and 1 KB to
// align them.
size_t smem_bytes(int staged, int K, int D) { return smem_floats(staged, K, D) * 4 + 1024; }

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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

// Copies levels [l0, l1) of the codebooks into consecutive slots at dst:
// 16-byte cp.async where rows are 16-byte multiples, else plain loads, the
// pad of d written as zeros either way. Row k of the copy is codeword
// k % K of its level, which sets its swizzle.
__device__ void stage(float* dst, const float* codebooks, int l0, int l1, int K, int D) {
  const int S = row_stride(D);
  const bool swz = S % 32 == 0;
  const int d4 = round4(D);
  const float* src = codebooks + (size_t)l0 * K * D;
  const int n = (l1 - l0) * K;  // codeword rows
  if (D % 4 == 0) {
    const int chunks = d4 / 4;
    for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
      const int k = i / chunks;
      const int c = i - k * chunks;
      cp_async_16(dst + (size_t)k * S + 4 * (swz ? c ^ (k % K & 7) : c),
                  src + (size_t)k * D + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * d4; i += kThreads) {
      const int k = i / d4;
      const int d = i - k * d4;
      dst[(size_t)k * S + at(k % K, d, swz)] = d < D ? src[(size_t)k * D + d] : 0.f;
    }
  }
}

// |c_k|^2 of n staged codeword rows (of levels of K), each a sequential
// sum over d (the zero pad past D adds exact zeros), from float4 reads.
__device__ void norms(const float* cb, float* c2, int n, int K, int D) {
  const int S = row_stride(D);
  const int d4 = round4(D);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float* ck = cb + (size_t)k * S;
    const int x = S % 32 == 0 ? k % K & 7 : 0;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < d4; d += 4) {
      const float4 c = *reinterpret_cast<const float4*>(ck + (((d >> 2) ^ x) << 2));
      s = fmaf(c.x, c.x, s);
      s = fmaf(c.y, c.y, s);
      s = fmaf(c.z, c.z, s);
      s = fmaf(c.w, c.w, s);
    }
    c2[k] = s;
  }
}

// `staged` is L (every codebook staged at block start) or 1 (one level at
// a time); with `tma`, the codebooks (L * K rows of D = 32 floats) come by
// `map`, a box of K rows a level.
__global__ void __launch_bounds__(kThreads)
rq_cascade_kernel(const float* __restrict__ x, const float* __restrict__ codebooks,
                  int* __restrict__ ids, float* __restrict__ qsum, int B, int D, int L, int K,
                  int staged, const __grid_constant__ CUtensorMap map, int tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The TMA's 128-byte swizzle needs 1 KB aligned boxes: the front of the
  // block's memory, rounded up (the launch asks 1 KB more).
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023));
  const int S = row_stride(D);
  const bool swz = S % 32 == 0;
  const int d4 = round4(D);
  float* res_s = smem;
  float* qs_s = res_s + kBlockRows * d4;
  float* cb_s = qs_s + kBlockRows * d4;
  float* c2_s = cb_s + (size_t)staged * K * S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kBlockRows;
  const int nrows = min(kBlockRows, B - row0);
  const int r0 = warp * kTileRows;  // the warp's first row in the block
  const bool all = staged == L;

  __shared__ uint64_t bars[2];  // with tma: level 0, the rest
  if (tma) {
    if (tid == 0) {
      sm90::mbar_init(&bars[0], 1);
      sm90::mbar_init(&bars[1], 1);
      sm90::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      sm90::mbar_expect_tx(&bars[0], K * D * 4);
      sm90::tma_load_2d(cb_s, &map, &bars[0], 0, 0);
      sm90::mbar_expect_tx(&bars[1], (L - 1) * K * D * 4);
      for (int l = 1; l < L; ++l) sm90::tma_load_2d(cb_s + (size_t)l * K * S, &map, &bars[1], 0, l * K);
    }
  } else if (all) {  // level 0, then the rest: two groups, the second maybe empty
    stage(cb_s, codebooks, 0, 1, K, D);
    cp_async_commit();
    stage(cb_s + (size_t)K * S, codebooks, 1, L, K, D);
    cp_async_commit();
  }
  for (int i = tid; i < kBlockRows * d4; i += kThreads) {
    const int r = i / d4;
    const int d = i - r * d4;
    res_s[i] = (r < nrows && d < D) ? x[(size_t)(row0 + r) * D + d] : 0.f;
    qs_s[i] = 0.f;
  }

  for (int l = 0; l < L; ++l) {
    if (!all) {
      __syncthreads();  // the previous level's codebook is no longer read
      stage(cb_s, codebooks, l, l + 1, K, D);
      cp_async_commit();
      cp_async_wait_group<0>();
      __syncthreads();
      norms(cb_s, c2_s, K, K, D);
      __syncthreads();
    } else if (l <= 1) {
      if (tma) sm90::mbar_wait(&bars[l], 0);
      else if (l == 0) cp_async_wait_group<1>();
      else cp_async_wait_group<0>();
      __syncthreads();
      const int n = l == 0 ? K : (L - 1) * K;
      norms(cb_s + (size_t)l * K * S, c2_s + (size_t)l * K, n, K, D);
      __syncthreads();
    }
    const int slot = all ? l : 0;
    const float* cb = cb_s + (size_t)slot * K * S;
    const float* c2 = c2_s + (size_t)slot * K;
    if (r0 >= nrows) continue;

    float best[kTileRows];
    int best_k[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      best[r] = INFINITY;
      best_k[r] = K;  // beats nothing: any real codeword replaces it
    }
    const int xor7 = lane & 7;  // k & 7 of every codeword of this lane
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const float* crow[kTileCols];
#pragma unroll
      for (int i = 0; i < kTileCols; ++i)  // rows past K read row K - 1, unused
        crow[i] = cb + (size_t)min(k0 + lane + 32 * i, K - 1) * S;
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int i = 0; i < kTileCols; ++i) acc[r][i] = 0.f;
      for (int d = 0; d < d4; d += 4) {
        const int pd = swz ? ((d >> 2) ^ xor7) << 2 : d;
        float4 rv[kTileRows];
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
          rv[r] = *reinterpret_cast<const float4*>(res_s + (r0 + r) * d4 + d);
#pragma unroll
        for (int i = 0; i < kTileCols; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(crow[i] + pd);
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
            float a = acc[r][i];
            a = fmaf(rv[r].x, cv.x, a);
            a = fmaf(rv[r].y, cv.y, a);
            a = fmaf(rv[r].z, cv.z, a);
            a = fmaf(rv[r].w, cv.w, a);
            acc[r][i] = a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTileCols; ++i) {
        const int k = k0 + lane + 32 * i;
        if (k < K) {
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
            const float dist = c2[k] - 2.0f * acc[r][i];
            if (dist < best[r]) {  // strict: the lane keeps its first minimum
              best[r] = dist;
              best_k[r] = k;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[r], o);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[r], o);
        if (ob < best[r] || (ob == best[r] && ok < best_k[r])) {
          best[r] = ob;
          best_k[r] = ok;
        }
      }
    }
    // Every lane holds the same (best, best_k) of each row. A row whose
    // distances are all NaN keeps best_k == K and takes codeword 0, so the
    // read below stays inside the codebook.
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (r0 + r < nrows) {
        const int id = best_k[r] < K ? best_k[r] : 0;
        const float* cid = cb + (size_t)id * S;
        float* rr = res_s + (r0 + r) * d4;
        float* qq = qs_s + (r0 + r) * d4;
        for (int d = lane; d < D; d += 32) {
          const float c = cid[at(id, d, swz)];
          rr[d] = rr[d] - c;
          qq[d] = qq[d] + c;
        }
        if (lane == 0) ids[(size_t)(row0 + r0 + r) * L + l] = id;
      }
    }
    __syncwarp();  // the next level reads the rows the lanes just wrote
  }
  for (int r = 0; r < kTileRows; ++r)
    if (r0 + r < nrows)
      for (int d = lane; d < D; d += 32)
        qsum[(size_t)(row0 + r0 + r) * D + d] = qs_s[(r0 + r) * d4 + d];
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors (the Python wrapper checks dtype, shape, device and
// contiguity); `stream` is the caller's cudaStream_t. Launches on that
// stream without synchronising and returns cudaGetLastError() (0 = ok);
// cudaErrorInvalidValue when one level's codebook does not fit a block.
extern "C" int rq_cascade_f32(const void* x, const void* codebooks, void* ids, void* qsum,
                              int B, int D, int L, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int staged = smem_bytes(L, K, D) <= (size_t)optin ? L : 1;
  const size_t smem = smem_bytes(staged, K, D);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rq_cascade_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // One TMA box (K rows of 128 bytes, the 128-byte swizzle) a level where
  // the widths allow it and cuTensorMapEncodeTiled is there.
  CUtensorMap map = {};
  int tma = staged == L && D == 32 && K <= 256 && K % 8 == 0;
  if (tma) {
    const sm90::EncodeTiled fn = sm90::encode_tiled();
    const cuuint64_t dims[2] = {32, (cuuint64_t)L * K};
    const cuuint64_t strides[1] = {32 * sizeof(float)};
    const cuuint32_t box[2] = {32, (cuuint32_t)K};
    const cuuint32_t steps[2] = {1, 1};
    tma = fn != nullptr &&
          fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(codebooks), dims,
             strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const int blocks = (B + kBlockRows - 1) / kBlockRows;
  rq_cascade_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)codebooks, (int*)ids, (float*)qsum, B, D, L, K, staged, map,
      tma);
  return (int)cudaGetLastError();
}

extern "C" const char* rq_cascade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
