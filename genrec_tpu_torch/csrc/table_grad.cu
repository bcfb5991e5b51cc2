// Deterministic gradient of a small table lookup for Hopper (sm_90a).
//
// Replaces no TPU kernel. It is the backward of
// genrec_tpu_torch/models/t5transformer.py::_TableLookup, the gather
// table.reshape(-1)[idx] that reads TIGER's relative-position bias grid
// (H heads x 32 buckets = 192 bins at tiger.gin widths) ~5.7 M times an
// encoder layer. Computes what
// genrec_tpu_torch/kernels/table_grad.py::table_grad_ref computes:
//
//   out[b] = sum over i with idx[i] == b of grad[i]      (fp32, b < bins)
//
// torch.bincount(weights=) computes the same on the CPU, but on CUDA it
// adds through atomics in an order that changes from run to run, so two
// identical TIGER steps differed in the last bits of rel_bias. Here every
// sum is taken in one fixed order, so a run's bits do not depend on
// scheduling: the same inputs give the same output on every call.
//
// Bound on an H100: bytes. n * (8 + 4) bytes of int64 indices and fp32
// gradients (68 MB a layer at the TIGER step's operands: ~20 us at
// 3.35 TB/s) against n additions.
//
// Design:
//   - pass 1: a fixed grid of at most kBlocks blocks of T threads; thread
//     t of block g reads elements g * T + t + k * G * T for k = 0, 1, ...
//     (coalesced: neighbouring threads read neighbouring elements) and
//     adds each into its own private copy of the bins in shared memory,
//     bins * (T + 1) floats laid out bin-major with the thread as the
//     column (a private column needs no atomic; the + 1 pad makes the
//     block's reduction below read 32 banks at once). T is the largest
//     of 128, 64, 32 whose copies fit: 192 bins x 129 x 4 B = 99 KB at
//     T = 128, within Hopper's 227 KB a block;
//   - then thread t sums bins t, t + T, ... over the block's T columns in
//     column order and writes row g of a (G, bins) buffer;
//   - pass 2: one thread a bin sums the G rows in row order.
// An index outside [0, bins) is skipped (the caller never makes one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocks = 256;
constexpr size_t kMaxSmem = 200 * 1024;

__global__ void table_grad_partial_kernel(const int64_t* __restrict__ idx,
                                          const float* __restrict__ grad, float* __restrict__ rows,
                                          long long n, int bins) {
  extern __shared__ float priv[];  // [bins][T + 1]
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int stride_row = T + 1;
  for (int j = t; j < bins * stride_row; j += T) priv[j] = 0.0f;
  __syncthreads();
  const long long step = (long long)gridDim.x * T;
  for (long long i = (long long)blockIdx.x * T + t; i < n; i += step) {
    const int64_t b = idx[i];
    if (b >= 0 && b < bins) priv[b * stride_row + t] += grad[i];
  }
  __syncthreads();
  for (int b = t; b < bins; b += T) {
    const float* row = priv + (size_t)b * stride_row;
    float s = 0.0f;
    for (int j = 0; j < T; ++j) s += row[j];
    rows[(size_t)blockIdx.x * bins + b] = s;
  }
}

__global__ void table_grad_sum_kernel(const float* __restrict__ rows, float* __restrict__ out,
                                      int n_rows, int bins) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bins) return;
  float s = 0.0f;
  for (int r = 0; r < n_rows; ++r) s += rows[(size_t)r * bins + b];
  out[b] = s;
}

size_t smem_bytes(int bins, int threads) { return (size_t)bins * (threads + 1) * sizeof(float); }

}  // namespace

// The number of rows of the scratch buffer pass 1 writes (the grid), and
// its threads a block; 0 threads when the bins do not fit a block.
extern "C" void table_grad_layout(long long n, int bins, int* blocks, int* threads) {
  int T = 128;
  while (T >= 32 && smem_bytes(bins, T) > kMaxSmem) T /= 2;
  *threads = T >= 32 ? T : 0;
  long long need = (n + 127) / 128;
  *blocks = (int)(need < kBlocks ? (need < 1 ? 1 : need) : kBlocks);
}

// idx (n,) int64, grad (n,) fp32, rows (blocks, bins) fp32 scratch, out
// (bins,) fp32; blocks and threads from table_grad_layout.
extern "C" int table_grad_f32(const void* idx, const void* grad, void* rows, void* out,
                              long long n, int bins, int blocks, int threads, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads < 32 || bins < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bins, threads);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(table_grad_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  table_grad_partial_kernel<<<blocks, threads, smem, s>>>(
      (const int64_t*)idx, (const float*)grad, (float*)rows, n, bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_grad_sum_kernel<<<(bins + 127) / 128, 128, 0, s>>>((const float*)rows, (float*)out,
                                                           blocks, bins);
  return (int)cudaGetLastError();
}

extern "C" const char* table_grad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
