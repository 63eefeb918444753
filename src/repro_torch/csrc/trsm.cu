// The diagonal-tile triangular solve of the blocked TRSM for Hopper
// (sm_90a): for one (b, b) upper-triangular tile U (b <= 128) and a (b, s)
// right-hand side X, in place,
//   U X = X     (trans = 0, back substitution), or
//   U^T X = X   (trans = 1, forward substitution).
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/trsm/kernel.py). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces _trsm_tile_upper_kernel and _trsm_tile_upper_t_kernel behind
// trsm_tile (repro/kernels/trsm/kernel.py). kernels/trsm/ops.py composes
// it with the gemm kernel into the blocked solve, as the reference's
// trsm/ops.py does.
//
// What bounds it: bytes, at the shapes of the blocked solve. Each column
// costs b^2 flops (b^2/2 multiply-adds) against 16 b bytes of X read and
// written, plus the tile once: at b = 128 and s = 9997 RHS columns the
// least time is 20.6 MB over 3.35 TB/s = 6.1 us (the flops, 1.6e8, take
// 2.4 us at the fp64 tensor peak). But the substitution is a chain of b
// dependent steps per column, so latency, not bandwidth, is what the
// kernel meets.
//
// Design. Every RHS column is an independent substitution, so there is no
// sequential grid: a block owns kCols columns and one thread owns one
// column. The block stages the whole tile in dynamic shared memory (the
// upper triangle, 128 KB at b = 128 in fp64) and its (b, kCols) slice of
// X (64 KB), solves in shared memory, and writes its slice back. At step
// i every thread reads the same entry of U (a broadcast, no bank
// conflict) and its own column of X (consecutive threads, consecutive
// words). Each column is summed in order with explicit __fma_rn (the
// build's --fmad=false does not touch them), then divided by U(i, i).
// No thread reads another's column, so the solve needs no barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 128;
constexpr int kCols = 64;     // RHS columns (and threads) per block

__global__ void __launch_bounds__(kCols)
trsm_tile_kernel(const double* __restrict__ U, int64_t ldu, double* X,
                 int64_t ldx, int b, int s, int trans) {
  extern __shared__ double sm[];
  double* u = sm;              // (b, b) row-major, upper triangle
  double* x = sm + b * b;      // (b, kCols)
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kCols;
  for (int e = tid; e < b * b; e += kCols) {
    const int i = e / b;
    const int j = e % b;
    u[e] = j >= i ? U[(int64_t)i * ldu + j] : 0.0;
  }
  for (int e = tid; e < b * kCols; e += kCols) {
    const int r = e / kCols;
    const int c = e % kCols;
    x[e] = c0 + c < s ? X[(int64_t)r * ldx + c0 + c] : 0.0;
  }
  __syncthreads();

  double* xc = x + tid;        // this thread's column, stride kCols
  if (!trans) {
    for (int i = b - 1; i >= 0; --i) {
      double acc = xc[i * kCols];
      const double* ui = u + i * b;
      for (int j = i + 1; j < b; ++j) acc = __fma_rn(-ui[j], xc[j * kCols], acc);
      xc[i * kCols] = __ddiv_rn(acc, ui[i]);
    }
  } else {
    for (int i = 0; i < b; ++i) {
      double acc = xc[i * kCols];
      for (int j = 0; j < i; ++j) acc = __fma_rn(-u[j * b + i], xc[j * kCols], acc);
      xc[i * kCols] = __ddiv_rn(acc, u[i * b + i]);
    }
  }
  __syncthreads();

  for (int e = tid; e < b * kCols; e += kCols) {
    const int r = e / kCols;
    const int c = e % kCols;
    if (c0 + c < s) X[(int64_t)r * ldx + c0 + c] = x[e];
  }
}

}  // namespace

extern "C" {

// X (b, s) row-major with row stride ldx, overwritten by U^{-1} X
// (trans = 0) or U^{-T} X (trans = 1); U (b, b) row-major with row stride
// ldu, only its upper triangle read. 1 <= b <= 128, s >= 1.
int trsm_tile_fp64(const double* U, int64_t ldu, double* X, int64_t ldx,
                   int b, int s, int trans, cudaStream_t stream) {
  if (b < 1 || b > kMaxB || s < 1) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        trsm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)kMaxB * (kMaxB + kCols) * sizeof(double)));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const size_t smem = (size_t)b * (b + kCols) * sizeof(double);
  const unsigned blocks = (unsigned)((s + kCols - 1) / kCols);
  trsm_tile_kernel<<<blocks, kCols, smem, stream>>>(U, ldu, X, ldx, b, s,
                                                    trans);
  return (int)cudaGetLastError();
}

// the largest tile the kernel holds in shared memory
int trsm_tile_max_b() { return kMaxB; }

}  // extern "C"
