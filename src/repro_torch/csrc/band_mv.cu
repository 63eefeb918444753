// The symmetric band matrix-vector product for Hopper (sm_90a): y = A x
// for symmetric A of bandwidth w held in the (n, w+1) upper band layout
// band[i, d] = A[i, i+d], d = 0..w:
//   y_i = sum_{d=0..w} band[i, d] x_{i+d} + sum_{d=1..w} band[i-d, d] x_{i-d}.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/band_mv/kernel.py). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces _band_mv_kernel behind band_mv_pallas
// (repro/kernels/band_mv/kernel.py).
//
// What bounds it: bytes, and below them the launch. Each band entry is
// read twice (its own row and its mirror) for 2 multiply-adds, far below
// any fp64 rate: at n = 9997, w = 16 the band, x and y are 1.5 MB, 0.45 us
// over 3.35 TB/s, so a launch (a few us) costs more than the work.
//
// Design. One thread per row, bm rows per block. The TPU kernel cannot
// let two blocks overlap, so it passes the band a second time as the
// previous tile for the mirrored term's w-row lookback; on CUDA the
// lookback is a plain masked read of global memory (the mirror's rows
// i-d >= 0 are read by the neighbouring threads too, so they come from
// L1/L2). The band is read through its two element strides, so both the
// row-major (n, w+1) array and the transposed view of the TT pipeline's
// (w+1, n) lower band (core/band_storage.to_band_mv_layout) go in as they
// are; in the latter, consecutive threads read consecutive words. The
// terms are summed in the reference kernel's order (d = 0..w, each upper
// term then its mirror) with explicit __fma_rn.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void band_mv_kernel(const double* __restrict__ band, int64_t s0,
                               int64_t s1, const double* __restrict__ x,
                               double* __restrict__ y, int n, int w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double acc = 0.0;
  for (int64_t d = 0; d <= w; ++d) {
    if (i + d < n) acc = __fma_rn(band[i * s0 + d * s1], x[i + d], acc);
    if (d > 0 && i - d >= 0)
      acc = __fma_rn(band[(i - d) * s0 + d * s1], x[i - d], acc);
  }
  y[i] = acc;
}

}  // namespace

extern "C" {

// y (n,) = A x; band[i, d] at band[i * s0 + d * s1], d = 0..w; x, y
// contiguous; 1 <= bm <= 1024 rows per block.
int band_mv_fp64(const double* band, int64_t s0, int64_t s1, const double* x,
                 double* y, int n, int w, int bm, cudaStream_t stream) {
  if (n < 1 || w < 0 || bm < 1 || bm > 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + bm - 1) / bm);
  // diagonals d >= n hold no entry of A
  const int wd = w < n ? w : n - 1;
  band_mv_kernel<<<blocks, bm, 0, stream>>>(band, s0, s1, x, y, n, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"
