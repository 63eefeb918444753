// The symmetric band matrix-vector product for Hopper (sm_90a): y = A x
// for symmetric A of bandwidth w held in the (n, w+1) upper band layout
// band[i, d] = A[i, i+d], d = 0..w:
//   y_i = sum_{d=0..w} band[i, d] x_{i+d} + sum_{d=1..w} band[i-d, d] x_{i-d}.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/band_mv/kernel.py). The entry points launch on the
// caller's stream, allocate nothing and return cudaGetLastError().
//
// Replaces _band_mv_kernel behind band_mv_pallas
// (repro/kernels/band_mv/kernel.py).
//
// What bounds it: bytes, and below them the launch. Each band entry is
// read twice (its own row and its mirror) for 2 multiply-adds, far below
// any fp64 rate: at n = 9997, w = 16 the band, x and y are 1.5 MB, 0.45 us
// over 3.35 TB/s, so a launch (a few us) costs more than the work.
//
// Design. A block of bm rows [r0, r0 + bm), a thread a row. The block
// first stages what its rows read into shared memory, once: the band rows
// [r0 - w, r0 + bm) (the mirror terms reach w rows back; the TPU kernel
// passes the band a second time as the previous tile for that) and
// x[r0 - w, r0 + bm + w), by cp.async, every copy issued before any is
// waited for (a staging loop of plain loads waits a round trip a pass).
// The band is read through its two element strides: in the row-major
// (n, w+1) array with w + 1 odd the block's rows are one contiguous run,
// copied as it is, 16 bytes a copy (a warp's 32 rows then read words
// w + 1 apart: an odd stride, no bank conflict); any other layout goes
// diagonal-major, rows padded to an odd count, 8 bytes a copy, which in
// the transposed view of the TT pipeline's (w+1, n) lower band
// (core/band_storage.to_band_mv_layout, strides (1, n)) coalesce, as a
// diagonal's rows are contiguous there. Each row then sums its
// terms from shared memory in the reference kernel's order (d = 0..w,
// each upper term then its mirror) with explicit __fma_rn, the order of
// the direct kernel (a thread a row reading global memory, the first
// design), which stays for windows beyond kStagedSmemMax; the two agree
// bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStagedSmemMax = 48 * 1024;  // no opt-in attribute needed

__global__ void band_mv_direct(const double* __restrict__ band, int64_t s0,
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

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem)
               : "memory");
}

// kRaw: the band's rows [a, b) are one contiguous run (row-major, w + 1
// odd), copied as it is, 16 bytes a copy; else diagonal-major, rows padded
// to odd (ldr), 8 bytes a copy. w: the diagonals that hold entries
// (min(w, n - 1)); wp1: the band's columns; band_words: the doubles the
// band's part of shared memory takes (x's window follows it).
template <bool kRaw>
__global__ void band_mv_staged(const double* __restrict__ band, int64_t s0,
                               int64_t s1, const double* __restrict__ x,
                               double* __restrict__ y, int n, int w, int wp1,
                               int ldr, int band_words) {
  extern __shared__ __align__(16) double sm[];
  const int r0 = blockIdx.x * blockDim.x;
  const int a = max(0, r0 - w);                     // window rows [a, b)
  const int b = min(n, r0 + (int)blockDim.x);
  const int R = b - a;
  const int xb = min(n, r0 + (int)blockDim.x + w);  // x window [a, xb)
  double* sx = sm + band_words;                     // sx[r - a]
  double* sB = sm;
  // every copy is issued before any is waited for: one round trip
  for (int i = threadIdx.x; i < xb - a; i += blockDim.x)
    cp_async8(sx + i, x + a + i);
  if (kRaw) {
    // sB[(r - a) * wp1 + d]; sB sits at the run's alignment mod 16
    const double* src = band + (int64_t)a * wp1;
    const int len = R * wp1;
    const int head = (int)(((uintptr_t)src >> 3) & 1);
    sB = sm + head;
    const int pairs = (len - head) / 2;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x)
      cp_async16(sB + head + 2 * p, src + head + 2 * p);
    if (threadIdx.x == 0) {
      if (head) cp_async8(sB, src);
      if (head + 2 * pairs < len) cp_async8(sB + len - 1, src + len - 1);
    }
  } else {
    // sB[d * ldr + r - a]: a diagonal's rows are contiguous in the
    // transposed view (s0 == 1), so its copies coalesce
    for (int d = 0; d <= w; ++d)
      for (int r = threadIdx.x; r < R; r += blockDim.x)
        cp_async8(sB + d * ldr + r, band + (int64_t)(a + r) * s0 + (int64_t)d * s1);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int i = r0 + threadIdx.x;
  if (i >= n) return;
  const int li = i - a;
  const int lr = kRaw ? wp1 : 1;    // sB's stride over rows
  const int ld = kRaw ? 1 : ldr;    // and over diagonals
  double acc = 0.0;
  for (int d = 0; d <= w; ++d) {
    if (i + d < n) acc = __fma_rn(sB[li * lr + d * ld], sx[li + d], acc);
    if (d > 0 && i - d >= 0)
      acc = __fma_rn(sB[(li - d) * lr + d * ld], sx[li - d], acc);
  }
  y[i] = acc;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// y (n,) = A x; band[i, d] at band[i * s0 + d * s1], d = 0..w; x, y
// contiguous; 1 <= bm <= 1024 rows per block. smem: the staged kernel's
// shared memory a block (kernel.py's band_mv_plan), or 0 for the direct
// kernel.
int band_mv_fp64(const double* band, int64_t s0, int64_t s1, const double* x,
                 double* y, int n, int w, int bm, int smem,
                 cudaStream_t stream) {
  if (n < 1 || w < 0 || bm < 1 || bm > 1024 || smem < 0 ||
      smem > kStagedSmemMax)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + bm - 1) / bm);
  // diagonals d >= n hold no entry of A
  const int wd = w < n ? w : n - 1;
  if (smem == 0) {
    band_mv_direct<<<blocks, bm, 0, stream>>>(band, s0, s1, x, y, n, wd);
    return (int)cudaGetLastError();
  }
  const int rows = n < bm + wd ? n : bm + wd;
  const int ldr = rows | 1;
  const long long raw_words = (long long)rows * (w + 1) + 2;
  const long long diag_words = (long long)(wd + 1) * ldr;
  const long long band_words = raw_words > diag_words ? raw_words : diag_words;
  const int xrows = n < bm + 2 * wd ? n : bm + 2 * wd;
  if (smem < 8LL * (band_words + xrows)) return (int)cudaErrorInvalidValue;
  if (s1 == 1 && s0 == w + 1 && (w & 1) == 0)
    band_mv_staged<true><<<blocks, bm, smem, stream>>>(
        band, s0, s1, x, y, n, wd, w + 1, ldr, (int)band_words);
  else
    band_mv_staged<false><<<blocks, bm, smem, stream>>>(
        band, s0, s1, x, y, n, wd, w + 1, ldr, (int)band_words);
  return (int)cudaGetLastError();
}

// An empty kernel on the same grid: the floor one launch cannot beat.
int band_mv_empty(int n, int bm, cudaStream_t stream) {
  if (n < 1 || bm < 1 || bm > 1024) return (int)cudaErrorInvalidValue;
  empty_kernel<<<(unsigned)((n + bm - 1) / bm), bm, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
