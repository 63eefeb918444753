// The tiled fp64 matrix product for Hopper (sm_90a):
//   C = alpha A B            (accumulate = 0)
//   C = C + alpha A B        (accumulate = 1, in place)
// with A (m, k) read either row-major or as the transpose of a row-major
// (k, m) array (trans_a = 1), B (k, n) row-major, C (m, n) row-major, each
// through its own leading dimension.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/gemm/kernel.py). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces _gemm_kernel behind gemm_pallas (repro/kernels/gemm/kernel.py):
// the public gemm, and the block updates of the blocked triangular solve
// (kernels/trsm), of the blocked Cholesky and of the blocked DSYGST.
//
// What bounds it: operations, at every shape the port gives it (k >= 128).
// The least time is 2 m n k flops over the card's fp64 peak, 67 TFLOP/s
// through the tensor cores (DMMA), which cuBLAS reaches; this kernel uses
// the 34 TFLOP/s FMA pipes only, so half the bound is out of its reach by
// design. At (9997)^3 the bound is 2.0e12 / 67e12 = 30 ms.
//
// Design. The TPU kernel walks K in its sequential grid axis and keeps the
// (bm, bn) sum in a VMEM scratch across it; CUDA blocks run in no order,
// so here a block owns one (BM, BN) output tile and runs the whole K loop
// itself, the sum in registers:
//   - 256 threads as 16 x 16; thread (tx, ty) owns rows ty + 16 i and
//     columns tx + 16 j of the tile (BM/16 x BN/16 sums in registers);
//   - per step a (BM, bk) slice of A and a (bk, BN) slice of B are staged
//     in shared memory with coalesced reads (A k-major, so both operands
//     of the inner loop are broadcast or unit-stride reads);
//   - the ragged edge is masked in the loads (zero) and in the stores, so
//     nothing is padded or copied;
//   - every product is an explicit __fma_rn: the build's --fmad=false
//     (kept for the bitwise bisection and chase) does not touch it. Each
//     entry is summed over k in order 0..k-1, so C(i, j) of A^T A and
//     C(j, i) are bitwise equal and a SYRK update stays symmetric.
// BM and BN are template knobs (16, 32, 64 or 128); bk, the depth staged
// per step, is a runtime multiple of 8 up to 32. The result C is written
// once, by the thread that read it, so the accumulate form may update a
// view of a matrix that A and B do not overlap.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxBK = 32;

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
gemm_tile(const double* __restrict__ A, int64_t lda, int trans_a,
          const double* __restrict__ B, int64_t ldb, double* C,
          int64_t ldc, int m, int n, int k, int bk, double alpha,
          int accumulate) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LA = BM + 1;    // padded row of the k-major A slice
  extern __shared__ double smem[];
  double* As = smem;            // [bk][LA]: As[kk * LA + r] = A(m0 + r, k0 + kk)
  double* Bs = smem + bk * LA;  // [bk][BN]: Bs[kk * BN + c] = B(k0 + kk, n0 + c)
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int64_t k0 = 0; k0 < k; k0 += bk) {
    __syncthreads();   // the previous slices are consumed
    if (trans_a) {
      // A(r, kk) = At[(k0 + kk) * lda + m0 + r]: consecutive threads, rows
      for (int e = tid; e < BM * bk; e += kThreads) {
        const int kk = e / BM;
        const int r = e % BM;
        As[kk * LA + r] = (m0 + r < m && k0 + kk < k)
                              ? A[(k0 + kk) * lda + m0 + r] : 0.0;
      }
    } else {
      // A(r, kk) = A[(m0 + r) * lda + k0 + kk]: consecutive threads, columns
      for (int e = tid; e < BM * bk; e += kThreads) {
        const int r = e / bk;
        const int kk = e % bk;
        As[kk * LA + r] = (m0 + r < m && k0 + kk < k)
                              ? A[(m0 + r) * lda + k0 + kk] : 0.0;
      }
    }
    for (int e = tid; e < BN * bk; e += kThreads) {
      const int kk = e / BN;
      const int c = e % BN;
      Bs[kk * BN + c] = (k0 + kk < k && n0 + c < n)
                            ? B[(k0 + kk) * ldb + n0 + c] : 0.0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      double a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * LA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fma_rn(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (c >= n) continue;
      double* out = C + r * ldc + c;
      *out = accumulate ? __fma_rn(alpha, acc[i][j], *out)
                        : __dmul_rn(alpha, acc[i][j]);
    }
  }
}

template <int BM, int BN>
int launch(const double* A, int64_t lda, int trans_a, const double* B,
           int64_t ldb, double* C, int64_t ldc, int m, int n, int k, int bk,
           double alpha, int accumulate, cudaStream_t stream) {
  const size_t smem = (size_t)bk * ((BM + 1) + BN) * sizeof(double);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tile<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)kMaxBK * ((BM + 1) + BN) * sizeof(double)));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  gemm_tile<BM, BN><<<grid, kThreads, smem, stream>>>(
      A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bn(int bn, const double* A, int64_t lda, int trans_a,
              const double* B, int64_t ldb, double* C, int64_t ldc, int m,
              int n, int k, int bk, double alpha, int accumulate,
              cudaStream_t stream) {
  switch (bn) {
    case 16: return launch<BM, 16>(A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 32: return launch<BM, 32>(A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 64: return launch<BM, 64>(A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 128: return launch<BM, 128>(A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C (m, n) [+]= alpha A B; A (m, k) row-major with row stride lda, or with
// trans_a = 1 the transpose of a row-major (k, m) array with row stride
// lda; B (k, n) with row stride ldb; C with row stride ldc; all with unit
// column stride. bm, bn in {16, 32, 64, 128}; bk a multiple of 8 in
// [8, 32]. m, n >= 1.
int gemm_fp64(const double* A, int64_t lda, int trans_a, const double* B,
              int64_t ldb, double* C, int64_t ldc, int m, int n, int k,
              int bm, int bn, int bk, double alpha, int accumulate,
              cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || bk < 8 || bk > kMaxBK || bk % 8)
    return (int)cudaErrorInvalidValue;
  switch (bm) {
    case 16: return launch_bn<16>(bn, A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 32: return launch_bn<32>(bn, A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 64: return launch_bn<64>(bn, A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    case 128: return launch_bn<128>(bn, A, lda, trans_a, B, ldb, C, ldc, m, n, k, bk, alpha, accumulate, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the depth a launch may stage per step
int gemm_max_bk() { return kMaxBK; }

}  // extern "C"
