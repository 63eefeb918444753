// The one-triangle symmetric product for Hopper (sm_90a): y = A x and
// Y = A X for symmetric A, reading only the upper triangle of A.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/symv/kernel.py). Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces _symv_kernel behind symv_pallas and symm_block_pallas
// (repro/kernels/symv/kernel.py): the KE1 matvec of the Krylov solver and
// KI2, the product inside the implicit operator.
//
// What bounds it: bytes. Each upper-triangle entry is read once and used
// for 2 p multiply-adds (its own row and its mirror), so at p <= 4 in fp64
// the work is far below the card's fp64 rate: the least time is the
// upper triangle n(n+1)/2 * 8 B, plus X, plus Y, over 3.35 TB/s, which is
// 0.119 ms at n=9997 (p=1). A dense product would read twice the bytes.
//
// Design. The TPU kernel walks the upper tiles in order and carries y
// across grid steps in its output refs; CUDA blocks run in no order, so
// here no block depends on another and no sum is carried:
//   symm_upper_tiles — one block per upper tile (i, j >= i) of kT x kT.
//     It stages the tile in shared memory with coalesced row reads
//     (masking the ragged edge, and on the diagonal tile reading only the
//     upper part and mirroring it in shared memory), then computes
//       A_ij X_j   -> scratch slot j, rows of block i
//       A_ij^T X_i -> scratch slot i, rows of block j   (j > i only)
//     P is (nb, n, p): every (slot, row block) pair is written exactly
//     once, so P needs no zero fill and no atomics.
//   symm_upper_slot_sum — Y = sum over the nb slots of P, in slot order.
// The sums run in a fixed order, so a result repeats bitwise from run to
// run and the Lanczos iteration counts do too. The scratch costs
// nb * n * p * 8 B of extra traffic (12.5 MB at n=9997, p=1, against the
// 400 MB triangle). X may be a column slice of a wider row-major array (the
// Lanczos basis): it is read through its leading dimension ldx, and A
// through lda; neither is copied or padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // tile rows and columns
constexpr int kThreads = 256;  // 4 threads per tile row, 4 row groups per column
constexpr int kPC = 4;         // right-hand sides per pass over the staged tile
constexpr int kGroups = kThreads / kT;

__global__ void __launch_bounds__(kThreads)
symm_upper_tiles(const double* __restrict__ A, int64_t lda,
                 const double* __restrict__ X, int64_t ldx,
                 double* __restrict__ P, int n, int p) {
  const int jb = blockIdx.x;
  const int ib = blockIdx.y;
  if (jb < ib) return;  // the lower tiles are never read
  __shared__ double a[kT][kT + 1];
  __shared__ double xi[kT][kPC];
  __shared__ double xj[kT][kPC];
  __shared__ double part[kGroups][kT][kPC];
  const int tid = threadIdx.x;
  const int i0 = ib * kT;
  const int j0 = jb * kT;
  const bool diag = ib == jb;

#pragma unroll
  for (int it = 0; it < kT * kT / kThreads; ++it) {
    const int e = it * kThreads + tid;
    const int r = e / kT;
    const int c = e % kT;
    const bool in = i0 + r < n && j0 + c < n && (!diag || r <= c);
    a[r][c] = in ? A[(int64_t)(i0 + r) * lda + (j0 + c)] : 0.0;
  }
  __syncthreads();
  if (diag) {
    // the diagonal tile's lower half is the mirror of its upper half
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT;
      const int c = e % kT;
      if (r > c) a[r][c] = a[c][r];
    }
  }

  const int64_t np = (int64_t)n * p;
  for (int k0 = 0; k0 < p; k0 += kPC) {
    const int pc = min(kPC, p - k0);
    for (int e = tid; e < kT * kPC; e += kThreads) {
      const int r = e / kPC;
      const int k = e % kPC;
      xi[r][k] = (i0 + r < n && k < pc) ? X[(int64_t)(i0 + r) * ldx + k0 + k] : 0.0;
      xj[r][k] = (j0 + r < n && k < pc) ? X[(int64_t)(j0 + r) * ldx + k0 + k] : 0.0;
    }
    __syncthreads();

    // A_ij X_j: thread (r, q) sums columns [16q, 16q + 16) of row r, and
    // the four partial sums of a row meet by shuffles in a fixed order
    {
      const int r = tid >> 2;
      const int q = tid & 3;
      double acc[kPC];
#pragma unroll
      for (int k = 0; k < kPC; ++k) acc[k] = 0.0;
#pragma unroll 4
      for (int c = q * (kT / 4); c < (q + 1) * (kT / 4); ++c) {
        const double v = a[r][c];
#pragma unroll
        for (int k = 0; k < kPC; ++k) acc[k] += v * xj[c][k];
      }
#pragma unroll
      for (int k = 0; k < kPC; ++k) {
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], 2);
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], 1);
      }
      if (q == 0 && i0 + r < n) {
        double* out = P + (int64_t)jb * np + (int64_t)(i0 + r) * p + k0;
        for (int k = 0; k < pc; ++k) out[k] = acc[k];
      }
    }

    // A_ij^T X_i: thread (c, g) sums rows [16g, 16g + 16) of column c;
    // the four row groups meet in shared memory
    if (!diag) {
      const int c = tid % kT;
      const int g = tid / kT;
      double acc[kPC];
#pragma unroll
      for (int k = 0; k < kPC; ++k) acc[k] = 0.0;
#pragma unroll 4
      for (int r = g * (kT / kGroups); r < (g + 1) * (kT / kGroups); ++r) {
        const double v = a[r][c];
#pragma unroll
        for (int k = 0; k < kPC; ++k) acc[k] += v * xi[r][k];
      }
#pragma unroll
      for (int k = 0; k < kPC; ++k) part[g][c][k] = acc[k];
      __syncthreads();
      if (tid < kT && j0 + tid < n) {
        double* out = P + (int64_t)ib * np + (int64_t)(j0 + tid) * p + k0;
        for (int k = 0; k < pc; ++k) {
          double s = part[0][tid][k];
          for (int h = 1; h < kGroups; ++h) s += part[h][tid][k];
          out[k] = s;
        }
      }
    }
    __syncthreads();  // xi, xj and part are reused by the next pass
  }
}

__global__ void __launch_bounds__(kThreads)
symm_upper_slot_sum(const double* __restrict__ P, double* __restrict__ Y,
                    int64_t np, int nb) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= np) return;
  double s = 0.0;
  for (int b = 0; b < nb; ++b) s += P[(int64_t)b * np + idx];
  Y[idx] = s;
}

int product(const double* A, int64_t lda, const double* X, int64_t ldx,
            double* P, double* Y, int n, int p, cudaStream_t stream) {
  const int nb = (n + kT - 1) / kT;
  symm_upper_tiles<<<dim3(nb, nb), kThreads, 0, stream>>>(A, lda, X, ldx, P,
                                                          n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t np = (int64_t)n * p;
  const int64_t blocks = (np + kThreads - 1) / kThreads;
  symm_upper_slot_sum<<<(unsigned)blocks, kThreads, 0, stream>>>(P, Y, np, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (n,) = A x from the upper triangle of A (row stride lda); P scratch of
// nb * n doubles, nb = ceil(n / 64).
int symv_upper(const double* A, int64_t lda, const double* x, double* P,
               double* y, int n, cudaStream_t stream) {
  return product(A, lda, x, 1, P, y, n, 1, stream);
}

// Y (n, p) row-major = A X from the upper triangle of A; X (n, p) with row
// stride ldx and unit column stride; P scratch of nb * n * p doubles.
int symm_block_upper(const double* A, int64_t lda, const double* X,
                     int64_t ldx, double* P, double* Y, int n, int p,
                     cudaStream_t stream) {
  return product(A, lda, X, ldx, P, Y, n, p, stream);
}

// tile edge, for the wrapper's scratch size
int symv_tile() { return kT; }

}  // extern "C"
