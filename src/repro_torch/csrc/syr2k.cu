// The symmetric rank-2k update of the TT1 band reduction for Hopper
// (sm_90a): out = C + alpha (V W^T + W V^T), optionally symmetrized,
// out = (R + R^T) / 2 with R = C + alpha (V W^T + W V^T).
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/syr2k/kernel.py). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces _syr2k_kernel behind syr2k_pallas
// (repro/kernels/syr2k/kernel.py). The TT1 sweep calls it once a panel
// with (V, Z) = the panel's reflectors and its SYR2K panel and alpha = -1,
// symmetrized, as the reference's TPU branch computes
// symmetrize(syr2k(Mt, V, Z, alpha=-1)).
//
// What bounds it: bytes. At k = 16 each entry of C costs 4k = 64 flops
// against 16 bytes (read once, written once), below the card's fp64
// ridge: at the first MD window (9997^2, k = 16) the least time is
// 1.6 GB over 3.35 TB/s = 0.48 ms.
//
// Design. One block per pair of mirrored 32 x 32 tiles (I, J) and (J, I),
// J >= I; blocks with J < I exit at once. The block stages both C tiles in
// shared memory with coalesced row reads, and the four k-deep panel slices
// (V and W at the rows of I and of J) in chunks of 16 columns. The
// contribution V_i.W_j + W_i.V_j is computed ONCE per pair: its mirror
// V_j.W_i + W_j.V_i has the same products summed in the same order, so it
// is bitwise the same number, and the (J, I) tile costs no flops. With the
// symmetrizing flag the two results of a pair are averaged, which is
// exactly (R + R^T) / 2 and leaves out a second pass over the matrix.
// Every entry of C is read before any is written, and each is written by
// the block that read it, so out may be C itself (the TT1 window is
// updated in place). C and out are read through their row strides.
// The --fmad=false of the build costs this kernel its FMAs; per-source
// flags are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // tile edge
constexpr int kRows = 8;        // thread rows: 32 x 8 threads, 4 entries each
constexpr int kThreads = kT * kRows;
constexpr int kK = 16;          // panel columns staged per chunk

__global__ void __launch_bounds__(kThreads)
syr2k_tiles(const double* C, int64_t ldc, const double* V,
            int64_t ldv, const double* W, int64_t ldw, double* out,
            int64_t ldo, int n, int k, double alpha, int sym) {
  const int jb = blockIdx.x;
  const int ib = blockIdx.y;
  if (jb < ib) return;
  __shared__ double cij[kT][kT + 1];   // C[I, J], later out[I, J]
  __shared__ double cji[kT][kT + 1];   // C[J, I], later out[J, I]
  __shared__ double vi[kT][kK + 1];
  __shared__ double wi[kT][kK + 1];
  __shared__ double vj[kT][kK + 1];
  __shared__ double wj[kT][kK + 1];
  const int tx = threadIdx.x % kT;
  const int ty = threadIdx.x / kT;
  const int64_t i0 = (int64_t)ib * kT;
  const int64_t j0 = (int64_t)jb * kT;

#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    cij[r][tx] = (i0 + r < n && j0 + tx < n) ? C[(i0 + r) * ldc + j0 + tx] : 0.0;
    cji[r][tx] = (j0 + r < n && i0 + tx < n) ? C[(j0 + r) * ldc + i0 + tx] : 0.0;
  }

  double dot1[kT / kRows], dot2[kT / kRows];
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) dot1[m] = dot2[m] = 0.0;
  for (int k0 = 0; k0 < k; k0 += kK) {
    __syncthreads();   // the previous chunk is consumed
    for (int e = threadIdx.x; e < kT * kK; e += kThreads) {
      const int r = e / kK;
      const int c = e % kK;
      const bool kin = k0 + c < k;
      const bool iin = kin && i0 + r < n;
      const bool jin = kin && j0 + r < n;
      vi[r][c] = iin ? V[(i0 + r) * ldv + k0 + c] : 0.0;
      wi[r][c] = iin ? W[(i0 + r) * ldw + k0 + c] : 0.0;
      vj[r][c] = jin ? V[(j0 + r) * ldv + k0 + c] : 0.0;
      wj[r][c] = jin ? W[(j0 + r) * ldw + k0 + c] : 0.0;
    }
    __syncthreads();
    const int kc = min(kK, k - k0);
    for (int c = 0; c < kc; ++c) {
      const double a = wj[tx][c];
      const double bb = vj[tx][c];
#pragma unroll
      for (int m = 0; m < kT / kRows; ++m) {
        const int r = ty + m * kRows;
        dot1[m] += vi[r][c] * a;
        dot2[m] += wi[r][c] * bb;
      }
    }
  }
  __syncthreads();   // every thread has read its C entries

  double o1[kT / kRows], o2[kT / kRows];
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    const double contrib = dot1[m] + dot2[m];
    const double r1 = cij[r][tx] + alpha * contrib;   // entry (i0 + r, j0 + tx)
    const double r2 = cji[tx][r] + alpha * contrib;   // entry (j0 + tx, i0 + r)
    if (sym) {
      o1[m] = 0.5 * (r1 + r2);
      o2[m] = o1[m];
    } else {
      o1[m] = r1;
      o2[m] = r2;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    cij[r][tx] = o1[m];
    cji[tx][r] = o2[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    if (i0 + r < n && j0 + tx < n) out[(i0 + r) * ldo + j0 + tx] = cij[r][tx];
    // the diagonal tile's mirror is the tile itself, written above
    if (jb != ib && j0 + r < n && i0 + tx < n)
      out[(j0 + r) * ldo + i0 + tx] = cji[r][tx];
  }
}

}  // namespace

extern "C" {

// out (n, n) = [sym] (C + alpha (V W^T + W V^T)); C, out with row strides
// ldc, ldo (out may be C); V, W (n, k) with row strides ldv, ldw; unit
// column strides throughout.
int syr2k_fp64(const double* C, int64_t ldc, const double* V, int64_t ldv,
               const double* W, int64_t ldw, double* out, int64_t ldo, int n,
               int k, double alpha, int sym, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int nt = (n + kT - 1) / kT;
  syr2k_tiles<<<dim3(nt, nt), kThreads, 0, stream>>>(C, ldc, V, ldv, W, ldw,
                                                     out, ldo, n, k, alpha,
                                                     sym);
  return (int)cudaGetLastError();
}

}  // extern "C"
