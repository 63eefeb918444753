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
//
// Instances (reduced.cuh): fp64; fp32, stored and computed in fp32; bf16,
// stored in bf16 and computed in fp32, as the TPU kernel's bf16 path
// accumulates in fp32. Below fp64 the rounding points are the reference's:
// R = C + alpha (V W^T + W V^T) rounds to the storage type at the store
// (the TPU kernel's), and the symmetrizing average of two stored entries
// rounds again (the reference's symmetrize of the stored result). With
// --fmad=false every product and sum rounds on its own, so the plain
// version (kernels/syr2k/ref.py syr2k_reduced_ref) repeats the fp32 and
// bf16 instances bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduced.cuh"

namespace {

constexpr int kT = 32;          // tile edge
constexpr int kRows = 8;        // thread rows: 32 x 8 threads, 4 entries each
constexpr int kThreads = kT * kRows;
constexpr int kK = 16;          // panel columns staged per chunk

template <typename S>
__global__ void __launch_bounds__(kThreads)
syr2k_tiles(const S* C, int64_t ldc, const S* V,
            int64_t ldv, const S* W, int64_t ldw, S* out,
            int64_t ldo, int n, int k, double alpha_d, int sym) {
  using A = typename Acc<S>::type;
  const A alpha = (A)alpha_d;
  const int jb = blockIdx.x;
  const int ib = blockIdx.y;
  if (jb < ib) return;
  __shared__ A cij[kT][kT + 1];   // C[I, J], later out[I, J]
  __shared__ A cji[kT][kT + 1];   // C[J, I], later out[J, I]
  __shared__ A vi[kT][kK + 1];
  __shared__ A wi[kT][kK + 1];
  __shared__ A vj[kT][kK + 1];
  __shared__ A wj[kT][kK + 1];
  const int tx = threadIdx.x % kT;
  const int ty = threadIdx.x / kT;
  const int64_t i0 = (int64_t)ib * kT;
  const int64_t j0 = (int64_t)jb * kT;

#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    cij[r][tx] = (i0 + r < n && j0 + tx < n)
                     ? to_acc(C[(i0 + r) * ldc + j0 + tx]) : A(0);
    cji[r][tx] = (j0 + r < n && i0 + tx < n)
                     ? to_acc(C[(j0 + r) * ldc + i0 + tx]) : A(0);
  }

  A dot1[kT / kRows], dot2[kT / kRows];
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) dot1[m] = dot2[m] = A(0);
  for (int k0 = 0; k0 < k; k0 += kK) {
    __syncthreads();   // the previous chunk is consumed
    for (int e = threadIdx.x; e < kT * kK; e += kThreads) {
      const int r = e / kK;
      const int c = e % kK;
      const bool kin = k0 + c < k;
      const bool iin = kin && i0 + r < n;
      const bool jin = kin && j0 + r < n;
      vi[r][c] = iin ? to_acc(V[(i0 + r) * ldv + k0 + c]) : A(0);
      wi[r][c] = iin ? to_acc(W[(i0 + r) * ldw + k0 + c]) : A(0);
      vj[r][c] = jin ? to_acc(V[(j0 + r) * ldv + k0 + c]) : A(0);
      wj[r][c] = jin ? to_acc(W[(j0 + r) * ldw + k0 + c]) : A(0);
    }
    __syncthreads();
    const int kc = min(kK, k - k0);
    for (int c = 0; c < kc; ++c) {
      const A a = wj[tx][c];
      const A bb = vj[tx][c];
#pragma unroll
      for (int m = 0; m < kT / kRows; ++m) {
        const int r = ty + m * kRows;
        dot1[m] += vi[r][c] * a;
        dot2[m] += wi[r][c] * bb;
      }
    }
  }
  __syncthreads();   // every thread has read its C entries

  A o1[kT / kRows], o2[kT / kRows];
#pragma unroll
  for (int m = 0; m < kT / kRows; ++m) {
    const int r = ty + m * kRows;
    const A contrib = dot1[m] + dot2[m];
    // entries (i0 + r, j0 + tx) and (j0 + tx, i0 + r), as stored
    const A r1 = rnd<S>(cij[r][tx] + alpha * contrib);
    const A r2 = rnd<S>(cji[tx][r] + alpha * contrib);
    if (sym) {
      o1[m] = rnd<S>(A(0.5) * (r1 + r2));
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
    if (i0 + r < n && j0 + tx < n)
      out[(i0 + r) * ldo + j0 + tx] = from_acc<S>(cij[r][tx]);
    // the diagonal tile's mirror is the tile itself, written above
    if (jb != ib && j0 + r < n && i0 + tx < n)
      out[(j0 + r) * ldo + i0 + tx] = from_acc<S>(cji[r][tx]);
  }
}

template <typename S>
int launch(const S* C, int64_t ldc, const S* V, int64_t ldv, const S* W,
           int64_t ldw, S* out, int64_t ldo, int n, int k, double alpha,
           int sym, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int nt = (n + kT - 1) / kT;
  syr2k_tiles<S><<<dim3(nt, nt), kThreads, 0, stream>>>(
      C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, n) = [sym] (C + alpha (V W^T + W V^T)); C, out with row strides
// ldc, ldo (out may be C); V, W (n, k) with row strides ldv, ldw; unit
// column strides throughout.
int syr2k_fp64(const double* C, int64_t ldc, const double* V, int64_t ldv,
               const double* W, int64_t ldw, double* out, int64_t ldo, int n,
               int k, double alpha, int sym, cudaStream_t stream) {
  return launch(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym, stream);
}

// The same in fp32, and in bf16 (computed in fp32): the instances above.
int syr2k_fp32(const float* C, int64_t ldc, const float* V, int64_t ldv,
               const float* W, int64_t ldw, float* out, int64_t ldo, int n,
               int k, double alpha, int sym, cudaStream_t stream) {
  return launch(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym, stream);
}

int syr2k_bf16(const __nv_bfloat16* C, int64_t ldc, const __nv_bfloat16* V,
               int64_t ldv, const __nv_bfloat16* W, int64_t ldw,
               __nv_bfloat16* out, int64_t ldo, int n, int k, double alpha,
               int sym, cudaStream_t stream) {
  return launch(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym, stream);
}

}  // extern "C"
