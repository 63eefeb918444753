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
// What bounds it: on paper bytes (at b = 128 and s = 9997 columns, 20.6 MB
// of X and the tile over 3.35 TB/s = 6.1 us; the 1.6e8 flops take 2.4 us
// at the fp64 tensor peak). In practice latency: each column is a chain of
// b dependent steps (a division, a broadcast, a multiply-add), so what the
// kernel can do is make a step short and keep many chains in flight.
//
// Design. One warp owns one RHS column, and lane l holds rows l + 32 r
// (r = 0..3) of it in registers. Step i: every lane takes x_i from its
// owner with __shfl_sync and divides it by U(i, i) (__ddiv_rn, the same
// value in every lane, so no lane waits on a branch), the owner keeps it,
// and each lane subtracts U(j, i) x_i (U(i, j) x_i for trans) from its
// pending rows j with __fma_rn. So a column is b steps of one shuffle, one
// division and up to four multiply-adds, and X goes from device memory to
// registers and back once. A register whose 32 rows are all solved takes
// no more updates (the loops over r are unrolled, the register index is a
// constant). The subtractions are column-oriented (axpy), not the
// row-oriented dot of the plain version: the same terms in another order.
//
// The tile is staged once per block in shared memory with 8-byte cp.async
// copies (a warp a row; all copies in flight before one wait, so the fill
// costs about one memory latency, not one per element), packed, in the
// order the steps read it, so that a step reads one contiguous run
// (consecutive lanes, consecutive words):
//   back substitution: column i of U above and on the diagonal,
//     P[i (i + 1) / 2 + j] = U(j, i), j <= i;
//   forward substitution: row i of U from the diagonal on,
//     P[i b - i (i - 1) / 2 + (j - i)] = U(i, j), j >= i.
// That is b (b + 1) / 2 words, 66 KB at b = 128 (the full tile would be
// 128 KB), so up to three blocks share an SM. A block holds `warps`
// columns (4..32, the wrapper's choice from s): the columns on one SM
// share its fp64 pipe (a __ddiv_rn is a long fp64 sequence), so blocks
// are kept small, 4 columns at s = 100 (25 blocks), 19 at s = 9997 (two
// waves of two blocks an SM). Ragged tiles (b < 128, s not a multiple of
// the warps) are masked.
//
// Alignment: U and X are read and written one 8-byte word at a time
// through their row strides, so any leading dimension and any offset
// work (the MD views, U[k0:k1, k0:k1] and a block row of X, start
// anywhere in a 9997-wide matrix); nothing is copied or padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 128;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool TRANS>
__global__ void __launch_bounds__(32 * kMaxWarps)
trsm_tile_kernel(const double* __restrict__ U, int64_t ldu, double* X,
                 int64_t ldx, int b, int s) {
  extern __shared__ double P[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  // the fill: a warp a row of the triangle, coalesced along it, as 8-byte
  // cp.async copies that are all in flight before the one wait
  for (int i = tid >> 5; i < b; i += nwarps) {
    const double* src = U + (int64_t)i * ldu;
    for (int j = i + lane; j < b; j += 32) {
      double* dst = TRANS ? P + i * b - i * (i - 1) / 2 + (j - i)
                          : P + j * (j + 1) / 2 + i;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src + j));
    }
  }
  // this warp's column, loaded while the tile's copies are in flight
  const int64_t c = (int64_t)blockIdx.x * nwarps + (tid >> 5);
  const bool live = c < s;
  double x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = lane + 32 * r;
    x[r] = live && j < b ? X[(int64_t)j * ldx + c] : 0.0;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;            // the whole warp: one column a warp

  if (!TRANS) {
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      if (32 * q >= b) continue;
      for (int l = min(31, b - 1 - 32 * q); l >= 0; --l) {
        const int i = 32 * q + l;
        const double* col = P + i * (i + 1) / 2;     // col[j] = U(j, i)
        const double xi = __ddiv_rn(__shfl_sync(kFull, x[q], l), col[i]);
        if (lane == l) x[q] = xi;
        if (lane < l) x[q] = __fma_rn(-col[lane + 32 * q], xi, x[q]);
#pragma unroll
        for (int r = 0; r < q; ++r)
          x[r] = __fma_rn(-col[lane + 32 * r], xi, x[r]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (32 * q >= b) continue;
      const int top = min(31, b - 1 - 32 * q);
      for (int l = 0; l <= top; ++l) {
        const int i = 32 * q + l;
        const double* row = P + i * b - i * (i - 1) / 2 - i;  // row[j] = U(i, j)
        const double xi = __ddiv_rn(__shfl_sync(kFull, x[q], l), row[i]);
        if (lane == l) x[q] = xi;
        if (lane > l && lane <= top)
          x[q] = __fma_rn(-row[lane + 32 * q], xi, x[q]);
#pragma unroll
        for (int r = q + 1; r < 4; ++r)
          if (lane + 32 * r < b) x[r] = __fma_rn(-row[lane + 32 * r], xi, x[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = lane + 32 * r;
    if (j < b) X[(int64_t)j * ldx + c] = x[r];
  }
}

template <bool TRANS>
int launch(const double* U, int64_t ldu, double* X, int64_t ldx, int b,
           int s, int warps, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        trsm_tile_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)kMaxB * (kMaxB + 1) / 2 * sizeof(double)));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const size_t smem = (size_t)b * (b + 1) / 2 * sizeof(double);
  const unsigned blocks = (unsigned)((s + warps - 1) / warps);
  trsm_tile_kernel<TRANS><<<blocks, 32 * warps, smem, stream>>>(
      U, ldu, X, ldx, b, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X (b, s) row-major with row stride ldx, overwritten by U^{-1} X
// (trans = 0) or U^{-T} X (trans = 1); U (b, b) row-major with row stride
// ldu, only its upper triangle read. 1 <= b <= 128, s >= 1; warps, the
// columns of a block, in 1..32.
int trsm_tile_fp64(const double* U, int64_t ldu, double* X, int64_t ldx,
                   int b, int s, int trans, int warps, cudaStream_t stream) {
  if (b < 1 || b > kMaxB || s < 1 || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  return trans ? launch<true>(U, ldu, X, ldx, b, s, warps, stream)
               : launch<false>(U, ldu, X, ldx, b, s, warps, stream);
}

// the largest tile the kernel holds in shared memory
int trsm_tile_max_b() { return kMaxB; }

}  // extern "C"
