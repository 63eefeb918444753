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
// To come near that bound the card must keep ~20-40 KB of A in flight on
// every SM all the time, and spend little on anything but those loads.
//
// Design. The TPU kernel walks the upper tiles in order and carries y
// across grid steps in its output refs; CUDA blocks run in no order, so
// here no warp depends on another and no sum is carried:
//   symm_tiles — a triangle grid of WARPS, one per upper tile (i, j >= i)
//     of 64 x 64: warp t takes the tile at position t of the reference's
//     row-major triangle_indices (tile_of; its Python twin is in
//     kernel.py), so only upper tiles are launched. A tile is read in
//     chunks of R rows: lane l holds columns l and l + 32 of each row (a
//     warp reads 256 contiguous bytes a load: coalesced, with 8-byte loads
//     because lda = 9997 is odd and rules out 16-byte ones), in registers,
//     no shared memory, no barrier. The next chunk's loads are issued
//     before the current chunk is computed, so each warp always has a
//     chunk in flight; 16 warps an SM keep ~64 KB in flight at p = 1, and
//     the hardware hands finished warps' slots to the next tiles. (A
//     persistent walk of several tiles a warp, with the prefetch crossing
//     tiles, was slower on the H100: a fixed share per SM balances worse.)
//     Per chunk and column k of X:
//       A_ij X_j: each lane's partial sums of the R rows meet by a
//         transpose-reduce (butterfly shuffles that halve the values a
//         lane holds at each step, in a fixed order): R KC values cost
//         ~R KC shuffles, and lane l ends with one finished row sum,
//         which it stores to scratch slot j, rows of block i.
//       A_ij^T X_i: lane l accumulates its two columns over the tile's
//         rows in registers, written once per tile to scratch slot i,
//         rows of block j. On the diagonal tile (loaded with its strictly
//         lower part masked to zero, so garbage there is never read) the
//         mirror uses only the strictly upper part and goes to the extra
//         slot nb, so no (slot, row) pair is written twice.
//     KC, the columns of X per pass over a chunk, is a template parameter
//     (1, 2 or 4): p = 1 reads one column of X and does one multiply-add
//     per entry and direction; p > 4 takes passes of 4 columns, each
//     reading the tile again (from L2, where the last pass left it).
//     Every multiply-add is an explicit __fma_rn (the build has
//     --fmad=false for the bitwise kernels of other files).
//   symm_slot_sum — Y = sum over the nb + 1 slots of P: 8 warps of a
//     block each sum a fixed range of slots in slot order for 32 outputs,
//     and the 8 partials meet in shared memory in a fixed order.
// The sums run in a fixed order, so a result repeats bitwise from run to
// run and the Lanczos iteration counts do too; no atomics. The scratch
// costs (nb + 1) * n * p * 8 B written and read again (12.6 MB each at
// n=9997, p=1, against the 400 MB triangle). X may be a column slice of a
// wider row-major array (the Lanczos basis): it is read through its
// leading dimension ldx, and A through lda; neither is copied or padded.
//
// Instances (reduced.cuh): fp64; fp32, A, X and Y in fp32 and every sum in
// fp32; bf16, A, X and Y in bf16 (half the bytes of fp32) and every
// product, sum, scratch slot and the slot sum in fp32, with Y rounded to
// bf16 at the store, as the TPU kernel accumulates bf16 in fp32. The
// reduced instances' least times are the triangle at 4 or 2 bytes an
// entry over 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduced.cuh"

namespace {

constexpr int kT = 64;               // tile rows and columns
constexpr int kWarpsPerBlock = 4;    // independent warps of a block
constexpr int kMinBlocks = 4;        // 16 warps an SM: <= 128 registers
constexpr int kSumGroups = 8;        // slot ranges of a slot-sum block
constexpr unsigned kFull = 0xffffffffu;

// the tile at position t of the row-major upper triangle of nb x nb
// tiles: row i starts at s(i) = i nb - i (i - 1) / 2, so i is the larger
// root's floor of s(i) = t, stepped to the exact row against rounding
__device__ __forceinline__ void tile_of(int t, int nb, int* ib, int* jb) {
  const double b = 2.0 * nb + 1.0;
  int i = (int)(0.5 * (b - sqrt(b * b - 8.0 * t)));
  while (i > 0 && i * nb - i * (i - 1) / 2 > t) --i;
  while ((i + 1) * nb - (i + 1) * i / 2 <= t) ++i;
  *ib = i;
  *jb = i + t - (i * nb - i * (i - 1) / 2);
}

// Sum each of the V values a lane holds over the 32 lanes of the warp.
// Step by step, lanes whose bit O is set keep the upper half (H values)
// of their values and send the lower half to lane ^ O, the others the
// reverse, so the values a lane holds halve while the lanes they sum over
// double; then lanes that share bits 16 .. 32/V add up by xor shuffles.
// Lane l returns the sum of value l / (32 / V). Fixed order: bitwise
// repeatable. The steps recurse at compile time, so every index into v
// is a constant and v stays in registers.
template <int V, int H, int O, typename T>
__device__ __forceinline__ void halve(T (&v)[V], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const T send = up ? v[q] : v[q + H];
      const T keep = up ? v[q + H] : v[q];
      v[q] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve<V, H / 2, O / 2>(v, lane);
  }
}

template <int V, typename T>
__device__ __forceinline__ T transpose_reduce(T (&v)[V], int lane) {
  halve<V, V / 2, 16>(v, lane);
  T s = v[0];
#pragma unroll
  for (int o = 16 / V; o >= 1; o /= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// rows c R .. c R + R - 1 of tile (ib, jb), columns lane and lane + 32;
// zero outside A and, on the diagonal tile, strictly below the diagonal
template <int R, typename S>
__device__ __forceinline__ void load_chunk(
    const S* __restrict__ A, int64_t lda, int n, int ib, int jb, int c,
    int lane, typename Acc<S>::type (&a)[R][2]) {
  const int i0 = ib * kT + c * R;
  const int j0 = jb * kT + lane;
  const bool diag = ib == jb;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + rr;
      const int gj = j0 + 32 * h;
      const bool in = gi < n && gj < n && (!diag || gi <= gj);
      a[rr][h] = in ? load_cs(A + (int64_t)gi * lda + gj)
                    : typename Acc<S>::type(0);
    }
  }
}

template <typename S, int KC, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
symm_tiles(const S* __restrict__ A, int64_t lda,
           const S* __restrict__ X, int64_t ldx,
           typename Acc<S>::type* __restrict__ P,
           int n, int p, int nb, int ntiles) {
  using T = typename Acc<S>::type;
  constexpr int V = R * KC;            // values of one transpose-reduce
  constexpr int kLanesPerValue = 32 / V;
  constexpr int kChunks = kT / R;
  static_assert(V <= 32 && 32 % V == 0 && kT % R == 0, "chunk shape");
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= ntiles) return;              // whole warps leave together
  int ib, jb;
  tile_of(t, nb, &ib, &jb);
  const int i0 = ib * kT;
  const int j0 = jb * kT;
  const bool diag = ib == jb;
  const int nk = (p + KC - 1) / KC;     // passes of KC columns
  const int64_t np = (int64_t)n * p;
  T* const row_out = P + (int64_t)jb * np;
  T* const col_out = P + (int64_t)(diag ? nb : ib) * np;

  T a[R][2];
  load_chunk<R>(A, lda, n, ib, jb, 0, lane, a);
  for (int kk = 0; kk < nk; ++kk) {
    const int k0 = kk * KC;
    const int pc = min(KC, p - k0);
    T xj[2][KC], cacc[2][KC];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = j0 + lane + 32 * h;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        xj[h][k] = (k < pc && gj < n) ? load_ro(X + (int64_t)gj * ldx + k0 + k)
                                      : T(0);
        cacc[h][k] = T(0);
      }
    }
    for (int c = 0; c < kChunks; ++c) {
      // the next chunk's loads are issued before this one is computed:
      // chunk c + 1 of this pass, or chunk 0 again for the next pass
      T an[R][2];
      if (c + 1 < kChunks || kk + 1 < nk) {
        load_chunk<R>(A, lda, n, ib, jb, c + 1 < kChunks ? c + 1 : 0, lane,
                      an);
      } else {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) an[rr][0] = an[rr][1] = T(0);
      }

      T v[V];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = c * R + rr;       // row within the tile
        const int gi = i0 + r;
        // the mirror: strictly upper entries only on the diagonal tile
        const T m0 = (diag && r >= lane) ? T(0) : a[rr][0];
        const T m1 = (diag && r >= lane + 32) ? T(0) : a[rr][1];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const T xi = (k < pc && gi < n)
                           ? load_ro(X + (int64_t)gi * ldx + k0 + k) : T(0);
          v[rr * KC + k] = fma_rn(a[rr][1], xj[1][k],
                                  mul_rn(a[rr][0], xj[0][k]));
          cacc[0][k] = fma_rn(m0, xi, cacc[0][k]);
          cacc[1][k] = fma_rn(m1, xi, cacc[1][k]);
        }
      }
      const T s = transpose_reduce<V>(v, lane);
      if (lane % kLanesPerValue == 0) {
        const int q = lane / kLanesPerValue;
        const int k = q % KC;
        const int gi = i0 + c * R + q / KC;
        if (gi < n && k < pc) row_out[(int64_t)gi * p + k0 + k] = s;
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        a[rr][0] = an[rr][0];
        a[rr][1] = an[rr][1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = j0 + lane + 32 * h;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (gj < n && k < pc) col_out[(int64_t)gj * p + k0 + k] = cacc[h][k];
      }
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kSumGroups * 32)
symm_slot_sum(const typename Acc<S>::type* __restrict__ P, S* __restrict__ Y,
              int64_t np, int ns) {
  using T = typename Acc<S>::type;
  __shared__ T part[kSumGroups][32];
  const int x = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int64_t idx = (int64_t)blockIdx.x * 32 + x;
  const int b0 = g * ns / kSumGroups;
  const int b1 = (g + 1) * ns / kSumGroups;
  T s = T(0);
  if (idx < np) {
#pragma unroll 4
    for (int b = b0; b < b1; ++b) s += __ldcs(P + (int64_t)b * np + idx);
  }
  part[g][x] = s;
  __syncthreads();
  if (g == 0 && idx < np) {
    T y = part[0][x];
#pragma unroll
    for (int h = 1; h < kSumGroups; ++h) y += part[h][x];
    Y[idx] = from_acc<S>(y);
  }
}

template <typename S, int KC, int R>
int launch_tiles(const S* A, int64_t lda, const S* X, int64_t ldx,
                 typename Acc<S>::type* P, int n, int p, int nb, int ntiles,
                 cudaStream_t stream) {
  const int blocks = (ntiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  symm_tiles<S, KC, R><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      A, lda, X, ldx, P, n, p, nb, ntiles);
  return (int)cudaGetLastError();
}

template <typename S>
int product(const S* A, int64_t lda, const S* X, int64_t ldx,
            typename Acc<S>::type* P, S* Y, int n, int p, int kc,
            cudaStream_t stream) {
  const int nb = (n + kT - 1) / kT;
  const int ntiles = nb * (nb + 1) / 2;
  int err;
  switch (kc) {
    case 1: err = launch_tiles<S, 1, 8>(A, lda, X, ldx, P, n, p, nb, ntiles,
                                        stream); break;
    case 2: err = launch_tiles<S, 2, 4>(A, lda, X, ldx, P, n, p, nb, ntiles,
                                        stream); break;
    case 4: err = launch_tiles<S, 4, 4>(A, lda, X, ldx, P, n, p, nb, ntiles,
                                        stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int64_t np = (int64_t)n * p;
  const int64_t blocks = (np + 31) / 32;
  symm_slot_sum<S><<<(unsigned)blocks, kSumGroups * 32, 0, stream>>>(
      P, Y, np, nb + 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (n, p) row-major = A X from the upper triangle of A; X (n, p) with row
// stride ldx and unit column stride; P scratch of (nb + 1) * n * p
// doubles, nb = ceil(n / 64); kc (1, 2 or 4) columns of X a pass. symv,
// y (n,) = A x, is this product at p = 1, kc = 1.
int symm_block_upper(const double* A, int64_t lda, const double* X,
                     int64_t ldx, double* P, double* Y, int n, int p, int kc,
                     cudaStream_t stream) {
  return product(A, lda, X, ldx, P, Y, n, p, kc, stream);
}

// The same in fp32 (P in fp32), and in bf16 (A, X, Y in bf16; P and every
// sum in fp32).
int symm_block_upper_fp32(const float* A, int64_t lda, const float* X,
                          int64_t ldx, float* P, float* Y, int n, int p,
                          int kc, cudaStream_t stream) {
  return product(A, lda, X, ldx, P, Y, n, p, kc, stream);
}

int symm_block_upper_bf16(const __nv_bfloat16* A, int64_t lda,
                          const __nv_bfloat16* X, int64_t ldx, float* P,
                          __nv_bfloat16* Y, int n, int p, int kc,
                          cudaStream_t stream) {
  return product(A, lda, X, ldx, P, Y, n, p, kc, stream);
}

// tile edge, for the wrapper's plan
int symv_tile() { return kT; }

}  // extern "C"
