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
// symm_tiles runs fp64 only. The reduced instances (reduced.cuh) run
// symm_wide below: fp32, A, X and Y in fp32 and every sum in fp32; bf16,
// A, X and Y in bf16 (half the bytes of fp32) and every product, sum,
// scratch slot and the slot sum in fp32, with Y rounded to bf16 at the
// store, as the TPU kernel accumulates bf16 in fp32. Their least times
// are the triangle at 4 or 2 bytes an entry over 3.35 TB/s (0.0597 and
// 0.0299 ms at n=9997, p=1).
//
// The 16-byte design, for 4- and 2-byte entries (symm_wide). The 8-byte
// kernel above moves 8 bytes a lane a load for fp64; at 2 bytes a lane a
// warp load is 64 B, a warp's chunk of 8 rows 1 KB, and 16 warps an SM
// keep ~16 KB in flight: the bf16 instance of symm_tiles reached 20% of
// its byte bound, slower than its own fp32 instance. symm_wide gives each
// lane 16 bytes a load (VEC = 8 bf16 or 4 fp32), widened to fp32 in
// registers (bf16 by a shift, exact), so a warp load covers 512 B:
//   the same 64 x 64 tiles, one warp each, on the same triangle grid
//     (tile_of) and into the same scratch slots; a row of a tile is
//     L = 64 / VEC lanes (8 for bf16, 16 for fp32), so a warp load covers
//     32 / L rows (lane / L picks the row, lane % L the column group);
//   a chunk is R loads a lane (R = 8 at p = 1: 4 KB a warp), and with the
//     next chunk's loads started before this chunk is computed, 16 warps an
//     SM keep 64-128 KB of A in flight;
//   A_ij X_j: a row's partial sums meet across its L lanes by the same
//     transpose-reduce (butterfly shuffles over the lane bits below L that
//     halve the values a lane holds, in a fixed order);
//   A_ij^T X_i: each lane accumulates its VEC columns over the rows of its
//     row group; the groups meet once a tile, by halving steps over the
//     lane bits from 16 down to L, and each lane stores its share;
//   the diagonal tile (a separate instance of the tile code, so the other
//     tiles carry no mask): a vector wholly below the diagonal is not
//     loaded; one that crosses it is, and its entries below the diagonal
//     are set to zero in registers by a select (a NaN there never reaches
//     a sum); the mirror leaves out the diagonal entry itself, as above.
// 128-wide bf16 tiles (16 lanes a row) would halve the scratch (3.2 MB
// against 6.3 at n=9997, p=1); in a trial on the H100 they were slower
// (3160 tiles of 32 KB balance worse over the SMs than 12403 of 8 KB),
// and they were not kept (PERF.md §6).
// Two paths, one template (WIDE): where A's pointer and row stride are
// 16-byte aligned (the padded working copies of core/precision.py), each
// vector is one 16-byte load, and a vector that crosses column n is read
// entry by entry; otherwise every vector is read entry by entry (2- or
// 4-byte loads), the same sums in the same order. The fp32 instances
// moved to symm_wide too: on either path they are faster than symm_tiles
// was at fp32 (PERF.md §6, row 7r). Every sum is an
// explicit __fmaf_rn/__fmul_rn, in a fixed order, with no atomics, so a
// result repeats bitwise from run to run on either path.
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

// ---- the 16-byte design for 4- and 2-byte entries ------------------------

template <typename S>
constexpr int kVec = 16 / (int)sizeof(S);   // entries of a 16-byte vector
// lanes that share one row of a 64 x 64 tile (kVec<S> entries each): 8 for
// bf16, 16 for fp32; a warp load covers 32 / kLanes<S> rows
template <typename S>
constexpr int kLanes = kT / kVec<S>;
constexpr int kWideMinBlocks = 4;            // 16 warps an SM

// the 16 bytes at p as four words (entry e of a bf16 vector is half
// e % 2 of word e / 2, as in memory)
__device__ __forceinline__ uint4 ldcs16(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// one entry's bit pattern, streamed
__device__ __forceinline__ unsigned ldcs_bits(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ unsigned ldcs_bits(const float* p) {
  return __ldcs(reinterpret_cast<const unsigned*>(p));
}

// the VEC entries of row gi from column gj (a multiple of VEC) as one
// 16-byte vector: one load on the wide path where the vector lies inside
// A, else entry by entry, zero past column n; zero for a row past n and
// for a vector wholly below the diagonal of a diagonal tile (skip)
template <typename S, bool WIDE>
__device__ __forceinline__ uint4 load_vec(const S* __restrict__ A,
                                          int64_t lda, int n, int gi, int gj,
                                          bool skip) {
  constexpr int VEC = kVec<S>;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (skip || gi >= n || gj >= n) return r;
  const S* p = A + (int64_t)gi * lda + gj;
  if (WIDE && gj + VEC <= n) return ldcs16(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (gj + e < n) {
      const unsigned b = ldcs_bits(p + e);
      if constexpr (VEC == 8) {
        w[e / 2] |= (e % 2) ? (b << 16) : b;
      } else {
        w[e] = b;
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the entries of a vector in fp32: bf16 by a shift (exact), fp32 as is
template <typename S>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[kVec<S>]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kVec<S> == 8) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      v[i] = __uint_as_float(w[i]);
    }
  }
}

// chunk loads q < R: rows row0 + q (32 / kLanes) (row0 carries this lane's
// row within a load), this lane's VEC columns from gj; on a diagonal tile
// a vector wholly below the diagonal is skipped
template <typename S, bool WIDE, bool DIAG, int R>
__device__ __forceinline__ void load_wide_chunk(
    const S* __restrict__ A, int64_t lda, int n, int row0, int gj,
    uint4 (&a)[R]) {
  constexpr int kStep = 32 / kLanes<S>;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int gi = row0 + kStep * q;
    a[q] = load_vec<S, WIDE>(A, lda, n, gi, gj,
                             DIAG && gj + kVec<S> - 1 < gi);
  }
}

// Sum each of the N values a lane holds over the lanes that differ from it
// in lane bits O, O/2, .., 1: while a lane holds more than one value,
// lanes whose bit O is set keep the upper half and send the lower half to
// lane ^ O, the others the reverse; then lanes add their one value across
// the remaining bits. Fixed order: bitwise repeatable. From N = V at
// O = L/2 (L lanes) a lane ends with max(V / L, 1) values: value u is
// index u + (V / L) g for V >= L, and index g / (L / V) below, with
// g = lane % L.
template <int N, int O, int V>
__device__ __forceinline__ void halve_lanes(float (&v)[V], int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float send = up ? v[q] : v[q + H];
        const float keep = up ? v[q + H] : v[q];
        v[q] = keep + __shfl_xor_sync(kFull, send, O);
      }
      halve_lanes<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      halve_lanes<1, O / 2>(v, lane);
    }
  }
}

// The same halving over lane bits 16 .. OEND only (N > 32 / (2 OEND) keeps
// it a halving at every step): a lane ends with N OEND / 16 values, value
// u being index u + (N OEND / 16) (lane / OEND).
template <int N, int O, int OEND, int V>
__device__ __forceinline__ void halve_high(float (&v)[V], int lane) {
  if constexpr (O >= OEND) {
    constexpr int H = N / 2;
    static_assert(H >= 1, "values to halve");
    const bool up = lane & O;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const float send = up ? v[q] : v[q + H];
      const float keep = up ? v[q + H] : v[q];
      v[q] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve_high<H, O / 2, OEND>(v, lane);
  }
}

// one tile's share of Y = A X, every pass of KC columns (the kernel below)
template <typename S, int KC, int R, bool WIDE, bool DIAG>
__device__ __forceinline__ void wide_tile_product(
    const S* __restrict__ A, int64_t lda, const S* __restrict__ X,
    int64_t ldx, float* __restrict__ row_out, float* __restrict__ col_out,
    int n, int p, int i0, int j0, int lane) {
  constexpr int VEC = kVec<S>;
  constexpr int L = kLanes<S>;           // lanes of a row
  constexpr int kStep = 32 / L;          // rows of a load
  constexpr int kRows = kStep * R;       // rows of a chunk
  constexpr int kChunks = kT / kRows;
  constexpr int V = R * KC;              // values of one row transpose-reduce
  constexpr int kKeep = V >= L ? V / L : 1;
  constexpr int kSpread = V >= L ? 1 : L / V;
  constexpr int M = VEC * KC;            // mirror sums a lane holds
  constexpr int kMKeep = M / kStep;      // of them, stored by this lane
  static_assert(kT % kRows == 0, "chunk rows");
  static_assert(V % L == 0 || L % V == 0, "chunk values");
  static_assert(kMKeep >= 1, "mirror values");
  const int g = lane % L;                // column group
  const int h = lane / L;                // row within a load
  const int cl0 = g * VEC;               // this lane's first column in the tile
  const int gj0 = j0 + cl0;
  const int nk = (p + KC - 1) / KC;

  uint4 a[R];
  load_wide_chunk<S, WIDE, DIAG, R>(A, lda, n, i0 + h, gj0, a);
  for (int kk = 0; kk < nk; ++kk) {
    const int k0 = kk * KC;
    const int pc = min(KC, p - k0);
    float xj[VEC][KC], cacc[M];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        xj[e][k] = (k < pc && gj0 + e < n)
                       ? load_ro(X + (int64_t)(gj0 + e) * ldx + k0 + k) : 0.f;
        cacc[e * KC + k] = 0.f;
      }
    }
    for (int c = 0; c < kChunks; ++c) {
      // the next chunk's loads start before this one is computed
      uint4 an[R];
      if (c + 1 < kChunks || kk + 1 < nk) {
        const int cn = c + 1 < kChunks ? c + 1 : 0;
        load_wide_chunk<S, WIDE, DIAG, R>(A, lda, n, i0 + cn * kRows + h,
                                          gj0, an);
      } else {
#pragma unroll
        for (int q = 0; q < R; ++q) an[q] = make_uint4(0u, 0u, 0u, 0u);
      }

      float v[V];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = c * kRows + kStep * q + h;   // row within the tile
        const int gi = i0 + r;
        float av[VEC], mv[VEC];
        unpack<S>(a[q], av);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (DIAG) {
            // entries below the diagonal are zero; the mirror uses the
            // strictly upper ones
            if (cl0 + e < r) av[e] = 0.f;
            mv[e] = cl0 + e <= r ? 0.f : av[e];
          } else {
            mv[e] = av[e];
          }
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float xi = (k < pc && gi < n)
                               ? load_ro(X + (int64_t)gi * ldx + k0 + k) : 0.f;
          float s = __fmul_rn(av[0], xj[0][k]);
#pragma unroll
          for (int e = 1; e < VEC; ++e) s = __fmaf_rn(av[e], xj[e][k], s);
          v[q * KC + k] = s;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            cacc[e * KC + k] = __fmaf_rn(mv[e], xi, cacc[e * KC + k]);
        }
      }
      halve_lanes<V, L / 2>(v, lane);
      if (g % kSpread == 0) {
#pragma unroll
        for (int u = 0; u < kKeep; ++u) {
          const int idx = V >= L ? u + kKeep * g : g / kSpread;
          const int k = idx % KC;
          const int gi = i0 + c * kRows + kStep * (idx / KC) + h;
          if (gi < n && k < pc) row_out[(int64_t)gi * p + k0 + k] = v[u];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) a[q] = an[q];
    }
    // the row groups' mirror sums meet (halving over lane bits 16 .. L):
    // lane group h keeps and stores values [h kMKeep, (h + 1) kMKeep)
    halve_high<M, 16, L>(cacc, lane);
#pragma unroll
    for (int q = 0; q < kMKeep; ++q) {
      const int idx = q + h * kMKeep;
      const int gj = gj0 + idx / KC;
      const int k = idx % KC;
      if (gj < n && k < pc) col_out[(int64_t)gj * p + k0 + k] = cacc[q];
    }
  }
}

template <typename S, int KC, int R, bool WIDE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kWideMinBlocks)
symm_wide(const S* __restrict__ A, int64_t lda, const S* __restrict__ X,
          int64_t ldx, float* __restrict__ P, int n, int p, int nb,
          int ntiles) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= ntiles) return;               // whole warps leave together
  int ib, jb;
  tile_of(t, nb, &ib, &jb);
  const int64_t np = (int64_t)n * p;
  float* const row_out = P + (int64_t)jb * np;
  if (ib == jb) {       // the diagonal tile: its mirror to the extra slot
    wide_tile_product<S, KC, R, WIDE, true>(A, lda, X, ldx, row_out,
                                            P + (int64_t)nb * np, n, p,
                                            ib * kT, jb * kT, lane);
  } else {
    wide_tile_product<S, KC, R, WIDE, false>(A, lda, X, ldx, row_out,
                                             P + (int64_t)ib * np, n, p,
                                             ib * kT, jb * kT, lane);
  }
}

template <typename S, int KC, int R, bool WIDE>
int launch_wide(const S* A, int64_t lda, const S* X, int64_t ldx, float* P,
                int n, int p, int nb, int ntiles, cudaStream_t stream) {
  const int blocks = (ntiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  symm_wide<S, KC, R, WIDE><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      A, lda, X, ldx, P, n, p, nb, ntiles);
  return (int)cudaGetLastError();
}

template <typename S, bool WIDE>
int launch_wide_kc(const S* A, int64_t lda, const S* X, int64_t ldx,
                   float* P, int n, int p, int kc, int nb, int ntiles,
                   cudaStream_t stream) {
  switch (kc) {
    case 1: return launch_wide<S, 1, 8, WIDE>(A, lda, X, ldx, P, n, p, nb,
                                              ntiles, stream);
    case 2: return launch_wide<S, 2, 4, WIDE>(A, lda, X, ldx, P, n, p, nb,
                                              ntiles, stream);
    case 4: return launch_wide<S, 4, 2, WIDE>(A, lda, X, ldx, P, n, p, nb,
                                              ntiles, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the reduced product by path: 0 symm_wide's narrow path, 1 its wide
// path; then the slot sum
template <typename S>
int product_reduced(const S* A, int64_t lda, const S* X, int64_t ldx,
                    float* P, S* Y, int n, int p, int kc, int path,
                    cudaStream_t stream) {
  if (path != 0 && path != 1) return (int)cudaErrorInvalidValue;
  const int nb = (n + kT - 1) / kT;
  const int ntiles = nb * (nb + 1) / 2;
  const int err =
      path == 1
          ? launch_wide_kc<S, true>(A, lda, X, ldx, P, n, p, kc, nb, ntiles,
                                    stream)
          : launch_wide_kc<S, false>(A, lda, X, ldx, P, n, p, kc, nb, ntiles,
                                     stream);
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
// sum in fp32), through symm_wide by path: 0 the narrow path (any layout),
// 1 the wide path (A's pointer and lda * entry size multiples of 16
// bytes); P holds nb + 1 slots of (n, p), nb = ceil(n / 64).
int symm_block_upper_fp32(const float* A, int64_t lda, const float* X,
                          int64_t ldx, float* P, float* Y, int n, int p,
                          int kc, int path, cudaStream_t stream) {
  return product_reduced(A, lda, X, ldx, P, Y, n, p, kc, path, stream);
}

int symm_block_upper_bf16(const __nv_bfloat16* A, int64_t lda,
                          const __nv_bfloat16* X, int64_t ldx, float* P,
                          __nv_bfloat16* Y, int n, int p, int kc, int path,
                          cudaStream_t stream) {
  return product_reduced(A, lda, X, ldx, P, Y, n, p, kc, path, stream);
}

// tile edge, for the wrapper's plan (both kernels')
int symv_tile() { return kT; }

}  // extern "C"
