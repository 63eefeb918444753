// The tiled fp64 matrix product for Hopper (sm_90a), on the fp64 tensor
// cores:
//   C = alpha A B            (accumulate = 0)
//   C = C + alpha A B        (accumulate = 1, in place)
// with A (m, k) read either row-major or as the transpose of a row-major
// (k, m) array (trans_a = 1), B (k, n) row-major, C (m, n) row-major, each
// through its own leading dimension.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/gemm/kernel.py). The entry points launch on the
// caller's stream, allocate nothing and return cudaGetLastError().
//
// Replaces _gemm_kernel behind gemm_pallas (repro/kernels/gemm/kernel.py):
// the public gemm, and the block updates of the blocked triangular solve
// (kernels/trsm), of the blocked Cholesky and of the blocked DSYGST.
//
// What bounds it: operations, at every shape the port gives it. The least
// time is 2 m n k flops over the fp64 tensor-core peak, 67 TFLOP/s (DMMA);
// at 9997^3 that is 2.0e12 / 67e12 = 30 ms. Two things keep a kernel from
// it: the FMA pipes (34 TFLOP/s) instead of the tensor cores, and, for
// the skinny updates (128 x 100, K up to 9869), too few output tiles to
// fill 132 SMs.
//
// Design.
//   - The MMA is mma.sync.m16n8k4 in fp64 (DMMA): A fragment 2 words, B 1,
//     C 4 a lane (the m16n8k8 and m16n8k16 shapes, tried, were no
//     faster). A warp owns a 32 x 32 sub-tile (2 x 4 MMA tiles, 32
//     accumulators a lane, in registers; at most 128 registers a thread,
//     ptxas spills one word in the 64 x 64 row-major variant only). The
//     menu has two tiles: 64 x 64 (2 x 2 warps, K slices 16 deep, up to 4
//     blocks an SM) and 128 x 128 (4 x 4 warps, slices 32 deep, 212 KB of
//     ring, 1 block an SM: half the operand traffic from L2 per flop, for
//     long-K products with many output tiles).
//   - K goes through a 3-slice ring in shared memory, filled with cp.async
//     and waited on with cp.async.wait_group, so the loads of slices k+1
//     and k+2 run under the MMAs of slice k; one barrier a slice.
//   - Alignment: the port's views start anywhere and the MD leading
//     dimension (9997) is odd in doubles, so 16-byte copies and TMA (16-byte
//     strides) are out. Every copy is an 8-byte cp.async.ca; the ragged
//     edge is zero-filled through src-size = 0, so nothing is padded.
//   - Bank conflicts: each shared row is padded to 4 (mod 16) words, so the
//     16 lanes of a half-warp read 16 distinct 8-byte bank pairs for every
//     fragment. A row-major A is staged row-major ([BM][BK + 4]); a
//     transposed A k-major ([BK][BM + 4]), so both copies are coalesced.
//   - Split-K: the planner (kernels/gemm/kernel.py::plan) gives a K span
//     per block; with more than one span, block z writes its partial sum to
//     the slice z of a (splits, m, n) scratch that the wrapper allocates,
//     and a second launch (splitk_reduce) adds the partials in order
//     z = 0, 1, ... and applies alpha and C. No atomics: the same shapes
//     give the same plan and the same bits on every run.
//   - The epilogue is C = fma(alpha, sum, C) or alpha * sum, explicit
//     intrinsics (the build's --fmad=false does not touch them).
// Accuracy: each entry is a sum of k products in some order, so
// |C - C_exact| <= gamma_k (|C| + |alpha| |A||B|). Symmetry: C(i, j) and
// C(j, i) of A^T A see the same products at the same k positions of the
// same MMA sequence, and on the H100 the DMMA sums them identically:
// chip_smoke.py prints max|S - S^T| = 0 for the GS1 SYRK-shaped product,
// so a SYRK update stays exactly symmetric. (That is a measured property
// of the card, not a guarantee of the ISA; an asymmetry would be at the
// rounding level, and cholesky_blocked stays within its bars either way.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;    // the ring of K slices in shared memory
constexpr int kSplitK = 32;   // a split's K span is a multiple of it
constexpr int kPad = 4;       // words of padding a shared row (4 mod 16)
constexpr int kMaxSplits = 64;

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d (16 x 8) += a (16 x 4) b (4 x 8); lane (g, t) = (lane / 4, lane % 4)
// holds a = {A(g, t), A(g + 8, t)}, b = B(t, g) and
// d = {D(g, 2t), D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1)}
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// A block of W x W warps; a warp owns 2 x 4 MMA tiles of 16 x 8 (32 x 32),
// so the block owns a (32 W, 32 W) output tile; K goes through a ring of
// kStages slices BK deep
template <int W, int BK, bool TA>
struct Tile {
  static constexpr int kThreads = 32 * W * W;
  static constexpr int BM = 32 * W;
  static constexpr int BN = 32 * W;
  // a stage: A as [BM][BK + kPad] (row-major A) or [BK][BM + kPad]
  // (transposed A), then B as [BK][BN + kPad]
  static constexpr int kLdA = TA ? BM + kPad : BK + kPad;
  static constexpr int kAWords = TA ? BK * kLdA : BM * kLdA;
  static constexpr int kLdB = BN + kPad;
  static constexpr int kStageWords = kAWords + BK * kLdB;
  static constexpr size_t kSmem = (size_t)kStages * kStageWords * sizeof(double);

  __device__ static double a_at(const double* As, int r, int kk) {
    return TA ? As[kk * kLdA + r] : As[r * kLdA + kk];
  }
};

// at most 128 registers a thread: 4 blocks of 4 warps an SM, or 1 of 16
template <int W, int BK, bool TA>
__global__ void __launch_bounds__(32 * W * W, 4 / (W * W / 4))
gemm_dmma(const double* __restrict__ A, int64_t lda,
          const double* __restrict__ B, int64_t ldb, double* C, int64_t ldc,
          double* __restrict__ part, int m, int n, int k, int kspan,
          double alpha, int accumulate) {
  using T = Tile<W, BK, TA>;
  constexpr int FM = 2, FN = 4;
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / W) * 32;        // the warp's rows in the tile
  const int wn = (warp % W) * 32;        // and columns
  const int64_t m0 = (int64_t)blockIdx.y * T::BM;
  const int64_t n0 = (int64_t)blockIdx.x * T::BN;
  const int kbeg = blockIdx.z * kspan;
  const int kend = min(k, kbeg + kspan);
  const int nkt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  auto load = [&](int slot, int kt) {
    double* As = smem + slot * T::kStageWords;
    double* Bs = As + T::kAWords;
    const int64_t k0 = kbeg + (int64_t)kt * BK;
    if (TA) {
      // A(r, kk) = At[(k0 + kk) lda + m0 + r]: consecutive threads, rows
      for (int e = tid; e < T::BM * BK; e += T::kThreads) {
        const int kk = e / T::BM;
        const int r = e % T::BM;
        const bool ok = m0 + r < m && k0 + kk < kend;
        cp_async8(As + kk * T::kLdA + r,
                  ok ? A + (k0 + kk) * lda + m0 + r : A, ok);
      }
    } else {
      // A(r, kk) = A[(m0 + r) lda + k0 + kk]: consecutive threads, columns
      for (int e = tid; e < T::BM * BK; e += T::kThreads) {
        const int r = e / BK;
        const int kk = e % BK;
        const bool ok = m0 + r < m && k0 + kk < kend;
        cp_async8(As + r * T::kLdA + kk,
                  ok ? A + (m0 + r) * lda + k0 + kk : A, ok);
      }
    }
    for (int e = tid; e < BK * T::BN; e += T::kThreads) {
      const int kk = e / T::BN;
      const int c = e % T::BN;
      const bool ok = k0 + kk < kend && n0 + c < n;
      cp_async8(Bs + kk * T::kLdB + c, ok ? B + (k0 + kk) * ldb + n0 + c : B,
                ok);
    }
  };

  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice it has landed; slice it - 1 is consumed
    const int nxt = it + kStages - 1;
    if (nxt < nkt) load(nxt % kStages, nxt);
    cp_async_commit();
    const double* As = smem + (it % kStages) * T::kStageWords;
    const double* Bs = As + T::kAWords;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      double a[FM][2], b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        a[i][0] = T::a_at(As, wm + 16 * i + g, kk + t);
        a[i][1] = T::a_at(As, wm + 16 * i + g + 8, kk + t);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) b[j] = Bs[(kk + t) * T::kLdB + wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
    }
  }
  cp_async_wait<0>();

  double* slab = part ? part + (int64_t)blockIdx.z * m * n : nullptr;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t r = m0 + wm + 16 * i + g + (c >> 1) * 8;
        const int64_t col = n0 + wn + 8 * j + 2 * t + (c & 1);
        if (r >= m || col >= n) continue;
        const double v = acc[i][j][c];
        if (slab) {
          slab[r * n + col] = v;
        } else {
          double* out = C + r * ldc + col;
          *out = accumulate ? __fma_rn(alpha, v, *out) : __dmul_rn(alpha, v);
        }
      }
}

// C = alpha sum_z part[z] (+ C): the partials added in order z = 0, 1, ...
__global__ void splitk_reduce(const double* __restrict__ part, int splits,
                              double* C, int64_t ldc, int m, int n,
                              double alpha, int accumulate) {
  const int64_t mn = (int64_t)m * n;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  double s = part[e];
  for (int z = 1; z < splits; ++z) s = __dadd_rn(s, part[z * mn + e]);
  double* out = C + (e / n) * ldc + e % n;
  *out = accumulate ? __fma_rn(alpha, s, *out) : __dmul_rn(alpha, s);
}

template <int W, int BK, bool TA>
int launch(const double* A, int64_t lda, const double* B, int64_t ldb,
           double* C, int64_t ldc, double* part, int m, int n, int k,
           int kspan, double alpha, int accumulate, cudaStream_t stream) {
  using T = Tile<W, BK, TA>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_dmma<W, BK, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int splits = k > 0 ? (k + kspan - 1) / kspan : 1;
  const dim3 grid((unsigned)((n + T::BN - 1) / T::BN),
                  (unsigned)((m + T::BM - 1) / T::BM), (unsigned)splits);
  gemm_dmma<W, BK, TA><<<grid, T::kThreads, T::kSmem, stream>>>(
      A, lda, B, ldb, C, ldc, splits > 1 ? part : nullptr, m, n, k, kspan,
      alpha, accumulate);
  return (int)cudaGetLastError();
}

// the menu: 64 x 64 (2 x 2 warps, slices 16 deep, up to 4 blocks an SM)
// and 128 x 128 (4 x 4 warps, slices 32 deep, 212 KB of ring, 1 block)
template <bool TA>
int launch_tile(int tile, const double* A, int64_t lda, const double* B,
                int64_t ldb, double* C, int64_t ldc, double* part, int m,
                int n, int k, int kspan, double alpha, int accumulate,
                cudaStream_t stream) {
  if (tile == 64)
    return launch<2, 16, TA>(A, lda, B, ldb, C, ldc, part, m, n, k, kspan, alpha, accumulate, stream);
  if (tile == 128)
    return launch<4, 32, TA>(A, lda, B, ldb, C, ldc, part, m, n, k, kspan, alpha, accumulate, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C (m, n) [+]= alpha A B; A (m, k) row-major with row stride lda, or with
// trans_a = 1 the transpose of a row-major (k, m) array with row stride
// lda; B (k, n) with row stride ldb; C with row stride ldc; all with unit
// column stride. tile in {64, 128} (the block's square output tile);
// kspan, the K a block covers, a multiple of 32 with ceil(k / kspan) <= 64
// splits. One launch; with more than one split the block sums go to part,
// a (splits, m, n) scratch, and a second launch (splitk_reduce) adds them
// in order into C. m, n >= 1.
int gemm_fp64(const double* A, int64_t lda, int trans_a, const double* B,
              int64_t ldb, double* C, int64_t ldc, double* part, int m, int n,
              int k, int tile, int kspan, double alpha, int accumulate,
              cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || kspan < kSplitK || kspan % kSplitK)
    return (int)cudaErrorInvalidValue;
  const int splits = k > 0 ? (k + kspan - 1) / kspan : 1;
  if (splits > kMaxSplits || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err =
      trans_a ? launch_tile<true>(tile, A, lda, B, ldb, C, ldc, part, m, n, k, kspan, alpha, accumulate, stream)
              : launch_tile<false>(tile, A, lda, B, ldb, C, ldc, part, m, n, k, kspan, alpha, accumulate, stream);
  if (err != 0 || splits == 1) return err;
  const int64_t mn = (int64_t)m * n;
  splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, splits, C, ldc, m, n, alpha, accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
