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
// rounds again (the reference's symmetrize of the stored result). The
// fp64 instance and the fp32/bf16 instances of syr2k_tiles run with
// --fmad=false; syr2k_pairs below writes every rounding out.
//
// The reduced kernel's wide path (syr2k_pairs, fp32 and bf16).
// syr2k_tiles took the same ~0.50 ms at 4 and 2 bytes an entry at n=9997,
// k=16, so bytes did not bound it: half its n_t^2 blocks exit at once, each block computes
// 4 entries a thread with one shared-memory load a multiply, and loads,
// computes and stores in turn. Its least time at MD is the larger of the
// bytes (C read once, out written once: 0.239 ms fp32, 0.120 ms bf16) and
// the instruction floor of its separately rounded fp32 operations (n^2/2 pairs
// x 4k, one instruction each: ~0.10 ms). Design:
//   a persistent walk: gridDim.x blocks (as many as fit on the card), block
//     b takes the pairs t = b, b + gridDim.x, .. of the row-major upper
//     triangle of 64 x 64 tile pairs (tile_of, symv.cu's), so no block is
//     launched only to exit;
//   a pair (I, J >= I) is the two C tiles (I, J) and (J, I), staged in
//     shared memory by cp.async in 16-byte chunks, kStages deep (3 for
//     bf16, 2 for fp32, whose tiles are twice the size): a pair's tiles
//     are requested kStages - 1 pairs ahead, and its panel slices (V and W at
//     the rows of I and of J, 16 columns) are loaded into registers during
//     the pair before and stored transposed ([k][row], fp32) when it
//     starts;
//   256 threads, each a 4 x 4 register micro-tile (4 rows of I, 4 of J):
//     per panel column it loads 16 values (four 16-byte shared loads) for
//     32 products and 32 sums, VW^T and WV^T in separate accumulators
//     (8 x 4 tiles on 128 threads measured slower for fp32, PERF.md);
//   the epilogue reads C_IJ and C_JI (both as row vectors: an XOR swizzle
//     of the 16-byte chunks keeps the transposed reads free of bank
//     conflicts), writes out's entries into the same places, and stores
//     both tiles by 16-byte vectors; the contribution is computed ONCE a
//     pair, as in syr2k_tiles.
// Rounding, bitwise with kernels/syr2k/ref.py syr2k_reduced_ref: each
// product and sum an explicit __fmul_rn / __fadd_rn (no dependence on
// --fmad), the k columns summed in order from 0, V W^T and W V^T kept
// apart and then added, rnd<S> at the store and again after the
// symmetrizing average. In place: a block reads both tiles of a pair
// into shared memory and synchronizes before it writes any entry, and
// only that block touches them, so out may be C.
// Two paths, picked by the wrapper from C's and out's alignment: where
// their pointers and row strides are 16-byte aligned (the padded working
// copies of TT1 and the blocked TD1, core/precision.py::padded_copy), the
// wide path, syr2k_pairs (cp.async and 16-byte stores; a chunk that
// crosses column n goes entry by entry); otherwise the narrow path,
// syr2k_tiles' fp32/bf16 instances (entry by entry through shared
// memory, no vector access; faster than syr2k_pairs with its chunks taken
// entry by entry). Both are bitwise with syr2k_reduced_ref, so the path
// changes no bit.
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

// the tile pair at position t of the row-major upper triangle of nt x nt
// tiles (symv.cu's tile_of)
__device__ __forceinline__ void tile_of(int t, int nb, int* ib, int* jb) {
  const double b = 2.0 * nb + 1.0;
  int i = (int)(0.5 * (b - sqrt(b * b - 8.0 * t)));
  while (i > 0 && i * nb - i * (i - 1) / 2 > t) --i;
  while ((i + 1) * nb - (i + 1) * i / 2 <= t) ++i;
  *ib = i;
  *jb = i + t - (i * nb - i * (i - 1) / 2);
}

// ---- the reduced kernel: a persistent walk of tile pairs ------------------

constexpr int kPT = 64;                 // tile edge of a pair
constexpr int kMJ = 4;                  // micro-tile rows of J (16 groups)
constexpr int kMI = 4;                  // micro-tile rows of I (16 groups)
constexpr int kPThreads = 16 * (kPT / kMI);   // 256
constexpr int kPK = 16;                 // panel columns a stage
constexpr int kPitch = kPT + 4;         // floats a row of a staged slice
constexpr int kPanelVals = 4 * kPT * kPK / kPThreads;   // a thread's share

template <typename S>
constexpr int kCVec = 16 / (int)sizeof(S);   // entries of a 16-byte chunk

// C tile stages: this pair's and the next kStages - 1 pairs' in flight
// (fp32: 2, the most that lets two blocks share an SM's shared memory)
template <typename S>
constexpr int kStages = sizeof(S) == 2 ? 3 : 2;
constexpr int kPairBlocks = 2;          // blocks an SM: <= 128 registers

template <typename S>
struct PairSmem {
  S c[kStages<S>][2][kPT * kPT];        // [stage][C_IJ, C_JI], swizzled
  float vw[4][kPK][kPitch];             // V_I, W_I, V_J, W_J: [k][row]
};

// entry (r, c) of a swizzled 64 x 64 tile: 16-byte chunk c / VEC of row r
// sits at chunk (c / VEC) ^ ((r / 4) % 8)
template <typename S>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int VEC = kCVec<S>;
  return r * kPT + (((c / VEC) ^ ((r >> 2) & 7)) * VEC) + c % VEC;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile rows r0.. cols c0.. of C into a swizzled shared tile: by cp.async
// chunks where a chunk lies inside C, else entry by entry; entries past n
// are left as they are (never stored)
template <typename S>
__device__ __forceinline__ void stage_tile(S* tile, const S* C, int64_t ldc,
                                           int n, int r0, int c0) {
  constexpr int VEC = kCVec<S>;
  constexpr int CPR = kPT / VEC;        // chunks a row
  for (int e = threadIdx.x; e < kPT * CPR; e += kPThreads) {
    const int r = e / CPR;
    const int cc = (e % CPR) * VEC;
    const int gi = r0 + r;
    const int gj = c0 + cc;
    if (gi >= n || gj >= n) continue;
    S* dst = tile + swz<S>(r, cc);
    const S* src = C + (int64_t)gi * ldc + gj;
    if (gj + VEC <= n) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int w = 0; w < VEC; ++w)
        if (gj + w < n) dst[w] = src[w];
    }
  }
}

// a swizzled shared tile into out rows r0.., cols c0.. (inside n only)
template <typename S>
__device__ __forceinline__ void store_tile(const S* tile, S* out,
                                           int64_t ldo, int n, int r0,
                                           int c0) {
  constexpr int VEC = kCVec<S>;
  constexpr int CPR = kPT / VEC;
  for (int e = threadIdx.x; e < kPT * CPR; e += kPThreads) {
    const int r = e / CPR;
    const int cc = (e % CPR) * VEC;
    const int gi = r0 + r;
    const int gj = c0 + cc;
    if (gi >= n || gj >= n) continue;
    const S* src = tile + swz<S>(r, cc);
    S* dst = out + (int64_t)gi * ldo + gj;
    if (gj + VEC <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int w = 0; w < VEC; ++w)
        if (gj + w < n) dst[w] = src[w];
    }
  }
}

// this thread's share of the panel slices of pair (ib, jb), columns k0 ..
// k0 + 15: V_I, W_I, V_J, W_J, 64 rows each, zero past n and k
template <typename S>
__device__ __forceinline__ void load_panels(
    float (&pre)[kPanelVals], const S* V, int64_t ldv, const S* W,
    int64_t ldw, int n, int k, int ib, int jb, int k0) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const S* P = m % 2 == 0 ? V : W;
    const int64_t ld = m % 2 == 0 ? ldv : ldw;
    const int base = (m < 2 ? ib : jb) * kPT;
#pragma unroll
    for (int i = 0; i < kPanelVals / 4; ++i) {
      const int e = threadIdx.x + kPThreads * i;
      const int r = e / kPK;
      const int kk = e % kPK;
      const bool in = base + r < n && k0 + kk < k;
      pre[m * (kPanelVals / 4) + i] =
          in ? to_acc(P[(int64_t)(base + r) * ld + k0 + kk]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store_panels(
    float (&vw)[4][kPK][kPitch], const float (&pre)[kPanelVals]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int i = 0; i < kPanelVals / 4; ++i) {
      const int e = threadIdx.x + kPThreads * i;
      vw[m][e % kPK][e / kPK] = pre[m * (kPanelVals / 4) + i];
    }
  }
}

// four consecutive entries of a swizzled tile's row, in fp32
template <typename S>
__device__ __forceinline__ void read4(const S* tile, int r, int c,
                                      float (&v)[4]) {
  if constexpr (sizeof(S) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(tile + swz<S>(r, c));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(tile + swz<S>(r, c));
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
}

template <typename S>
__device__ __forceinline__ void write4(S* tile, int r, int c,
                                       const float (&v)[4]) {
  if constexpr (sizeof(S) == 4) {
    *reinterpret_cast<float4*>(tile + swz<S>(r, c)) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    // v holds values already rounded to bf16: their upper halves
    const uint2 x = make_uint2(
        (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xffff0000u),
        (__float_as_uint(v[2]) >> 16) | (__float_as_uint(v[3]) & 0xffff0000u));
    *reinterpret_cast<uint2*>(tile + swz<S>(r, c)) = x;
  }
}

// M (a multiple of 4) consecutive entries of a swizzled tile's row, in
// fp32, and back
template <int M, typename S>
__device__ __forceinline__ void read_row(const S* tile, int r, int c,
                                         float (&v)[M]) {
#pragma unroll
  for (int h = 0; h < M / 4; ++h) {
    float x[4];
    read4<S>(tile, r, c + 4 * h, x);
#pragma unroll
    for (int a = 0; a < 4; ++a) v[4 * h + a] = x[a];
  }
}

template <int M, typename S>
__device__ __forceinline__ void write_row(S* tile, int r, int c,
                                          const float (&v)[M]) {
#pragma unroll
  for (int h = 0; h < M / 4; ++h) {
    const float x[4] = {v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
    write4<S>(tile, r, c + 4 * h, x);
  }
}

// M (a multiple of 4) consecutive floats of a staged panel slice
template <int M>
__device__ __forceinline__ void load_rows(float (&v)[M], const float* p) {
#pragma unroll
  for (int h = 0; h < M / 4; ++h) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * h);
    v[4 * h] = x.x;
    v[4 * h + 1] = x.y;
    v[4 * h + 2] = x.z;
    v[4 * h + 3] = x.w;
  }
}

template <typename S>
__global__ void __launch_bounds__(kPThreads, kPairBlocks)
syr2k_pairs(const S* C, int64_t ldc, const S* __restrict__ V, int64_t ldv,
            const S* __restrict__ W, int64_t ldw, S* out, int64_t ldo, int n,
            int k, float alpha, int sym, int nt, int npairs) {
  constexpr int NS = kStages<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PairSmem<S>& sm = *reinterpret_cast<PairSmem<S>*>(smem_raw);
  const int r0 = kMI * (threadIdx.x >> 4);   // this thread's rows of I
  const int c0 = kMJ * (threadIdx.x & 15);   // and of J
  const int nq = (k + kPK - 1) / kPK;
  const int G = gridDim.x;
  int t = blockIdx.x;
  if (t >= npairs) return;
  // the C tiles of pair tp into stage s, as one cp.async group (empty
  // past the last pair, so that every pair counts one group)
  auto stage_pair = [&](int tp, int s) {
    if (tp < npairs) {
      int ip, jp;
      tile_of(tp, nt, &ip, &jp);
      stage_tile<S>(sm.c[s][0], C, ldc, n, ip * kPT, jp * kPT);
      if (ip != jp)
        stage_tile<S>(sm.c[s][1], C, ldc, n, jp * kPT, ip * kPT);
    }
    cp_async_commit();
  };
  for (int j = 0; j + 1 < NS; ++j) stage_pair(t + j * G, j);
  float pre[kPanelVals];
  int ib, jb;
  tile_of(t, nt, &ib, &jb);
  if (nq > 0) load_panels<S>(pre, V, ldv, W, ldw, n, k, ib, jb, 0);

  for (int i = 0; t < npairs; t += G, ++i) {
    const int s = i % NS;
    tile_of(t, nt, &ib, &jb);
    const bool diag = ib == jb;
    // the C tiles of the pair NS - 1 ahead (into the stage the last pair
    // freed) and the next pair's panel slices, requested once this pair's
    // tiles have landed and its last panel slice is staged
    auto prefetch = [&]() {
      stage_pair(t + (NS - 1) * G, (i + NS - 1) % NS);
      const int tn = t + G;
      if (tn < npairs && nq > 0) {
        int in, jn;
        tile_of(tn, nt, &in, &jn);
        load_panels<S>(pre, V, ldv, W, ldw, n, k, in, jn, 0);
      }
    };

    float d1[kMI][kMJ], d2[kMI][kMJ];
#pragma unroll
    for (int a = 0; a < kMI; ++a)
#pragma unroll
      for (int b = 0; b < kMJ; ++b) d1[a][b] = d2[a][b] = 0.f;
    if (nq == 0) {
      cp_async_wait<NS - 2>();          // this pair's C tiles
      __syncthreads();
      prefetch();
    }
    for (int q = 0; q < nq; ++q) {
      if (q > 0) {
        __syncthreads();                // the last slice is consumed
        load_panels<S>(pre, V, ldv, W, ldw, n, k, ib, jb, q * kPK);
      }
      store_panels(sm.vw, pre);
      if (q == 0) cp_async_wait<NS - 2>();   // this pair's C tiles
      __syncthreads();
      if (q == nq - 1) prefetch();
      const int kc = min(kPK, k - q * kPK);
      for (int kk = 0; kk < kc; ++kk) {
        // this thread's rows of the four slices at column kk, in fp32
        float vi[kMI], wi[kMI], vj[kMJ], wj[kMJ];
        load_rows<kMI>(vi, &sm.vw[0][kk][r0]);
        load_rows<kMI>(wi, &sm.vw[1][kk][r0]);
        load_rows<kMJ>(vj, &sm.vw[2][kk][c0]);
        load_rows<kMJ>(wj, &sm.vw[3][kk][c0]);
#pragma unroll
        for (int a = 0; a < kMI; ++a) {
#pragma unroll
          for (int b = 0; b < kMJ; ++b) {
            d1[a][b] = __fadd_rn(d1[a][b], __fmul_rn(vi[a], wj[b]));
            d2[a][b] = __fadd_rn(d2[a][b], __fmul_rn(wi[a], vj[b]));
          }
        }
      }
    }

    // ---- epilogue: R = C + alpha (D + D^T) at both tiles, [symmetrized]
    S* const tij = sm.c[s][0];
    S* const tji = diag ? sm.c[s][0] : sm.c[s][1];
    float cij[kMI][kMJ], cji[kMJ][kMI];
#pragma unroll
    for (int a = 0; a < kMI; ++a) read_row<kMJ, S>(tij, r0 + a, c0, cij[a]);
#pragma unroll
    for (int b = 0; b < kMJ; ++b) read_row<kMI, S>(tji, c0 + b, r0, cji[b]);
#pragma unroll
    for (int a = 0; a < kMI; ++a) {
#pragma unroll
      for (int b = 0; b < kMJ; ++b) {
        const float ac = __fmul_rn(alpha, __fadd_rn(d1[a][b], d2[a][b]));
        const float r1 = rnd<S>(__fadd_rn(cij[a][b], ac));
        const float r2 = rnd<S>(__fadd_rn(cji[b][a], ac));
        if (sym) {
          const float o = rnd<S>(__fmul_rn(0.5f, __fadd_rn(r1, r2)));
          cij[a][b] = o;
          cji[b][a] = o;
        } else {
          cij[a][b] = r1;
          cji[b][a] = r2;
        }
      }
    }
    __syncthreads();                    // every entry of the pair is read
#pragma unroll
    for (int a = 0; a < kMI; ++a) write_row<kMJ, S>(tij, r0 + a, c0, cij[a]);
    if (!diag) {
#pragma unroll
      for (int b = 0; b < kMJ; ++b)
        write_row<kMI, S>(tji, c0 + b, r0, cji[b]);
    }
    __syncthreads();
    store_tile<S>(tij, out, ldo, n, ib * kPT, jb * kPT);
    if (!diag) store_tile<S>(tji, out, ldo, n, jb * kPT, ib * kPT);
  }
  cp_async_wait<0>();
}

template <typename S>
int launch_pairs(const S* C, int64_t ldc, const S* V, int64_t ldv,
                 const S* W, int64_t ldw, S* out, int64_t ldo, int n, int k,
                 double alpha, int sym, cudaStream_t stream) {
  const int nt = (n + kPT - 1) / kPT;
  const int npairs = nt * (nt + 1) / 2;
  const int smem = (int)sizeof(PairSmem<S>);
  static int blocks_per_sm = 0;         // once a process, per instance
  static int sms = 0;
  if (blocks_per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(syr2k_pairs<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, syr2k_pairs<S>, kPThreads, smem);
    const int err = (int)cudaGetLastError();
    if (err != cudaSuccess || blocks_per_sm < 1) {
      blocks_per_sm = 0;
      return err != cudaSuccess ? err : (int)cudaErrorInvalidConfiguration;
    }
  }
  const int grid = min(npairs, blocks_per_sm * sms);
  syr2k_pairs<S><<<grid, kPThreads, smem, stream>>>(
      C, ldc, V, ldv, W, ldw, out, ldo, n, k, (float)alpha, sym, nt, npairs);
  return (int)cudaGetLastError();
}

// the reduced instances by path: 0 the narrow path (syr2k_tiles), 1 the
// wide path (syr2k_pairs)
template <typename S>
int launch_reduced(const S* C, int64_t ldc, const S* V, int64_t ldv,
                   const S* W, int64_t ldw, S* out, int64_t ldo, int n, int k,
                   double alpha, int sym, int path, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (path) {
    case 0: return launch(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym,
                          stream);
    case 1: return launch_pairs(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha,
                                sym, stream);
    default: return (int)cudaErrorInvalidValue;
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
  return launch(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym, stream);
}

// The same in fp32, and in bf16 (computed in fp32), by path: 0 the narrow
// path (syr2k_tiles, any layout), 1 the wide path (syr2k_pairs; C's and
// out's pointers and row strides multiples of 16 bytes).
int syr2k_fp32(const float* C, int64_t ldc, const float* V, int64_t ldv,
               const float* W, int64_t ldw, float* out, int64_t ldo, int n,
               int k, double alpha, int sym, int path, cudaStream_t stream) {
  return launch_reduced(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym,
                        path, stream);
}

int syr2k_bf16(const __nv_bfloat16* C, int64_t ldc, const __nv_bfloat16* V,
               int64_t ldv, const __nv_bfloat16* W, int64_t ldw,
               __nv_bfloat16* out, int64_t ldo, int n, int k, double alpha,
               int sym, int path, cudaStream_t stream) {
  return launch_reduced(C, ldc, V, ldv, W, ldw, out, ldo, n, k, alpha, sym,
                        path, stream);
}

}  // extern "C"
