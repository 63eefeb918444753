// Givens rotations of the TT2 bulge chase and the TT4 replay for Hopper
// (sm_90a). One rotation, three entry points:
//   rot_apply   — G rotations of G row pairs, the TPU kernel's function;
//   chase_pass  — one whole TT2 bandwidth pass (b -> b-1) over the packed
//                 band, recording its (c, s) table, in ONE launch;
//   replay_pass — one pass of a recorded table applied to row storage, in
//                 reverse with (c, -s) for Q2 Z, or forward for Q1 Q2.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/rot_apply/kernel.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces _rot_apply_kernel behind rot_apply_pallas
// (repro/kernels/rot_apply/kernel.py), which the reference calls twice
// per wavefront step of its chase (core/sbr.py _chase_pass) and once per
// sweep of its replay (_replay_pass). The rotation keeps the TPU kernel's
// operation order, (c x0 + s x1, -s x0 + c x1); under --fmad=false each
// product and sum rounds on its own, as in the plain PyTorch version, so
// rot_apply and the chase's (c, s) are bitwise equal to their plain
// versions.
//
// What bounds them.
//   rot_apply: bytes, 2 G L doubles in and out: 256 KB at the chase's
//     widest wavefront (G = 1000, L = 8), under 0.1 us of HBM, so a call
//     costs its launch and the host's work around it. The kernel takes a
//     2-D grid, x over pairs and y over column chunks: a block of 256
//     threads holds 256 / tx pairs of tx = min(256, pow2 >= L) threads,
//     consecutive threads on consecutive L entries; each pair's (c, s) is
//     loaded once into shared memory; 32-bit offsets (the wrapper checks
//     G L < 2^31, so the 2 G L entries fit below 2^32); no division.
//   chase_pass: latency. At the MD band (n = 9997, w = 16) the 15 passes
//     take 319,612 dependent time steps here (489,403 at the reference's
//     stagger); their work (~4.7e10 flops) and bytes (the 1.4 MB band)
//     would take ~1.4 ms. A step costs its barrier and its chain of
//     dependent loads, rotation and stores.
//   replay_pass: at TT4 (an (n, 100) slab) the rotations' flops,
//     1.19e8 rotations x 100 columns x 6, about 2 ms at the fp64 rate,
//     against ~1.1 ms to read the 3.8 GB table once; and the J sweeps of
//     a pass are dependent. Every column needs the whole table, so the
//     table's bytes per SM, not the slab's, set the pace once the slab is
//     on chip.
//
// Design of chase_pass. The reference gathers a dense (2b+4)^2 window per
// wavefront lane, rotates rows and columns, and scatters the window back;
// the stagger of the schedule makes the lanes' windows disjoint within a
// step (core/sbr.py). Here the rotation runs in place on the packed band:
// of the window, only rows r-1, r left of the 2 x 2 block, the 2 x 2
// block, and columns r-1, r below it change in the lower triangle, so a
// lane touches packed columns r-b-2 .. r only, not 2b+4 of them. Sweeps
// therefore start g = ceil((b+4)/b) steps apart (the caller's schedule,
// kernels/rot_apply/schedule.py) instead of the reference's
// 2 + ceil(5/b): about 2/3 of the reference's steps, with the same
// rotations in the same order on every entry. Per step every thread first
// loads its lanes' row and column pairs (2b+2 per lane), and one thread
// per active lane loads the pivot, the target and the 2 x 2 block, all in
// flight at once; that thread computes the Givens rotation, records (c, s)
// in the table and in shared memory, and rotates the block. A block
// barrier; then every thread rotates and stores its pairs (they are
// disjoint, and none is the block). Then a barrier across all the lanes:
// a lane's next footprint can overlap its neighbours' last ones. Entries
// the reference reads as zero (below the w+2 stored diagonals) are read as
// zero and not written. At the end the annihilated diagonals Wp[b:, :]
// are zeroed. Two kernels run this step:
//   chase_cluster_kernel — the band on chip: one thread-block cluster of
//     up to 16 CTAs (non-portable size) holds the whole padded band in its
//     distributed shared memory, each CTA a contiguous range of columns
//     (1.45 MB at MD in fp64: 16 x 91 KB; 2.5 MB at n = 17243, w = 16;
//     0.72 MB at 4 bytes an entry in fp32 and bf16). A CTA takes the lanes
//     whose plane column it holds, so a footprint is local but where it
//     straddles two CTAs, and reaches a neighbour's columns through
//     cluster.map_shared_rank (ld/st.shared::cluster). The barrier is
//     barrier.cluster.arrive/wait (cluster.sync()), not a global atomic;
//     the band is read from global memory once at the start and written
//     back once at the end. The (c, s) table goes to global memory as
//     before: no lane reads it back within the pass.
//   chase_pass_kernel — the band in global memory, for a band larger than
//     a cluster holds: lanes split over up to 53 co-resident blocks of at
//     most 32 (one cooperative launch), loads through L2 (ld_cg), and a
//     grid barrier a step (an atomic counter and a spin).
//
// Design of replay_pass. Rotation (j, k) of a pass acts on rows r-1, r
// with r = j + (k+1) b, and rows never mix columns. Two kernels:
//   replay_slab_kernel — the slab's columns on chip. A CTA holds one
//     column, all n rows, in shared memory for the whole pass (78 KB at
//     n = 9997 in fp64, 39 KB in fp32, 20 KB in bf16; 135 KB at
//     n = 17243 in fp64), read and written back once; a slab
//     wider than the card runs in waves. The pass runs in chunks of
//     m = b-1 sweeps: within a chunk the rotations of lane k touch only
//     the b rows [j0 + (k+1) b - 1, j0 + (k+2) b - 1), disjoint across
//     lanes, so a thread takes a lane and streams its rotations in sweep
//     order (forward; backward with (c, -s) in reverse) through one
//     carried row, and one barrier of the consumer threads serves b-1
//     sweeps. Every row sees the same rotations in the same order as the
//     sweep-by-sweep replay: the result is the same bits. The (c, s)
//     table, 12-100x the slab's bytes a pass, is what every CTA needs
//     whole: a producer warp stages it in slices (a range of lanes by a
//     range of the chunk's sweeps) through two buffers with
//     cp.async.bulk, behind mbarriers, running ahead of the consumers.
//     (Sharing each slice across a cluster by .multicast::cluster, so L2
//     serves it once a cluster, measured slower at the MD and DFT shapes;
//     PERF.md keeps the numbers.) The column is laid out so that the
//     lanes of a warp (b rows apart) fall on distinct banks: an XOR
//     swizzle for even b at fp64, b rows to a stride at 4 and 2 bytes
//     (slab_rows). Below fp64 a (c, s) pair is 8 or 4 bytes and a table
//     row starts j (K0+1) pairs in, mostly off a 16-byte boundary, where
//     cp.async.bulk needs one: each row's copy starts at the boundary at
//     or below it, ends at the one at or above, and the consumers read
//     its pairs past that offset (slab_geom).
//   replay_pass_kernel — the slab in global memory, for what the slab
//     kernel cannot take (kernels/rot_apply/kernel.py replay_plan):
//     blocks of 1024 threads take 4-column chunks and loop over the J
//     sweeps with a barrier between sweeps, the sweep's (rotation,
//     column) items spread over the threads, four per thread in flight at
//     once.
// Slots past a sweep's end hold the identity and are skipped.
//
// Instances (reduced.cuh). Every kernel has fp64, fp32 and bf16 instances:
// stored in fp32 or bf16, computed in fp32 (the TPU kernel rotates bf16
// tiles in fp32 and rounds at the store). Both chase kernels and both
// replay kernels take every dtype, and the wrapper picks between the two
// of each by size alone (kernels/rot_apply/kernel.py chase_plan,
// replay_plan), at every dtype. The reduced chase computes each Givens
// rotation in fp32 from the stored entries and rounds (c, s) to the
// storage type (its table's type, and the values it rotates with); every
// rotated entry rounds at its store, and the 2 x 2 block also between its
// row and its column rotation, as the reference's wavefront stores the
// rotated rows before it rotates the columns. The cluster kernel keeps the
// band on chip as fp32 values rounded at those points. The reduced replay
// rounds both rows of each rotation, the slab kernel's carried row too.
// The plain versions (kernels/rot_apply/ref.py, and schedule.py
// replay_chunked for the slab's order) round at the same points, so every
// instance is bitwise equal to its plain version; at fp64 every rounding
// is the identity.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduced.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPLeft = 2;            // left margin of the padded band
constexpr int kChaseThreads = 512;
constexpr int kMaxLanesPerBlock = 32;   // wavefront lanes of one chase block
constexpr int kBatch = 4;            // pair rotations in flight per thread
constexpr int kMaxCluster = 16;      // CTAs of a chase cluster (non-portable)
constexpr int kReplayThreads = 1024;
constexpr int kReplayCols = 4;       // one 32-byte sector of a row

template <typename A>
__device__ __forceinline__ void rotate(A c, A s, A x0, A x1, A* y0, A* y1) {
  *y0 = c * x0 + s * x1;
  *y1 = -s * x0 + c * x1;
}

template <typename S>
__global__ void __launch_bounds__(256)
rot_apply_kernel(const S* __restrict__ X, const S* __restrict__ CS,
                 S* __restrict__ Y, unsigned G, unsigned L) {
  using A = typename Acc<S>::type;
  __shared__ A cs[2 * 256];
  const unsigned tx = blockDim.x;                 // threads of a pair
  const unsigned ty = blockDim.y;                 // pairs of the block
  const unsigned tid = threadIdx.y * tx + threadIdx.x;
  const unsigned g0 = blockIdx.x * ty;
  // the block's 2 ty (c, s) entries; at L = 1 a block holds 256 pairs,
  // so each thread stages two
  for (unsigned i = tid; i < 2 * ty && g0 + i / 2 < G; i += tx * ty)
    cs[i] = to_acc(CS[2 * g0 + i]);
  __syncthreads();
  const unsigned g = g0 + threadIdx.y;
  if (g >= G) return;
  const A c = cs[2 * threadIdx.y];
  const A s = cs[2 * threadIdx.y + 1];
  const unsigned base = 2 * g * L;
  for (unsigned l = blockIdx.y * tx + threadIdx.x; l < L;
       l += gridDim.y * tx) {
    A y0, y1;
    rotate(c, s, to_acc(X[base + l]), to_acc(X[base + L + l]), &y0, &y1);
    Y[base + l] = from_acc<S>(y0);
    Y[base + L + l] = from_acc<S>(y1);
  }
}

// lane decode of the wavefront schedule (core/sbr.py _chase_pass): lane l
// rides column j = jtop - l at chase step k; r is the rotation plane
// (r-1, r); false when the lane is idle at this step
__device__ __forceinline__ bool lane_state(int t, int l, int g, int J, int n,
                                           int b, int* j, int* k) {
  const int jtop = min(t / g, J - 1);
  *j = jtop - l;
  if (*j < 0) return false;
  *k = t - g * (*j);
  const int Kj = (n - 1 - *j - b) / b + 1;
  return *k >= 0 && *k < Kj;
}

// A load from L2 (past this SM's L1) of data other blocks wrote before the
// last barrier. Volatile with a memory clobber: __ldcg's asm declares no
// memory access, so the compiler may move it above the barrier.
__device__ __forceinline__ double ld_cg(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// a bf16 entry, widened to fp32
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.cg.b16 %0, [%1];" : "=h"(v) : "l"(p) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// all blocks of the (cooperative, hence co-resident) grid meet here;
// ``target`` counts the arrivals every block waits for, the same in all
__device__ void grid_sync(unsigned int* count, unsigned int& target) {
  __threadfence();   // this thread's writes before the arrival
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    atomicAdd(count, 1u);
    while (*(volatile unsigned int*)count < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The packed band is read through strides (sd between diagonals, sc
// between columns; the TT2 chase keeps it column-major, so a column's
// diagonals are contiguous) and with ld_cg: other blocks write it, so
// reads go to L2, past this SM's L1.
// kMode selects a timing variant (chip_smoke.py times the parts of a step
// apart): kFull, the pass; kBarrierOnly, only the steps' barriers;
// kNoBarrier, the steps' loads, rotations and stores with no barrier
// between steps; and, for the cluster kernel, the pass with every access
// to the previous CTA's columns sent to this CTA's own (kLocalOnly), with
// a fixed rotation in place of the Givens square root and divisions
// (kNoGivens), or without the block barrier between the phases
// (kNoBlockSync). The variants' results are garbage: timing only, on a
// scratch copy.
constexpr int kFull = 0, kBarrierOnly = 1, kNoBarrier = 2, kLocalOnly = 3,
              kNoGivens = 4, kNoBlockSync = 5;

template <typename S, int kMode>
__global__ void __launch_bounds__(kChaseThreads)
chase_pass_kernel(S* __restrict__ Wp, int64_t sd, int64_t sc,
                  int64_t npad, S* __restrict__ CS, unsigned int* bar,
                  int n, int b, int w, int g, int T_pass, int G, int J,
                  int K0, int lpb) {
  using A = typename Acc<S>::type;
  __shared__ A s_cs[2 * kMaxLanesPerBlock];
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int nb = gridDim.x;
  const int l0 = blk * lpb;
  const int nl = max(0, min(G, l0 + lpb) - l0);
  const int pitems = 2 * b + 2;      // row pairs and column pairs per lane
  const int total = nl * pitems;     // <= kChaseThreads * kBatch (host)
  unsigned int target = 0;
  for (int t = 0; t < T_pass; ++t) {
    if (kMode == kBarrierOnly) {
      grid_sync(bar, target);
      continue;
    }
    // ---- loads: this thread's pairs (phase B) and, for one lane, the
    // pivot, target and 2 x 2 block (phase A), all in flight at once -----
    S* q0[kBatch];
    S* q1[kBatch];
    A x0[kBatch], x1[kBatch];
    int lane_of[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      q0[m] = q1[m] = nullptr;
      x0[m] = x1[m] = A(0);
      lane_of[m] = -1;
      const int idx = tid + m * kChaseThreads;
      if (idx >= total) continue;
      const int li = idx / pitems;
      const int it = idx % pitems;
      int j, k;
      if (!lane_state(t, l0 + li, g, J, n, b, &j, &k)) continue;
      lane_of[m] = li;
      const int64_t c0 = j + (int64_t)(k + 1) * b - b - 2 + kPLeft;
      int64_t d0, d1, col0, col1;
      if (it <= b) {
        // rows r-1, r at window column q = it: packed (b+1-q), (b+2-q)
        d0 = b + 1 - it;
        d1 = b + 2 - it;
        col0 = col1 = c0 + it;
      } else {
        // columns r-1, r at window row p = it + 2 in [b+3, 2b+3]:
        // packed (p-b-1, b+1), (p-b-2, b+2)
        d0 = it + 1 - b;
        d1 = it - b;
        col0 = c0 + b + 1;
        col1 = c0 + b + 2;
      }
      // entries below the w+2 stored diagonals read as zero, unwritten
      if (d0 <= w + 1) {
        q0[m] = Wp + d0 * sd + col0 * sc;
        x0[m] = ld_cg(q0[m]);
      }
      if (d1 <= w + 1) {
        q1[m] = Wp + d1 * sd + col1 * sc;
        x1[m] = ld_cg(q1[m]);
      }
    }
    // ---- phase A: per active lane, the Givens rotation from the pivot and
    // target entries, and the whole 2 x 2 block of rows/columns r-1, r ----
    if (tid < nl) {
      const int li = tid;
      int j, k;
      const bool active = lane_state(t, l0 + li, g, J, n, b, &j, &k);
      if (active) {
        const int r = j + (k + 1) * b;
        const int sk = k > 0 ? 1 : 0;
        // pivot W[r-1, r-b-sk], target W[r, r-b-sk]; the block W[r-1, r-1],
        // W[r, r-1] = W[r-1, r], W[r, r]
        const int64_t col = (r - b - sk + kPLeft) * sc;
        const int64_t cb = (r - 1 + kPLeft) * sc;
        const A a = ld_cg(Wp + (b - 1 + sk) * sd + col);
        const A bb = ld_cg(Wp + (b + sk) * sd + col);
        S* p11 = Wp + cb;
        S* p21 = Wp + sd + cb;
        S* p22 = Wp + cb + sc;
        const A a11 = ld_cg(p11), a21 = ld_cg(p21), a22 = ld_cg(p22);
        const A rr = sqrt(a * a + bb * bb);
        const bool safe = rr > A(0);
        const A den = safe ? rr : A(1);
        // (c, s) at the table's precision
        const A c = rnd<S>(safe ? a / den : A(1));
        const A s = rnd<S>(safe ? bb / den : A(0));
        S* slot = CS + ((int64_t)j * (K0 + 1) + k) * 2;
        slot[0] = from_acc<S>(c);
        slot[1] = from_acc<S>(s);
        s_cs[2 * li] = c;
        s_cs[2 * li + 1] = s;
        // rows, then columns, as the reference's two rot_apply calls, the
        // rotated rows stored between them
        A r11, r21, r12, r22, n11, n12, n21, n22;
        rotate(c, s, a11, a21, &r11, &r21);
        rotate(c, s, a21, a22, &r12, &r22);
        r11 = rnd<S>(r11);
        r21 = rnd<S>(r21);
        r12 = rnd<S>(r12);
        r22 = rnd<S>(r22);
        rotate(c, s, r11, r12, &n11, &n12);
        rotate(c, s, r21, r22, &n21, &n22);
        *p11 = from_acc<S>(n11);
        *p21 = from_acc<S>(n21);
        *p22 = from_acc<S>(n22);
      }
    }
    __syncthreads();
    // ---- phase B: rotate and store the pairs loaded above ---------------
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (lane_of[m] < 0) continue;
      A y0, y1;
      rotate(s_cs[2 * lane_of[m]], s_cs[2 * lane_of[m] + 1], x0[m], x1[m],
             &y0, &y1);
      if (q0[m]) *q0[m] = from_acc<S>(y0);
      if (q1[m]) *q1[m] = from_acc<S>(y1);
    }
    // the next step's lanes read what neighbouring lanes, in other
    // blocks, wrote in this one
    if (kMode == kFull) grid_sync(bar, target);
    else __syncthreads();
  }
  // the annihilated diagonals carry O(eps) residue: zero them
  for (int64_t idx = (int64_t)blk * kChaseThreads + tid;
       idx < (int64_t)(w + 2 - b) * npad;
       idx += (int64_t)nb * kChaseThreads) {
    Wp[(b + idx / npad) * sd + (idx % npad) * sc] = from_acc<S>(A(0));
  }
}

__device__ __forceinline__ int floor_div(int a, int d) {
  return a >= 0 ? a / d : -((-a + d - 1) / d);
}

// The cluster barrier in two halves: arrive (release: this thread's
// shared-memory writes, local and remote, before it) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The band in the distributed shared memory of one thread-block cluster:
// CTA ``rank`` holds packed columns [C0, C0 + cpc), column-major with w+2
// diagonals a column, as values of the compute type A. A lane's footprint
// reaches at most b+2 columns left of its plane column, and cpc >= w+3
// (the wrapper's plan), so an entry lies in this CTA's columns or in the
// previous CTA's, which it reaches over the SM-to-SM network through
// cluster.map_shared_rank.
template <typename A>
struct ClusterBand {
  A* own;    // this CTA's columns
  A* prev;   // the previous CTA's (rank - 1)
  int C0, cpc, ldb;
  __device__ __forceinline__ A* at(int d, int col) const {
    return col >= C0 ? own + (col - C0) * ldb + d
                     : prev + (col - C0 + cpc) * ldb + d;
  }
};

// The band on chip holds compute-type values (A = Acc<S>), each rounded to
// S wherever the cooperative instance stores to S: the same values the
// global band would hold, so the same bits. bf16 thus shares fp32's
// 4-byte layout: a 2-byte one would halve shared memory that no plan is
// short of (the MD band is 0.72 MB at 4 bytes; 8 CTAs hold it in 90 KB
// each, and the lanes' slots, not the bytes, keep 4 CTAs from taking it:
// kernels/rot_apply/kernel.py chase_plan), and would put a conversion on
// every load of the step's chain instead of one at each store.
template <typename S, int kMode>
__global__ void __launch_bounds__(kChaseThreads)
chase_cluster_kernel(S* __restrict__ Wp, int64_t sd, int64_t sc,
                     int64_t npad, S* __restrict__ CS, int n, int b, int w,
                     int g, int T_pass, int J, int K0, int cpc) {
  using A = typename Acc<S>::type;
  // cpc x (w+2) entries, then the lanes' (c, s)
  extern __shared__ __align__(16) unsigned char chase_smem[];
  A* band = reinterpret_cast<A*>(chase_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int ldb = w + 2;
  const int C0 = rank * cpc;
  const int C1 = C0 + cpc < npad ? C0 + cpc : (int)npad;
  A* s_cs = band + cpc * ldb;
  const ClusterBand<A> B{band,
                         rank > 0 && kMode != kLocalOnly
                             ? cluster.map_shared_rank(band, rank - 1) : band,
                         C0, cpc, ldb};
  constexpr bool kBarrier = kMode != kNoBarrier;
  for (int idx = tid; idx < (C1 - C0) * ldb; idx += blockDim.x) {
    const int lc = idx / ldb, d = idx % ldb;
    band[idx] = to_acc(Wp[d * sd + (C0 + lc) * sc]);
  }
  // every CTA's columns are in place before any lane reads a neighbour's
  cluster.sync();
  const int D = g * b - 1;          // columns between consecutive lanes
  const int pitems = 2 * b + 2;     // row pairs and column pairs per lane
  // this thread's (lane, item) slots: the same every step of the pass
  int sl[kBatch], sit[kBatch];
#pragma unroll
  for (int m = 0; m < kBatch; ++m) {
    sl[m] = (tid + m * kChaseThreads) / pitems;
    sit[m] = (tid + m * kChaseThreads) % pitems;
  }
  for (int t = 0; t < T_pass; ++t) {
    if (kMode == kBarrierOnly) {
      cluster_arrive();
      cluster_wait();
      continue;
    }
    // this CTA's lanes: those whose plane column r + kPLeft it holds, with
    // r = (t+1) b - j D for the lane on column j (core/sbr.py _chase_pass);
    // a lane is live while r <= n-1 (k < K_j)
    const int Apl = (t + 1) * b + kPLeft;
    const int jhi = min(floor_div(Apl - C0, D), min(t / g, J - 1));
    const int jlo = max(floor_div(Apl - C1, D) + 1, 0);
    const int nl = max(0, jhi - jlo + 1);
    // ---- addresses of this thread's pairs (phase B), before the wait ----
    A* q0[kBatch];
    A* q1[kBatch];
    int lane_of[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      q0[m] = q1[m] = nullptr;
      lane_of[m] = -1;
      const int j = jhi - sl[m];
      const int r = (t + 1) * b - j * D;
      if (sl[m] >= nl || r > n - 1) continue;
      lane_of[m] = sl[m];
      const int it = sit[m];
      const int c0 = r - b - 2 + kPLeft;
      const bool row = it <= b;
      // rows r-1, r at window column it: packed (b+1-it), (b+2-it); or
      // columns r-1, r at window row it+2: packed (it+1-b, b+1), (it-b, b+2)
      const int d0 = row ? b + 1 - it : it + 1 - b;
      const int d1 = row ? b + 2 - it : it - b;
      // entries below the w+2 stored diagonals read as zero, unwritten
      if (d0 <= w + 1) q0[m] = B.at(d0, row ? c0 + it : c0 + b + 1);
      if (d1 <= w + 1) q1[m] = B.at(d1, row ? c0 + it : c0 + b + 2);
    }
    // the previous step's writes, in every CTA, are visible past here
    if (kBarrier && t > 0) cluster_wait();
    A x0[kBatch], x1[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      x0[m] = q0[m] ? *q0[m] : A(0);
      x1[m] = q1[m] ? *q1[m] : A(0);
    }
    // ---- phase A: per lane, the Givens rotation and the 2 x 2 block ------
    for (int li = tid; li < nl; li += kChaseThreads) {
      const int j = jhi - li;
      const int r = (t + 1) * b - j * D;
      if (r > n - 1) continue;
      const int k = t - g * j;
      const int sk = k > 0 ? 1 : 0;
      const int col = r - b - sk + kPLeft;
      const int cb = r - 1 + kPLeft;
      const A a = *B.at(b - 1 + sk, col);
      const A bb = *B.at(b + sk, col);
      A* p11 = B.at(0, cb);
      A* p21 = B.at(1, cb);
      A* p22 = B.at(0, cb + 1);
      const A a11 = *p11, a21 = *p21, a22 = *p22;
      A c, s;
      if (kMode == kNoGivens) {
        c = A(0.6) + A(0) * a;
        s = A(0.8) + A(0) * bb;
      } else {
        const A rr = sqrt(a * a + bb * bb);
        const bool safe = rr > A(0);
        const A den = safe ? rr : A(1);
        // (c, s) at the table's precision
        c = rnd<S>(safe ? a / den : A(1));
        s = rnd<S>(safe ? bb / den : A(0));
      }
      S* slot = CS + ((int64_t)j * (K0 + 1) + k) * 2;
      slot[0] = from_acc<S>(c);
      slot[1] = from_acc<S>(s);
      s_cs[2 * li] = c;
      s_cs[2 * li + 1] = s;
      // rows, then columns, as the reference's two rot_apply calls, the
      // rotated rows stored between them
      A r11, r21, r12, r22, n11, n12, n21, n22;
      rotate(c, s, a11, a21, &r11, &r21);
      rotate(c, s, a21, a22, &r12, &r22);
      r11 = rnd<S>(r11);
      r21 = rnd<S>(r21);
      r12 = rnd<S>(r12);
      r22 = rnd<S>(r22);
      rotate(c, s, r11, r12, &n11, &n12);
      rotate(c, s, r21, r22, &n21, &n22);
      *p11 = rnd<S>(n11);
      *p21 = rnd<S>(n21);
      *p22 = rnd<S>(n22);
    }
    if (kMode != kNoBlockSync) __syncthreads();
    // ---- phase B: rotate and store the pairs loaded above, then any past
    // kBatch a thread (loaded, rotated and stored one at a time) ---------
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (lane_of[m] < 0) continue;
      A y0, y1;
      rotate(s_cs[2 * lane_of[m]], s_cs[2 * lane_of[m] + 1], x0[m], x1[m],
             &y0, &y1);
      if (q0[m]) *q0[m] = rnd<S>(y0);
      if (q1[m]) *q1[m] = rnd<S>(y1);
    }
    for (int idx = tid + kBatch * kChaseThreads; idx < nl * pitems;
         idx += kChaseThreads) {
      const int li = idx / pitems, it = idx % pitems;
      const int r = (t + 1) * b - (jhi - li) * D;
      if (r > n - 1) continue;
      const int c0 = r - b - 2 + kPLeft;
      const bool row = it <= b;
      const int d0 = row ? b + 1 - it : it + 1 - b;
      const int d1 = row ? b + 2 - it : it - b;
      A* p0 = d0 <= w + 1 ? B.at(d0, row ? c0 + it : c0 + b + 1) : nullptr;
      A* p1 = d1 <= w + 1 ? B.at(d1, row ? c0 + it : c0 + b + 2) : nullptr;
      A y0, y1;
      rotate(s_cs[2 * li], s_cs[2 * li + 1], p0 ? *p0 : A(0),
             p1 ? *p1 : A(0), &y0, &y1);
      if (p0) *p0 = rnd<S>(y0);
      if (p1) *p1 = rnd<S>(y1);
    }
    // the next step's lanes read what lanes of other CTAs wrote in this
    // one: arrive now, wait once the next step's addresses are computed
    if (kBarrier) cluster_arrive();
    else __syncthreads();
  }
  if (kBarrier && T_pass > 0) cluster_wait();
  // no CTA touches another's columns past this point
  cluster.sync();
  // write the columns back (each value already S's); the annihilated
  // diagonals carry O(eps) residue: zero them
  for (int idx = tid; idx < (C1 - C0) * ldb; idx += blockDim.x) {
    const int lc = idx / ldb, d = idx % ldb;
    Wp[d * sd + (C0 + lc) * sc] = from_acc<S>(d < b ? band[idx] : A(0));
  }
}

template <typename S>
__global__ void __launch_bounds__(kReplayThreads)
replay_pass_kernel(S* __restrict__ X, int64_t ldx, int ncols,
                   const S* __restrict__ CS, int n, int b, int J, int K0,
                   int reverse) {
  using A = typename Acc<S>::type;
  const int col0 = blockIdx.x * kReplayCols;
  const int nc = min(kReplayCols, ncols - col0);
  for (int i = 0; i < J; ++i) {
    const int j = reverse ? J - 1 - i : i;
    const int Kj = (n - 1 - j - b) / b + 1;
    const int total = Kj * nc;
    const S* row = CS + (int64_t)j * (K0 + 1) * 2;
    // kBatch rotations in flight per thread: loads first, then stores (a
    // sweep's row pairs are disjoint)
    for (int base = threadIdx.x; base < total;
         base += kReplayThreads * kBatch) {
      S* p0[kBatch];
      A x0[kBatch], x1[kBatch], cc[kBatch], ss[kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        p0[m] = nullptr;
        x0[m] = x1[m] = cc[m] = ss[m] = A(0);
        const int idx = base + m * kReplayThreads;
        if (idx >= total) continue;
        const int k = idx / nc;
        const int64_t r = j + (int64_t)(k + 1) * b;
        cc[m] = to_acc(row[2 * k]);
        ss[m] = reverse ? to_acc(row[2 * k + 1]) * A(-1)
                        : to_acc(row[2 * k + 1]);
        p0[m] = X + (r - 1) * ldx + col0 + idx % nc;
        x0[m] = to_acc(p0[m][0]);
        x1[m] = to_acc(p0[m][ldx]);
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        if (!p0[m]) continue;
        A y0, y1;
        rotate(cc[m], ss[m], x0[m], x1[m], &y0, &y1);
        p0[m][0] = from_acc<S>(y0);
        p0[m][ldx] = from_acc<S>(y1);
      }
    }
    __syncthreads();
  }
}

// ---- the slab replay: shared-memory slab, staged table, chunked sweeps ----

constexpr int kSlabConsumers = 512;                 // threads on the lanes
constexpr int kSlabThreads = kSlabConsumers + 32;   // and one producer warp
// table slices in flight: two large slices measured faster than four or
// eight smaller ones (fewer hand-offs a chunk)
constexpr int kSlabSlots = 2;
// kMode of replay_slab_kernel: kFull, the pass; the timing variants (their
// results are garbage: timing only, on a scratch copy) kSlabNoTable, a
// fixed rotation and no table at all; kNoBarrier, no barrier between
// chunks; kSlabOneLane, only lane 0 rotates (the chain of b-1 dependent
// rotations a chunk, with the staging and barriers as in the pass)
constexpr int kSlabNoTable = 1, kSlabOneLane = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// this thread's arrival, announcing ``bytes`` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the phase of parity ``parity`` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n"
      "DONE:\n\t}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's shared memory, completion counted on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer threads (not the producer warp) meet here. bar.sync, like
// the cluster barrier, needs the warp converged, which the compiler does
// not know of an asm statement: __syncwarp() first
__device__ __forceinline__ void consumers_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, %0;" :: "n"(kSlabConsumers) : "memory");
}

// Where row r of a slab column lies in shared memory. fp64 (8-byte
// entries): rows in order, and for even b the row's low four bits XORed
// with the next four, so that the lanes of a half-warp (b rows apart) fall
// on distinct bank pairs. 4- and 2-byte entries: a warp's 32 lanes go
// through shared memory at once (b = 16 puts 16 lanes on each of two
// banks unswizzled, and two bf16 rows share a word), and an XOR of the
// row bits still leaves several lanes on one bank at some b. So the
// column is stored b rows to a stride instead: row r at (r mod b) S +
// r / b, S = ceil(n / b).
// Lane k's row at any step is c + k b for the warp's common c, so the 32
// lanes take 32 consecutive entries: no conflict at any b or entry size.
// A lane walks its rows one by one, so the position steps by S and wraps
// once a window (a cursor, no division in the loop).
struct XorRows {
  int swz;
  struct Cur {
    int r;
  };
  __device__ __forceinline__ Cur at(int r) const { return {r}; }
  __device__ __forceinline__ int pos(Cur c) const {
    return c.r ^ ((c.r >> 4) & swz);
  }
  __device__ __forceinline__ Cur next(Cur c) const { return {c.r + 1}; }
  __device__ __forceinline__ Cur prev(Cur c) const { return {c.r - 1}; }
};

struct StridedRows {
  int b, S;
  struct Cur {
    int q, m;   // r = q b + m
  };
  __device__ __forceinline__ Cur at(int r) const { return {r / b, r % b}; }
  __device__ __forceinline__ int pos(Cur c) const { return c.m * S + c.q; }
  __device__ __forceinline__ Cur next(Cur c) const {
    return c.m + 1 == b ? Cur{c.q + 1, 0} : Cur{c.q, c.m + 1};
  }
  __device__ __forceinline__ Cur prev(Cur c) const {
    return c.m == 0 ? Cur{c.q - 1, b - 1} : Cur{c.q, c.m - 1};
  }
};

template <typename S>
using SlabRows =
    typename std::conditional<sizeof(S) == 8, XorRows, StridedRows>::type;

template <typename S>
__device__ __forceinline__ SlabRows<S> slab_rows(int n, int b) {
  if constexpr (sizeof(S) == 8) {
    return XorRows{(b & 1) ? 0 : 15};
  } else {
    return StridedRows{b, (n + b - 1) / b};
  }
}

// Entries of a slab column in shared memory (a multiple of 16 bytes): n
// rounded up to 16 at fp64; b S at 4 and 2 bytes. kernel.py replay_smem
// keeps the same count.
template <typename S>
__host__ __device__ __forceinline__ int64_t slab_entries(int n, int b) {
  if (sizeof(S) == 8) return (n + 15) & ~15;
  const int64_t e = (int64_t)b * ((n + b - 1) / b);
  const int64_t per = 16 / sizeof(S);
  return (e + per - 1) / per * per;
}

// A (c, s) pair of the table in S, read from shared memory, in Acc<S>.
template <typename S>
struct Rot {
  typename Acc<S>::type c, s;
};

template <typename S>
__device__ __forceinline__ Rot<S> load_pair(const unsigned char* p) {
  if constexpr (std::is_same_v<S, double>) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    return {v.x, v.y};
  } else if constexpr (std::is_same_v<S, float>) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return {v.x, v.y};
  } else {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    return {__low2float(v), __high2float(v)};
  }
}

// The table staging of a pass, the same in the producer and the consumers:
// chunks of m = b-1 sweeps; a chunk's slices are lane ranges of L lanes
// (a multiple of the consumers, or all lanes) by sweep ranges of h sweeps.
// A slice row (one sweep's L pairs) takes P bytes of the slice: its pairs
// at 16 bytes a pair (fp64), or, at 8- and 4-byte pairs, its pairs plus 16
// bytes, for the copy starts at the 16-byte boundary at or below the row's
// first pair (a table row j starts j (K0+1) pairs in, which is no multiple
// of 16 bytes on most passes) and ends at the one at or above its last.
// Its Python twin: kernels/rot_apply/kernel.py slab_geom, slab_slices.
struct SlabGeom {
  int m, L, h, nchunks, P;
};

template <typename S>
__device__ __forceinline__ SlabGeom slab_geom(int n, int b, int J,
                                              int stage_bytes) {
  constexpr int pb = 2 * sizeof(S);             // bytes of a (c, s) pair
  constexpr int pad = pb == 16 ? 0 : 16;
  SlabGeom g;
  g.m = b - 1;
  const int kmax = (n - 1) / b;               // lanes of the first chunk
  const int L = (stage_bytes - pad) / pb / kSlabConsumers * kSlabConsumers;
  g.L = L < kmax ? L : kmax;
  g.P = ((g.L * pb + 15) & ~15) + pad;
  const int hmax = max(1, min(g.m, stage_bytes / g.P));
  const int parts = (g.m + hmax - 1) / hmax;
  g.h = (g.m + parts - 1) / parts;
  g.nchunks = (J + g.m - 1) / g.m;
  return g;
}

// The rotations of the sweeps [i0, i0 + cnt) (chunk-local) of one lane on
// the slab column: rows base .. base + cnt (base counts from the lane's
// window start plus i0), the rotation of sweep i0 + u at cs(u); forward in
// sweep order, or backward with (c, -s), one carried row at a time,
// computed in Acc<S>. Both rows of a rotation round to S (rnd<S>), the one
// stored and the one carried, as the sweep-by-sweep replay stores and
// reloads both; at fp64 rnd is the identity. (Rows held in a register
// array, 15 sweeps unrolled and predicated, spilled at 96 registers a
// thread and ran 10x slower on the card.)
template <typename S, typename Rows, typename CsOf>
__device__ __forceinline__ void slab_lane(S* col, const Rows& rows,
                                          int base, int cnt, bool reverse,
                                          CsOf cs) {
  using A = typename Acc<S>::type;
  // an explicit trip count, not unrolled: nvcc (CUDA 12.8, -O3) ran the
  // form `for (i = i0; i < ie; ++i)` of this loop past ie. (Loading the
  // next step's row and rotation a step ahead measured no faster.)
  if (!reverse) {
    auto cur = rows.at(base);
    A carry = to_acc(col[rows.pos(cur)]);
#pragma unroll 1
    for (int u = 0; u < cnt; ++u) {
      const auto nxt = rows.next(cur);
      const Rot<S> r = cs(u);
      const A x1 = to_acc(col[rows.pos(nxt)]);
      A y0, y1;
      rotate(r.c, r.s, carry, x1, &y0, &y1);
      col[rows.pos(cur)] = from_acc<S>(y0);
      carry = rnd<S>(y1);
      cur = nxt;
    }
    col[rows.pos(cur)] = from_acc<S>(carry);
  } else {
    auto cur = rows.at(base + cnt);
    A carry = to_acc(col[rows.pos(cur)]);
#pragma unroll 1
    for (int t = 0; t < cnt; ++t) {
      const int u = cnt - 1 - t;
      const auto prv = rows.prev(cur);
      const Rot<S> r = cs(u);
      const A x0 = to_acc(col[rows.pos(prv)]);
      A y0, y1;
      rotate(r.c, r.s * A(-1), x0, carry, &y0, &y1);
      col[rows.pos(cur)] = from_acc<S>(y1);
      carry = rnd<S>(y0);
      cur = prv;
    }
    col[rows.pos(cur)] = from_acc<S>(carry);
  }
}

// One pass of CS (J+1, K0+1, 2) onto column blockIdx.x of X (n rows used,
// row stride ldx). Dynamic shared memory: kSlabSlots table slices of
// stage_bytes, the slab column (slab_entries), the barriers. CS must start
// on a 16-byte boundary: every copy then starts at or after CS, and ends
// at most 16 - 2 pb bytes past the end of sweep J-1's row, inside the
// table's spare row J ((K0 + 1) pb >= 2 pb, K0 >= 1).
template <typename S, int kMode>
__global__ void __launch_bounds__(kSlabThreads, 1)
replay_slab_kernel(S* __restrict__ X, int64_t ldx, const S* __restrict__ CS,
                   int n, int b, int J, int K0, int reverse,
                   int stage_bytes) {
  constexpr int pb = 2 * sizeof(S);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  unsigned char* stages = smem_raw;
  S* slab = reinterpret_cast<S*>(smem_raw + (size_t)kSlabSlots * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(slab + slab_entries<S>(n, b));
  uint64_t* empty = full + kSlabSlots;   // the consumers are done
  S* Xc = X + blockIdx.x;
  const auto rows = slab_rows<S>(n, b);
  const bool rev = reverse != 0;
  const unsigned char* table = reinterpret_cast<const unsigned char*>(CS);

  for (int r = tid; r < n; r += kSlabThreads)
    slab[rows.pos(rows.at(r))] = Xc[(int64_t)r * ldx];
  if (tid == 0) {
    for (int s = 0; s < kSlabSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSlabConsumers / 32);
    }
    // the barriers' initialization is visible to the async proxy
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const SlabGeom g = slab_geom<S>(n, b, J, stage_bytes);
  if (tid >= kSlabConsumers) {
    // ---- the producer: one thread stages the table, slice by slice ------
    if (kMode != kSlabNoTable && tid == kSlabConsumers) {
      unsigned s = 0;
      for (int ci = 0; ci < g.nchunks; ++ci) {
        const int j0 = (rev ? g.nchunks - 1 - ci : ci) * g.m;
        const int mc = min(g.m, J - j0);
        const int Kc = (n - 1 - j0) / b;
        const int nsb = (mc + g.h - 1) / g.h;
        for (int k0 = 0; k0 < Kc; k0 += g.L) {
          const int Lc = min(g.L, Kc - k0);
          for (int si = 0; si < nsb; ++si, ++s) {
            const int i0 = (rev ? nsb - 1 - si : si) * g.h;
            const int hh = min(g.h, mc - i0);
            const int slot = s % kSlabSlots;
            const unsigned round = s / kSlabSlots;
            if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
            // row j's pairs k0 .. k0 + Lc - 1 start ``off`` bytes into the
            // table; the copy runs from the boundary at or below
            const int64_t off0 = ((int64_t)(j0 + i0) * (K0 + 1) + k0) * pb;
            const int64_t step = (int64_t)(K0 + 1) * pb;
            unsigned tx = 0;
            for (int i = 0; i < hh; ++i) {
              const int pre = (int)((off0 + i * step) & 15);
              tx += (unsigned)((pre + Lc * pb + 15) & ~15);
            }
            mbar_expect_tx(&full[slot], tx);
            unsigned char* dst = stages + (size_t)slot * stage_bytes;
            for (int i = 0; i < hh; ++i) {
              const int64_t off = off0 + i * step;
              const int pre = (int)(off & 15);
              bulk_load(dst + (size_t)i * g.P, table + (off - pre),
                        (unsigned)((pre + Lc * pb + 15) & ~15), &full[slot]);
            }
          }
        }
      }
    }
  } else {
    // ---- the consumers: lanes of a chunk, b-1 sweeps a barrier -----------
    const int lane = tid & 31;
    unsigned s = 0;
    for (int ci = 0; ci < g.nchunks; ++ci) {
      const int j0 = (rev ? g.nchunks - 1 - ci : ci) * g.m;
      const int mc = min(g.m, J - j0);
      const int Kc = (n - 1 - j0) / b;
      const int nsb = (mc + g.h - 1) / g.h;
      for (int k0 = 0; k0 < Kc; k0 += g.L) {
        const int Lc = min(g.L, Kc - k0);
        for (int si = 0; si < nsb; ++si, ++s) {
          const int i0 = (rev ? nsb - 1 - si : si) * g.h;
          const int hh = min(g.h, mc - i0);
          const int slot = s % kSlabSlots;
          if (kMode != kSlabNoTable) {
            mbar_wait(&full[slot], (s / kSlabSlots) & 1);
            __syncwarp();   // the threads left the wait's loop apart
          }
          const unsigned char* st = stages + (size_t)slot * stage_bytes;
          // the slice's first row's offset in the table: each row's pairs
          // sit (offset mod 16) bytes into its slice row (0 at fp64)
          const int64_t off0 = ((int64_t)(j0 + i0) * (K0 + 1) + k0) * pb;
          const int64_t step = (int64_t)(K0 + 1) * pb;
          for (int kk = tid; kk < Lc; kk += kSlabConsumers) {
            const int k = k0 + kk;
            if (kMode == kSlabOneLane && k != 0) break;
            // lane k's window starts at row j0 + (k+1) b - 1; its rotation
            // at local sweep i is live while j0 + i + (k+1) b <= n-1
            const int base = j0 + (k + 1) * b - 1;
            const int cnt = min(i0 + hh, min(mc, n - j0 - (k + 1) * b)) - i0;
            if (cnt <= 0) continue;
            slab_lane(slab, rows, base + i0, cnt, rev, [&](int u) {
              if (kMode == kSlabNoTable) {
                using A = typename Acc<S>::type;
                return Rot<S>{A(0.6), A(0.8)};
              }
              const int pre = (int)((off0 + u * step) & 15);
              return load_pair<S>(st + (size_t)u * g.P + pre + kk * pb);
            });
          }
          if (kMode != kSlabNoTable) {
            // this thread's reads of the slice (generic proxy) are ordered
            // before the next cp.async.bulk into it (async proxy)
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
          }
        }
      }
      // the next chunk's windows take rows this chunk's neighbours wrote
      if (kMode != kNoBarrier) consumers_sync();
    }
    consumers_sync();
    for (int r = tid; r < n; r += kSlabConsumers)
      Xc[(int64_t)r * ldx] = slab[rows.pos(rows.at(r))];
  }
}

template <typename S, int kMode>
cudaError_t cluster_config(int csize, int smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      chase_cluster_kernel<S, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chase_cluster_kernel<S, kMode>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(csize);
  cfg->blockDim = dim3(kChaseThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename S, int kMode>
int launch_slab(S* X, int64_t ldx, int ncols, const S* CS, int n, int b,
                int J, int K0, int reverse, int stage_bytes, int smem,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      replay_slab_kernel<S, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  replay_slab_kernel<S, kMode><<<ncols, kSlabThreads, smem, stream>>>(
      X, ldx, CS, n, b, J, K0, reverse, stage_bytes);
  return (int)cudaGetLastError();
}

template <typename S, int kMode>
int launch_cluster(S* Wp, int64_t sd, int64_t sc, int64_t npad, S* CS,
                   int n, int b, int w, int g, int T_pass, int J, int K0,
                   int cpc, int csize, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<S, kMode>(csize, smem, stream, &cfg,
                                             &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, chase_cluster_kernel<S, kMode>, Wp, sd, sc,
                           npad, CS, n, b, w, g, T_pass, J, K0, cpc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of csize CTAs of the S instance with smem bytes of
// dynamic shared memory each the card can hold at once (0: none; < 0: a
// CUDA error, negated).
template <typename S>
int cluster_capacity(int csize, int smem) {
  if (csize < 1 || csize > kMaxCluster) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<S, kFull>(csize, smem, 0, &cfg, &attr);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, chase_cluster_kernel<S, kFull>,
                                       &cfg);
  if (err != cudaSuccess) return -(int)err;
  return count;
}

template <typename S>
int chase_cluster(S* Wp, int64_t sd, int64_t sc, int64_t npad, S* CS, int n,
                  int b, int w, int g, int T_pass, int J, int K0, int csize,
                  int cpc, int smem, int mode, cudaStream_t stream) {
  if (csize < 1 || csize > kMaxCluster || (int64_t)csize * cpc < npad ||
      cpc < w + 3)
    return (int)cudaErrorInvalidValue;
#define CHASE_CLUSTER(M)                                                   \
  launch_cluster<S, M>(Wp, sd, sc, npad, CS, n, b, w, g, T_pass, J, K0,    \
                       cpc, csize, smem, stream)
  switch (mode) {
    case kBarrierOnly: return CHASE_CLUSTER(kBarrierOnly);
    case kNoBarrier: return CHASE_CLUSTER(kNoBarrier);
    case kLocalOnly: return CHASE_CLUSTER(kLocalOnly);
    case kNoGivens: return CHASE_CLUSTER(kNoGivens);
    case kNoBlockSync: return CHASE_CLUSTER(kNoBlockSync);
    default: return CHASE_CLUSTER(kFull);
  }
#undef CHASE_CLUSTER
}

// Bytes of dynamic shared memory of the slab replay of S: two table slices
// of stage_bytes, a slab column (slab_entries), two mbarriers a slice.
template <typename S>
int64_t slab_smem(int n, int b, int stage_bytes) {
  return (int64_t)kSlabSlots * stage_bytes +
         (int64_t)sizeof(S) * slab_entries<S>(n, b) + 8 * 2 * kSlabSlots;
}

template <typename S>
int replay_slab(S* X, int64_t ldx, int ncols, const S* CS, int n, int b,
                int J, int K0, int reverse, int stage_bytes, int mode,
                cudaStream_t stream) {
  if (ncols <= 0 || J <= 0) return 0;
  constexpr int pb = 2 * sizeof(S);
  const int64_t smem = slab_smem<S>(n, b, stage_bytes);
  if (stage_bytes % 16 != 0 ||
      stage_bytes < pb * kSlabConsumers + (pb == 16 ? 0 : 16) ||
      smem > 232448 || b < 2 || ((uintptr_t)CS & 15) != 0)
    return (int)cudaErrorInvalidValue;
#define REPLAY_SLAB(M)                                                     \
  launch_slab<S, M>(X, ldx, ncols, CS, n, b, J, K0, reverse, stage_bytes,  \
                    (int)smem, stream)
  switch (mode) {
    case kSlabNoTable: return REPLAY_SLAB(kSlabNoTable);
    case kNoBarrier: return REPLAY_SLAB(kNoBarrier);
    case kSlabOneLane: return REPLAY_SLAB(kSlabOneLane);
    default: return REPLAY_SLAB(kFull);
  }
#undef REPLAY_SLAB
}

template <typename S>
int rot_apply_launch(const S* X, const S* CS, S* Y, int G, int L, int tx,
                     int gx, int gy, cudaStream_t stream) {
  if (G <= 0 || L <= 0) return 0;
  if (tx < 1 || tx > 256 || 256 % tx != 0) return (int)cudaErrorInvalidValue;
  rot_apply_kernel<S><<<dim3(gx, gy), dim3(tx, 256 / tx), 0, stream>>>(
      X, CS, Y, (unsigned)G, (unsigned)L);
  return (int)cudaGetLastError();
}

template <typename S>
int chase_coop(S* Wp, int64_t sd, int64_t sc, int64_t npad, S* CS,
               unsigned int* bar, int n, int b, int w, int g, int T_pass,
               int G, int J, int K0, int mode, cudaStream_t stream) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // lanes per block: at most 32, and few enough that one pass of kBatch
  // pairs per thread covers them
  const int lpb_max = min(kMaxLanesPerBlock,
                          kChaseThreads * kBatch / (2 * b + 2));
  if (lpb_max < 1) return (int)cudaErrorInvalidValue;
  const int nb = (G + lpb_max - 1) / lpb_max;
  if (nb > sms) return (int)cudaErrorInvalidValue;
  int lpb = (G + nb - 1) / nb;
  void* args[] = {(void*)&Wp, (void*)&sd, (void*)&sc, (void*)&npad,
                  (void*)&CS, (void*)&bar, (void*)&n, (void*)&b, (void*)&w,
                  (void*)&g, (void*)&T_pass, (void*)&G, (void*)&J,
                  (void*)&K0, (void*)&lpb};
  const void* fn =
      mode == kBarrierOnly ? (const void*)chase_pass_kernel<S, kBarrierOnly>
      : mode == kNoBarrier ? (const void*)chase_pass_kernel<S, kNoBarrier>
                           : (const void*)chase_pass_kernel<S, kFull>;
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(nb),
                                                dim3(kChaseThreads), args, 0,
                                                stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename S>
int replay_sweeps(S* X, int64_t ldx, int ncols, const S* CS, int n, int b,
                  int J, int K0, int reverse, cudaStream_t stream) {
  if (ncols <= 0 || J <= 0) return 0;
  const int blocks = (ncols + kReplayCols - 1) / kReplayCols;
  replay_pass_kernel<S><<<blocks, kReplayThreads, 0, stream>>>(
      X, ldx, ncols, CS, n, b, J, K0, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (G, 2, L) = the rotations CS (G, 2) of the row pairs X (G, 2, L);
// all contiguous, G L < 2^31. Blocks of (tx, 256 / tx) threads, grid
// (gx, gy): the wrapper's launch_shape.
int rot_apply_fp64(const double* X, const double* CS, double* Y, int G,
                   int L, int tx, int gx, int gy, cudaStream_t stream) {
  return rot_apply_launch(X, CS, Y, G, L, tx, gx, gy, stream);
}

// The same in fp32, and in bf16 (rotated in fp32).
int rot_apply_fp32(const float* X, const float* CS, float* Y, int G, int L,
                   int tx, int gx, int gy, cudaStream_t stream) {
  return rot_apply_launch(X, CS, Y, G, L, tx, gx, gy, stream);
}

int rot_apply_bf16(const __nv_bfloat16* X, const __nv_bfloat16* CS,
                   __nv_bfloat16* Y, int G, int L, int tx, int gx, int gy,
                   cudaStream_t stream) {
  return rot_apply_launch(X, CS, Y, G, L, tx, gx, gy, stream);
}

// One bandwidth-b pass over the padded band Wp (w+2 diagonals, npad
// columns, strides sd and sc), in place; CS (J+1, K0+1, 2) contiguous,
// filled with the identity by the caller, receives the pass's rotations;
// bar is one zeroed counter. One cooperative launch, so that all blocks
// are resident while they wait at the grid barrier. ``mode`` is kFull, or
// a timing variant (kBarrierOnly, kNoBarrier).
int chase_pass_coop_fp64(double* Wp, int64_t sd, int64_t sc, int64_t npad,
                         double* CS, unsigned int* bar, int n, int b, int w,
                         int g, int T_pass, int G, int J, int K0, int mode,
                         cudaStream_t stream) {
  return chase_coop(Wp, sd, sc, npad, CS, bar, n, b, w, g, T_pass, G, J, K0,
                    mode, stream);
}

// The same pass on an fp32 band, and on a bf16 band (computed in fp32);
// CS in the band's type.
int chase_pass_coop_fp32(float* Wp, int64_t sd, int64_t sc, int64_t npad,
                         float* CS, unsigned int* bar, int n, int b, int w,
                         int g, int T_pass, int G, int J, int K0, int mode,
                         cudaStream_t stream) {
  return chase_coop(Wp, sd, sc, npad, CS, bar, n, b, w, g, T_pass, G, J, K0,
                    mode, stream);
}

int chase_pass_coop_bf16(__nv_bfloat16* Wp, int64_t sd, int64_t sc,
                         int64_t npad, __nv_bfloat16* CS, unsigned int* bar,
                         int n, int b, int w, int g, int T_pass, int G, int J,
                         int K0, int mode, cudaStream_t stream) {
  return chase_coop(Wp, sd, sc, npad, CS, bar, n, b, w, g, T_pass, G, J, K0,
                    mode, stream);
}

// How many clusters of csize CTAs of the fp64, fp32 or bf16 cluster chase
// with smem bytes of dynamic shared memory each the card can hold at once
// (0: none; < 0: a CUDA error, negated).
int chase_cluster_capacity_fp64(int csize, int smem) {
  return cluster_capacity<double>(csize, smem);
}

int chase_cluster_capacity_fp32(int csize, int smem) {
  return cluster_capacity<float>(csize, smem);
}

int chase_cluster_capacity_bf16(int csize, int smem) {
  return cluster_capacity<__nv_bfloat16>(csize, smem);
}

// The same pass with the whole band in the distributed shared memory of
// one cluster of csize CTAs, each holding cpc columns (the wrapper's plan:
// csize cpc >= npad) and smem bytes (cpc (w+2) entries of the compute type
// and the (c, s) of its lanes). ``mode`` as above, or a timing variant of
// the cluster kernel (kLocalOnly, kNoGivens, kNoBlockSync).
int chase_pass_cluster_fp64(double* Wp, int64_t sd, int64_t sc, int64_t npad,
                            double* CS, int n, int b, int w, int g,
                            int T_pass, int J, int K0, int csize, int cpc,
                            int smem, int mode, cudaStream_t stream) {
  return chase_cluster(Wp, sd, sc, npad, CS, n, b, w, g, T_pass, J, K0,
                       csize, cpc, smem, mode, stream);
}

// The same on an fp32 band, and on a bf16 band (computed in fp32, its
// entries held in fp32 on chip); CS in the band's type.
int chase_pass_cluster_fp32(float* Wp, int64_t sd, int64_t sc, int64_t npad,
                            float* CS, int n, int b, int w, int g, int T_pass,
                            int J, int K0, int csize, int cpc, int smem,
                            int mode, cudaStream_t stream) {
  return chase_cluster(Wp, sd, sc, npad, CS, n, b, w, g, T_pass, J, K0,
                       csize, cpc, smem, mode, stream);
}

int chase_pass_cluster_bf16(__nv_bfloat16* Wp, int64_t sd, int64_t sc,
                            int64_t npad, __nv_bfloat16* CS, int n, int b,
                            int w, int g, int T_pass, int J, int K0,
                            int csize, int cpc, int smem, int mode,
                            cudaStream_t stream) {
  return chase_cluster(Wp, sd, sc, npad, CS, n, b, w, g, T_pass, J, K0,
                       csize, cpc, smem, mode, stream);
}

// One pass of CS (J+1, K0+1, 2) applied in place to the rows of X
// (>= n rows, ncols columns, row stride ldx, unit column stride);
// reverse != 0 runs the sweeps backward with (c, -s).
int replay_pass_fp64(double* X, int64_t ldx, int ncols, const double* CS,
                     int n, int b, int J, int K0, int reverse,
                     cudaStream_t stream) {
  return replay_sweeps(X, ldx, ncols, CS, n, b, J, K0, reverse, stream);
}

// The same on fp32 rows, and on bf16 rows (rotated in fp32); CS in the
// rows' type.
int replay_pass_fp32(float* X, int64_t ldx, int ncols, const float* CS,
                     int n, int b, int J, int K0, int reverse,
                     cudaStream_t stream) {
  return replay_sweeps(X, ldx, ncols, CS, n, b, J, K0, reverse, stream);
}

int replay_pass_bf16(__nv_bfloat16* X, int64_t ldx, int ncols,
                     const __nv_bfloat16* CS, int n, int b, int J, int K0,
                     int reverse, cudaStream_t stream) {
  return replay_sweeps(X, ldx, ncols, CS, n, b, J, K0, reverse, stream);
}

// Bytes of dynamic shared memory of the slab replay with entries of
// esize bytes (8, 4 or 2) at pass b: two table slices of stage_bytes, a
// slab column, two mbarriers a slice (kernel.py replay_smem); -1 for
// another esize.
int64_t replay_slab_smem(int n, int b, int esize, int stage_bytes) {
  switch (esize) {
    case 8: return slab_smem<double>(n, b, stage_bytes);
    case 4: return slab_smem<float>(n, b, stage_bytes);
    case 2: return slab_smem<__nv_bfloat16>(n, b, stage_bytes);
    default: return -1;
  }
}

// The same pass with the slab's columns in shared memory: one CTA a
// column, two table slices of stage_bytes (a multiple of 16, at least 512
// pairs, plus 16 bytes below fp64) in flight; CS must be 16-byte aligned.
// ``mode`` is kFull or a timing variant (kSlabNoTable, kNoBarrier,
// kSlabOneLane).
int replay_slab_fp64(double* X, int64_t ldx, int ncols, const double* CS,
                     int n, int b, int J, int K0, int reverse,
                     int stage_bytes, int mode, cudaStream_t stream) {
  return replay_slab(X, ldx, ncols, CS, n, b, J, K0, reverse, stage_bytes,
                     mode, stream);
}

// The same on fp32 rows, and on bf16 rows (rotated in fp32); CS in the
// rows' type, its rows at any offset (the copies start on the 16-byte
// boundary at or below each).
int replay_slab_fp32(float* X, int64_t ldx, int ncols, const float* CS,
                     int n, int b, int J, int K0, int reverse,
                     int stage_bytes, int mode, cudaStream_t stream) {
  return replay_slab(X, ldx, ncols, CS, n, b, J, K0, reverse, stage_bytes,
                     mode, stream);
}

int replay_slab_bf16(__nv_bfloat16* X, int64_t ldx, int ncols,
                     const __nv_bfloat16* CS, int n, int b, int J, int K0,
                     int reverse, int stage_bytes, int mode,
                     cudaStream_t stream) {
  return replay_slab(X, ldx, ncols, CS, n, b, J, K0, reverse, stage_bytes,
                     mode, stream);
}

}  // extern "C"
