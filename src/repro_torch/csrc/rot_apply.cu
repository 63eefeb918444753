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
//     stagger); their work (~4.7e10 flops) and bytes (the 1.4 MB band
//     sits in L2) would take ~1.4 ms. Each step costs a block barrier, a
//     grid barrier and two L2 round trips.
//   replay_pass: at TT4 (an (n, 100) slab) the rotations' flops,
//     1.19e8 rotations x 100 columns x 6, about 2 ms at the fp64 rate,
//     against ~1.1 ms to read the 3.8 GB table once; and the J sweeps of
//     a pass are dependent, one barrier each.
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
// rotations in the same order on every entry. The lanes are split over
// blocks of at most 32 (one cooperative launch, ceil(G/32) blocks, up to
// 53 at MD), which loop over the pass's time steps. Per step every
// thread first loads its lanes' row and column pairs (2b+2 per lane, up
// to four per thread), and one thread per active lane loads the pivot,
// the target and the 2 x 2 block, all in flight at once; that thread
// computes the Givens rotation, records (c, s) in the table and in
// shared memory, and rotates the block. A block barrier; then every
// thread rotates and stores its pairs (they are disjoint, and none is
// the block). A grid barrier: a lane's next footprint can overlap its
// neighbours' last ones. The band is column-major (a column's diagonals
// contiguous), so a lane's column pairs are contiguous runs. A single
// block was first: one SM's L2 traffic, ~30k scattered sectors a step,
// made a step ~12 us. Entries the reference reads as zero (below the w+2
// stored diagonals) are read as zero and not written. After the last
// step the blocks zero the annihilated diagonals Wp[b:, :].
//
// Design of replay_pass. A sweep's K0 rotations act on row pairs b >= 2
// apart, so they are disjoint, and rows never mix columns: blocks of 1024
// threads take 4-column chunks and loop over the J sweeps with a barrier
// between sweeps, the sweep's (rotation, column) items spread over the
// threads, four per thread in flight at once. Slots past a sweep's end
// hold the identity and are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPLeft = 2;            // left margin of the padded band
constexpr int kChaseThreads = 512;
constexpr int kMaxLanesPerBlock = 32;   // wavefront lanes of one chase block
constexpr int kBatch = 4;            // pair rotations in flight per thread
constexpr int kReplayThreads = 1024;
constexpr int kReplayCols = 4;       // one 32-byte sector of a row

__device__ __forceinline__ void rotate(double c, double s, double x0,
                                       double x1, double* y0, double* y1) {
  *y0 = c * x0 + s * x1;
  *y1 = -s * x0 + c * x1;
}

__global__ void __launch_bounds__(256)
rot_apply_kernel(const double* __restrict__ X, const double* __restrict__ CS,
                 double* __restrict__ Y, unsigned G, unsigned L) {
  __shared__ double cs[2 * 256];
  const unsigned tx = blockDim.x;                 // threads of a pair
  const unsigned ty = blockDim.y;                 // pairs of the block
  const unsigned tid = threadIdx.y * tx + threadIdx.x;
  const unsigned g0 = blockIdx.x * ty;
  // the block's 2 ty (c, s) entries; at L = 1 a block holds 256 pairs,
  // so each thread stages two
  for (unsigned i = tid; i < 2 * ty && g0 + i / 2 < G; i += tx * ty)
    cs[i] = CS[2 * g0 + i];
  __syncthreads();
  const unsigned g = g0 + threadIdx.y;
  if (g >= G) return;
  const double c = cs[2 * threadIdx.y];
  const double s = cs[2 * threadIdx.y + 1];
  const unsigned base = 2 * g * L;
  for (unsigned l = blockIdx.y * tx + threadIdx.x; l < L;
       l += gridDim.y * tx) {
    rotate(c, s, X[base + l], X[base + L + l], &Y[base + l],
           &Y[base + L + l]);
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
// diagonals are contiguous) and with __ldcg: other blocks write it, so
// reads go to L2, past this SM's L1.
__global__ void __launch_bounds__(kChaseThreads)
chase_pass_kernel(double* __restrict__ Wp, int64_t sd, int64_t sc,
                  int64_t npad, double* __restrict__ CS, unsigned int* bar,
                  int n, int b, int w, int g, int T_pass, int G, int J,
                  int K0, int lpb) {
  __shared__ double s_cs[2 * kMaxLanesPerBlock];
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int nb = gridDim.x;
  const int l0 = blk * lpb;
  const int nl = max(0, min(G, l0 + lpb) - l0);
  const int pitems = 2 * b + 2;      // row pairs and column pairs per lane
  const int total = nl * pitems;     // <= kChaseThreads * kBatch (host)
  unsigned int target = 0;
  for (int t = 0; t < T_pass; ++t) {
    // ---- loads: this thread's pairs (phase B) and, for one lane, the
    // pivot, target and 2 x 2 block (phase A), all in flight at once -----
    double* q0[kBatch];
    double* q1[kBatch];
    double x0[kBatch], x1[kBatch];
    int lane_of[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      q0[m] = q1[m] = nullptr;
      x0[m] = x1[m] = 0.0;
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
        x0[m] = __ldcg(q0[m]);
      }
      if (d1 <= w + 1) {
        q1[m] = Wp + d1 * sd + col1 * sc;
        x1[m] = __ldcg(q1[m]);
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
        const double a = __ldcg(Wp + (b - 1 + sk) * sd + col);
        const double bb = __ldcg(Wp + (b + sk) * sd + col);
        double* p11 = Wp + cb;
        double* p21 = Wp + sd + cb;
        double* p22 = Wp + cb + sc;
        const double a11 = __ldcg(p11), a21 = __ldcg(p21), a22 = __ldcg(p22);
        const double rr = sqrt(a * a + bb * bb);
        const bool safe = rr > 0.0;
        const double den = safe ? rr : 1.0;
        const double c = safe ? a / den : 1.0;
        const double s = safe ? bb / den : 0.0;
        double* slot = CS + ((int64_t)j * (K0 + 1) + k) * 2;
        slot[0] = c;
        slot[1] = s;
        s_cs[2 * li] = c;
        s_cs[2 * li + 1] = s;
        // rows, then columns, as the reference's two rot_apply calls
        double r11, r21, r12, r22, n11, n12, n21, n22;
        rotate(c, s, a11, a21, &r11, &r21);
        rotate(c, s, a21, a22, &r12, &r22);
        rotate(c, s, r11, r12, &n11, &n12);
        rotate(c, s, r21, r22, &n21, &n22);
        *p11 = n11;
        *p21 = n21;
        *p22 = n22;
      }
    }
    __syncthreads();
    // ---- phase B: rotate and store the pairs loaded above ---------------
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (lane_of[m] < 0) continue;
      double y0, y1;
      rotate(s_cs[2 * lane_of[m]], s_cs[2 * lane_of[m] + 1], x0[m], x1[m],
             &y0, &y1);
      if (q0[m]) *q0[m] = y0;
      if (q1[m]) *q1[m] = y1;
    }
    // the next step's lanes read what neighbouring lanes, in other
    // blocks, wrote in this one
    grid_sync(bar, target);
  }
  // the annihilated diagonals carry O(eps) residue: zero them
  for (int64_t idx = (int64_t)blk * kChaseThreads + tid;
       idx < (int64_t)(w + 2 - b) * npad;
       idx += (int64_t)nb * kChaseThreads) {
    Wp[(b + idx / npad) * sd + (idx % npad) * sc] = 0.0;
  }
}

__global__ void __launch_bounds__(kReplayThreads)
replay_pass_kernel(double* __restrict__ X, int64_t ldx, int ncols,
                   const double* __restrict__ CS, int n, int b, int J, int K0,
                   int reverse) {
  const int col0 = blockIdx.x * kReplayCols;
  const int nc = min(kReplayCols, ncols - col0);
  for (int i = 0; i < J; ++i) {
    const int j = reverse ? J - 1 - i : i;
    const int Kj = (n - 1 - j - b) / b + 1;
    const int total = Kj * nc;
    const double* row = CS + (int64_t)j * (K0 + 1) * 2;
    // kBatch rotations in flight per thread: loads first, then stores (a
    // sweep's row pairs are disjoint)
    for (int base = threadIdx.x; base < total;
         base += kReplayThreads * kBatch) {
      double* p0[kBatch];
      double x0[kBatch], x1[kBatch], cc[kBatch], ss[kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        p0[m] = nullptr;
        x0[m] = x1[m] = cc[m] = ss[m] = 0.0;
        const int idx = base + m * kReplayThreads;
        if (idx >= total) continue;
        const int k = idx / nc;
        const int64_t r = j + (int64_t)(k + 1) * b;
        cc[m] = row[2 * k];
        ss[m] = reverse ? row[2 * k + 1] * -1.0 : row[2 * k + 1];
        p0[m] = X + (r - 1) * ldx + col0 + idx % nc;
        x0[m] = p0[m][0];
        x1[m] = p0[m][ldx];
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        if (!p0[m]) continue;
        double y0, y1;
        rotate(cc[m], ss[m], x0[m], x1[m], &y0, &y1);
        p0[m][0] = y0;
        p0[m][ldx] = y1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Y (G, 2, L) = the rotations CS (G, 2) of the row pairs X (G, 2, L);
// all contiguous, G L < 2^31. Blocks of (tx, 256 / tx) threads, grid
// (gx, gy): the wrapper's launch_shape.
int rot_apply_fp64(const double* X, const double* CS, double* Y, int G,
                   int L, int tx, int gx, int gy, cudaStream_t stream) {
  if (G <= 0 || L <= 0) return 0;
  if (tx < 1 || tx > 256 || 256 % tx != 0) return (int)cudaErrorInvalidValue;
  rot_apply_kernel<<<dim3(gx, gy), dim3(tx, 256 / tx), 0, stream>>>(
      X, CS, Y, (unsigned)G, (unsigned)L);
  return (int)cudaGetLastError();
}

// One bandwidth-b pass over the padded band Wp (w+2 diagonals, npad
// columns, strides sd and sc), in place; CS (J+1, K0+1, 2) contiguous,
// filled with the identity by the caller, receives the pass's rotations;
// bar is one zeroed counter. One cooperative launch, so that all blocks
// are resident while they wait at the grid barrier.
int chase_pass_fp64(double* Wp, int64_t sd, int64_t sc, int64_t npad,
                    double* CS, unsigned int* bar, int n, int b, int w,
                    int g, int T_pass, int G, int J, int K0,
                    cudaStream_t stream) {
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
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)chase_pass_kernel, dim3(nb), dim3(kChaseThreads), args, 0,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One pass of CS (J+1, K0+1, 2) applied in place to the rows of X
// (>= n rows, ncols columns, row stride ldx, unit column stride);
// reverse != 0 runs the sweeps backward with (c, -s).
int replay_pass_fp64(double* X, int64_t ldx, int ncols, const double* CS,
                     int n, int b, int J, int K0, int reverse,
                     cudaStream_t stream) {
  if (ncols <= 0 || J <= 0) return 0;
  const int blocks = (ncols + kReplayCols - 1) / kReplayCols;
  replay_pass_kernel<<<blocks, kReplayThreads, 0, stream>>>(
      X, ldx, ncols, CS, n, b, J, K0, reverse);
  return (int)cudaGetLastError();
}

}  // extern "C"
