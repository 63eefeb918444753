// The compact-WY panel factorization of the TT1 band reduction for Hopper
// (sm_90a): (V, T) of the sub-panel E[row_start:, :] of a full-height
// (rows, b) panel, b <= 128, Q = I - V T V^T.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/house_panel/kernel.py). The entry point launches on
// the caller's stream, allocates nothing and returns the launch's error.
//
// Replaces _house_panel_kernel behind house_panel_pallas
// (repro/kernels/house_panel/kernel.py), with its per-reflector formulas:
// the masked tail xm, alpha, sigma = max(sum xm^2 - alpha^2, 0), the
// `safe` guard, tau, the panel update R -= tau v (v^T R) and the T
// recurrence T[:j, j] = -tau T[:j, :j] (V^T v).
//
// What bounds it: latency. At the TT1 panel of the MD pencil (9997 x 16,
// fp64) the bytes are E in and V out, 2.6 MB, about 0.77 us at 3.35 TB/s,
// and the work is ~1e7 flops. But the b reflectors are dependent, and
// each needs reductions over the whole panel (the tail norm and the b
// projections v^T R): 2 b grid round trips in the cooperative kernel, b
// cluster round trips in the cluster kernel.
//
// Design. The TPU kernel keeps the whole panel in VMEM; a 1.3 MB panel
// does not fit one block's 227 KB of shared memory, so the panel is split
// by rows, each block holding its rows in shared memory for the whole
// factorization. Two kernels:
//   house_cluster_kernel — the active rows E[row_start:] in the
//     distributed shared memory of one thread-block cluster of up to 16
//     CTAs (non-portable size; 16 x 80 KB at 9997 x 16 in fp64, half that
//     in fp32 and bf16), one cluster
//     barrier (barrier.cluster.arrive/wait) a reflector, partials read
//     from the peers through map_shared_rank (its note below).
//   house_panel_kernel — up to one block per SM, one cooperative launch,
//     for panels larger than a cluster holds: the blocks meet at a grid
//     barrier (a counter in global memory) twice per reflector. Per
//     reflector: every block publishes the partial tail norm of its rows
//     (and the pivot's owner publishes alpha); barrier; every block sums
//     the partials in block order, so all blocks compute the same tau;
//     each block writes v into column j of its rows — column j holds
//     R[:, j] until then, columns < j hold V and columns > j hold R — and
//     publishes its partial v^T buf over all columns, which gives both the
//     panel projections (columns > j) and z = V^T v for the T recurrence
//     (columns < j); barrier; every block sums those in block order,
//     updates its rows, and block 0 extends T. Partials go to
//     per-reflector slots, so no slot is reused within a launch.
// Every sum runs in a fixed order, so a result repeats bitwise.
//
// Instances (reduced.cuh). Both kernels have an fp64, an fp32 and a bf16
// instance; each computes in Acc<S>: fp64 in fp64, fp32 and bf16 in fp32.
// The TPU kernel's bf16 path computes in fp32 (its reflector norms and taus
// cancel too hard for bf16), so a bf16 panel is read from bf16, factored in
// fp32, and V and T are rounded to bf16 once, at the store. The cluster
// kernel sizes its shared memory in entries of the compute type
// (cluster_extra_entries): 8 bytes for fp64, 4 for fp32 and for bf16,
// which shares fp32's layout, as the reduced chase does (rot_apply.cu); at
// 4 bytes the rows take half of fp64's room, so a cluster holds panels
// twice as tall. Its T recurrence runs on rank 0's Ts in the compute type,
// which is the working T. The cooperative kernel keeps its reduced
// instances for panels no cluster holds (b = 128 at n = 9997 is ~397 KB a
// CTA at 4 bytes); its bf16 instance runs the T recurrence on an fp32 copy
// of T that block 0 rounds out at the end.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduced.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // projection columns per pass over the rows
constexpr int kMaxB = 128;
constexpr int kMaxSmem = 200 * 1024;
constexpr int kMaxClusterSmem = 232448;   // a CTA's dynamic shared memory

// sum over the block, in a fixed order; every thread gets the total
template <typename A>
__device__ A block_sum(A v, A* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    A t = lane < kWarps ? red[lane] : A(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const A total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

// sum of vals[0], vals[stride], ... over the nb blocks' partials, by one
// warp, in a fixed order (the same in every block); lane 0 gets the sum
template <typename A>
__device__ A warp_sum_partials(const A* vals, int64_t stride, int nb) {
  const int lane = threadIdx.x & 31;
  A t = A(0);
  for (int k = lane; k < nb; k += 32) t += __ldcg(vals + k * stride);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  return t;
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

// kMode of both kernels: kFull, the factorization; the timing variants
// (their results are garbage: timing only) kBarrierOnly, only the
// barriers; kNoBarrier, everything but the barriers (the cooperative
// kernel only: its sums read L2, where a cluster's would read a CTA that
// may have left); kNoSums, every cross-block (cross-CTA) sum replaced by
// this block's own partial
constexpr int kFull = 0, kBarrierOnly = 1, kNoBarrier = 2, kNoSums = 3;

// V and T are the outputs in the storage type S; Tw is the working T in
// the compute type A (T itself where the two are one type)
template <typename S, int kMode>
__global__ void __launch_bounds__(kThreads)
house_panel_kernel(const S* __restrict__ E, int64_t lde,
                   S* __restrict__ V, S* __restrict__ T,
                   typename Acc<S>::type* __restrict__ Tw,
                   typename Acc<S>::type* __restrict__ part,
                   unsigned int* bar, int rows, int b, int rs, int rpb) {
  using A = typename Acc<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* P = reinterpret_cast<A*>(smem_raw);   // this block's rows, (rpb, b)
  __shared__ A red[kWarps + 1];
  __shared__ A wred[kWarps][kChunk];
  __shared__ A proj[kMaxB];
  __shared__ A scal[2];                  // total tail norm^2, alpha
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  const int r0 = blk * rpb;
  const int nr = max(0, min(rows, r0 + rpb) - r0);
  A* part_sq = part;                               // [b][nb]
  A* part_pr = part + (int64_t)b * nb;             // [b][nb][b]
  A* alphas = part_pr + (int64_t)b * nb * b;       // [b]
  unsigned int target = 0;
  if (kMode == kBarrierOnly) {
    for (int j = 0; j < 2 * b; ++j) grid_sync(bar, target);
    return;
  }
  // the sums over blocks: in block order, or this block's own partial
  auto sum_partials = [&](const A* vals, int64_t stride) {
    return kMode == kNoSums
               ? (lane == 0 ? __ldcg(vals + blk * stride) : A(0))
               : warp_sum_partials(vals, stride, nb);
  };

  for (int idx = tid; idx < nr * b; idx += kThreads) {
    const int64_t i = r0 + idx / b;
    P[idx] = i >= rs ? to_acc(E[i * lde + idx % b]) : A(0);
  }
  if (blk == 0)
    for (int idx = tid; idx < b * b; idx += kThreads) Tw[idx] = A(0);
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const int pivot = rs + j;
    // ---- the partial tail norm, and alpha from the pivot's owner -------
    if (tid == 0 && pivot >= r0 && pivot < r0 + nr)
      alphas[j] = P[(pivot - r0) * b + j];
    A sq = A(0);
    for (int i = tid; i < nr; i += kThreads) {
      if (r0 + i >= pivot) {
        const A x = P[i * b + j];
        sq += x * x;
      }
    }
    sq = block_sum(sq, red);
    if (tid == 0) part_sq[(int64_t)j * nb + blk] = sq;
    if (kMode != kNoBarrier) grid_sync(bar, target);
    if (warp == 0) {
      const A total = sum_partials(part_sq + (int64_t)j * nb, 1);
      if (lane == 0) {
        scal[0] = total;
        scal[1] = pivot < rows ? __ldcg(alphas + j) : A(0);
      }
    }
    __syncthreads();
    const A alpha = scal[1];
    A sigma = scal[0] - alpha * alpha;
    sigma = sigma < A(0) ? A(0) : sigma;   // max(., 0), NaN passes through
    const bool safe = sigma > A(0);
    const A norm_x = sqrt(alpha * alpha + sigma);
    const A sgn = alpha >= A(0) ? A(1) : A(-1);
    const A beta = safe ? -sgn * norm_x : alpha;
    const A denom = safe ? alpha - beta : A(1);
    const A tau = safe ? (beta - alpha) / beta : A(0);

    // ---- v into column j, then the partial v^T buf over every column ---
    for (int i = tid; i < nr; i += kThreads) {
      const int gi = r0 + i;
      if (gi < rs) continue;
      A v;
      if (!safe) v = gi == pivot ? A(1) : A(0);
      else if (gi > pivot) v = P[i * b + j] / denom;
      else v = gi == pivot ? A(1) : A(0);
      P[i * b + j] = v;
    }
    A* slot = part_pr + ((int64_t)j * nb + blk) * b;
    for (int c0 = 0; c0 < b; c0 += kChunk) {
      const int nc = min(kChunk, b - c0);
      A acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = A(0);
      for (int i = tid; i < nr; i += kThreads) {
        if (r0 + i < pivot) continue;   // v is zero above the pivot
        const A v = P[i * b + j];
        const A* row = P + i * b + c0;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c < nc) acc[c] += v * row[c];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        A t = acc[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
        if (lane == 0) wred[warp][c] = t;
      }
      __syncthreads();
      if (tid < nc) {
        A t = A(0);
        for (int w = 0; w < kWarps; ++w) t += wred[w][tid];
        slot[c0 + tid] = t;
      }
      __syncthreads();
    }
    if (kMode != kNoBarrier) grid_sync(bar, target);
    for (int c = warp; c < b; c += kWarps) {
      const A t = sum_partials(part_pr + (int64_t)j * nb * b + c, b);
      if (lane == 0) proj[c] = t;
    }
    __syncthreads();

    // ---- T column j from z = proj[:j]; the update R -= tau v p^T -------
    if (blk == 0) {
      if (tid < j) {
        A t = A(0);
        for (int k = 0; k < j; ++k) t += Tw[tid * b + k] * proj[k];
        Tw[tid * b + j] = -tau * t;
      }
      if (tid == 0) Tw[j * b + j] = tau;
    }
    for (int i = tid; i < nr; i += kThreads) {
      if (r0 + i <= pivot) continue;   // v = 0 above; the pivot row is done
      const A v = P[i * b + j];
      for (int c = j + 1; c < b; ++c) P[i * b + c] -= tau * (v * proj[c]);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nr * b; idx += kThreads)
    V[(int64_t)r0 * b + idx] = from_acc<S>(P[idx]);
  if constexpr (!std::is_same_v<S, A>) {
    if (blk == 0)   // block 0 wrote Tw, and its threads are past the loop
      for (int idx = tid; idx < b * b; idx += kThreads)
        T[idx] = from_acc<S>(Tw[idx]);
  }
}

// ---- the panel in one cluster's distributed shared memory -----------------

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;        // CTAs of a cluster (non-portable)

// The cluster barrier in two halves: arrive (release) and wait (acquire).
// Both need the warp converged, which the compiler does not know of an asm
// statement: __syncwarp() first.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// sum of v over the first 16 lanes of a warp (lanes past them give 0), by
// a fixed butterfly: every lane gets the same bits
template <typename A>
__device__ __forceinline__ A tree16(A v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Entries of the compute type A in the cluster kernel's shared memory
// besides the rows: T, two slots of published partials and of the pivot
// row, the block reduction, and the cluster's sums, pivot row and
// projections.
__host__ __device__ __forceinline__ int cluster_extra_entries(int b) {
  int cw = 1;
  while (cw < b) cw <<= 1;
  return b * b + 4 * b + kClusterWarps * cw + 3 * b;
}

// (V, T) of E[rs:, :] with the active rows rs..rows-1 split over the
// cluster's CTAs, rpc a CTA, each holding its rows in shared memory for the
// whole factorization. Reflector j pivots at active row j. Per reflector:
// every CTA publishes, in its own shared memory, D[c] = sum of x_i P[i][c]
// over its rows below the pivot (x = column j) and, if it holds the pivot,
// the pivot row; one cluster barrier; every CTA reads all of them through
// map_shared_rank, sums in rank order by a fixed butterfly (so every CTA
// holds the same bits), and takes the Householder scalars of the present
// formulas (alpha, sigma = max(sum x^2 - alpha^2, 0), safe, tau). Since
// v = x / denom below the pivot and 1 at it, v^T P[:, c] = D[c] / denom +
// P[pivot][c], which gives the update's projections (c > j) and z = V^T v
// of the T recurrence (c < j) from the same sums: one barrier a reflector,
// not two. Then v into column j, the update R -= tau v (v^T R), and the next
// reflector's partials, all on local rows. Rank 0 keeps each z and tau and
// runs the T recurrence once at the end, a thread a row of T. Two slots alternate: a CTA
// overwrites slot j&1 only after the barrier of reflector j+1, which every
// CTA passes after reading slot j&1.
//
// Every value on chip and every sum is in the compute type A: E is read
// through to_acc, and V and T are rounded to the storage type S once, at
// the store. So a bf16 panel is factored in fp32 in fp32's layout, and
// rank 0's Ts is its working T.
template <typename S, int kMode>
__global__ void __launch_bounds__(kClusterThreads, 1)
house_cluster_kernel(const S* __restrict__ E, int64_t lde,
                     S* __restrict__ V, S* __restrict__ T, int rows, int b,
                     int rs, int rpc) {
  using A = typename Acc<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int active = max(rows - rs, 0);
  const int a0 = rank * rpc;                    // this CTA's first active row
  const int nr = max(0, min(active, a0 + rpc) - a0);
  int cw = 1;
  while (cw < b) cw <<= 1;
  const int G = kClusterThreads / cw;           // row groups
  const int gc = tid & (cw - 1);                // this thread's column
  const int gg = tid / cw;                      // and row group
  A* P = reinterpret_cast<A*>(smem_raw);        // (nr, b), this CTA's rows
  A* Ts = P + (size_t)rpc * b;                  // (b, b)
  A* part = Ts + b * b;                         // [2][b] published partials
  A* pivr = part + 2 * b;                       // [2][b] published pivot row
  A* red = pivr + 2 * b;                        // block reduction
  A* sums = red + kClusterWarps * cw;           // [b] D over the cluster
  A* prow = sums + b;                           // [b] the pivot row
  A* proj = prow + b;                           // [b] v^T P

  if (kMode == kBarrierOnly) {
    for (int j = 0; j <= b; ++j) {
      cluster_arrive();
      cluster_wait();
    }
    return;
  }
  for (int idx = tid; idx < nr * b; idx += kClusterThreads)
    P[idx] = to_acc(E[(int64_t)(rs + a0 + idx / b) * lde + idx % b]);
  for (int idx = tid; idx < b * b; idx += kClusterThreads) Ts[idx] = A(0);
  __syncthreads();

  // D[c] over this CTA's rows below pivot j, into slot j&1, in a fixed
  // order; and the pivot row, by its owner
  auto publish = [&](int j) {
    A acc = A(0);
    if (gc < b)
      for (int i = max(0, j + 1 - a0) + gg; i < nr; i += G)
        acc += P[i * b + j] * P[i * b + gc];
    int groups = G;                             // rows of red
    if (cw < 32) {                              // the warp's groups first
      for (int o = 16; o >= cw; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane < cw) red[warp * cw + gc] = acc;
      groups = kClusterWarps;
    } else {
      red[gg * cw + gc] = acc;
    }
    const int pl = j - a0;
    if (pl >= 0 && pl < nr && tid < b) pivr[(j & 1) * b + tid] = P[pl * b + tid];
    __syncthreads();
    for (int c = warp; c < b; c += kClusterWarps) {
      const A t = tree16(lane < groups ? red[lane * cw + c] : A(0));
      if (lane == 0) part[(j & 1) * b + c] = t;
    }
  };

  publish(0);
  cluster_arrive();
  for (int j = 0; j < b; ++j) {
    const int slot = (j & 1) * b;
    // every CTA's partials of reflector j are published past here
    cluster_wait();
    for (int c = warp; c < b; c += kClusterWarps) {
      A v = A(0);
      if (lane < csize && (kMode != kNoSums || lane == rank))
        v = cluster.map_shared_rank(part, lane)[slot + c];
      v = tree16(v);
      if (lane == 0) sums[c] = v;
    }
    const int owner = j < active ? j / rpc : -1;
    if (tid < b)
      prow[tid] = owner < 0 ? A(0)
                  : cluster.map_shared_rank(pivr, kMode == kNoSums ? rank
                                                                   : owner)
                        [slot + tid];
    __syncthreads();
    const A alpha = prow[j];
    A sigma = (alpha * alpha + sums[j]) - alpha * alpha;
    sigma = sigma < A(0) ? A(0) : sigma;   // max(., 0), NaN passes through
    const bool safe = sigma > A(0);
    const A norm_x = sqrt(alpha * alpha + sigma);
    const A sgn = alpha >= A(0) ? A(1) : A(-1);
    const A beta = safe ? -sgn * norm_x : alpha;
    const A denom = safe ? alpha - beta : A(1);
    const A tau = safe ? (beta - alpha) / beta : A(0);
    if (tid < b) proj[tid] = safe ? sums[tid] / denom + prow[tid] : prow[tid];
    // v into column j: 0 above the pivot, 1 at it, x / denom below
    for (int i = tid; i < nr; i += kClusterThreads) {
      const int a = a0 + i;
      P[i * b + j] = a < j ? A(0) : a == j ? A(1)
                     : safe ? P[i * b + j] / denom : A(0);
    }
    __syncthreads();
    // T's recurrence waits for the end: keep z = proj[:j] in row j below
    // the diagonal, and tau on it
    if (rank == 0 && tid <= j) Ts[j * b + tid] = tid < j ? proj[tid] : tau;
    // the update below the pivot (the pivot row is done)
    if (gc > j && gc < b)
      for (int i = max(0, j + 1 - a0) + gg; i < nr; i += G)
        P[i * b + gc] -= tau * (P[i * b + j] * proj[gc]);
    __syncthreads();
    if (j + 1 < b) publish(j + 1);
    // this CTA's partials of j+1 are published, and its reads of slot j&1
    // done, before the arrival
    cluster_arrive();
  }
  for (int idx = tid; idx < nr * b; idx += kClusterThreads)
    V[(int64_t)(rs + a0) * b + idx] = from_acc<S>(P[idx]);
  for (int64_t idx = (int64_t)rank * kClusterThreads + tid;
       idx < (int64_t)rs * b; idx += (int64_t)csize * kClusterThreads)
    V[idx] = from_acc<S>(A(0));
  if (rank == 0) {
    // T[r][j] = -tau_j sum_k T[r][k] z_j[k], k < j: row r needs only its
    // own earlier entries, so a thread a row, columns in order
    if (tid < b)
      for (int j = tid + 1; j < b; ++j) {
        A t = A(0);
        for (int k = tid; k < j; ++k) t += Ts[tid * b + k] * Ts[j * b + k];
        Ts[tid * b + j] = -Ts[j * b + j] * t;
      }
    __syncthreads();
    for (int idx = tid; idx < b * b; idx += kClusterThreads)
      T[idx] = from_acc<S>(idx % b >= idx / b ? Ts[idx] : A(0));
  }
  // no CTA leaves while another may still read its partials
  cluster_wait();
}

// every instance sets both attributes once, at its first launch or
// capacity query: the largest dynamic shared memory, and the
// non-portable cluster size that 16 CTAs need
template <typename S, int kMode>
cudaError_t cluster_launch_config(int csize, int smem, cudaStream_t stream,
                                  cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  static bool set = false;   // once a kernel instance
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(
        house_cluster_kernel<S, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxClusterSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        house_cluster_kernel<S, kMode>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    set = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(csize);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename S, int kMode>
int launch_cluster(const S* E, int64_t lde, S* V, S* T, int rows, int b,
                   int rs, int csize, int rpc, int smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_launch_config<S, kMode>(csize, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, house_cluster_kernel<S, kMode>, E, lde, V,
                           T, rows, b, rs, rpc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the checked launch of every cluster instance: rpc active rows a CTA
// (csize rpc >= rows - row_start), smem bytes of dynamic shared memory,
// at least rpc b and cluster_extra_entries(b) entries of the compute type
template <typename S>
int cluster_entry(const S* E, int64_t lde, S* V, S* T, int rows, int b,
                  int row_start, int csize, int rpc, int smem, int mode,
                  cudaStream_t stream) {
  const int64_t esize = sizeof(typename Acc<S>::type);
  const int64_t active = rows > row_start ? rows - row_start : 0;
  if (b < 1 || b > kMaxB || rows < 1 || row_start < 0 || csize < 1 ||
      csize > kMaxCluster || rpc < 1 || (int64_t)csize * rpc < active ||
      smem > kMaxClusterSmem ||
      (int64_t)smem < esize * ((int64_t)rpc * b + cluster_extra_entries(b)))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kBarrierOnly:
      return launch_cluster<S, kBarrierOnly>(E, lde, V, T, rows, b, row_start,
                                             csize, rpc, smem, stream);
    case kNoSums:
      return launch_cluster<S, kNoSums>(E, lde, V, T, rows, b, row_start,
                                        csize, rpc, smem, stream);
    case kFull:
      return launch_cluster<S, kFull>(E, lde, V, T, rows, b, row_start,
                                      csize, rpc, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// clusters of csize CTAs of the kFull instance for S, with smem bytes
// each, that the card holds at once (0: none; < 0: a CUDA error, negated)
template <typename S>
int cluster_capacity(int csize, int smem) {
  if (csize < 1 || csize > kMaxCluster) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_launch_config<S, kFull>(csize, smem, 0, &cfg, &attr);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, house_cluster_kernel<S, kFull>,
                                       &cfg);
  if (err != cudaSuccess) return -(int)err;
  return count;
}

template <typename S, int kMode>
int launch_coop(const S* E, int64_t lde, S* V, S* T,
                typename Acc<S>::type* Tw, typename Acc<S>::type* part,
                unsigned int* bar, int rows, int b, int row_start,
                cudaStream_t stream) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int nb = max(1, min(sms, (rows + 31) / 32));
  int rpb = (rows + nb - 1) / nb;
  nb = (rows + rpb - 1) / rpb;   // every block owns at least one row
  const size_t smem = (size_t)rpb * b * sizeof(typename Acc<S>::type);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err;
  if (!smem_set) {
    err = cudaFuncSetAttribute(house_panel_kernel<S, kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  void* args[] = {(void*)&E, (void*)&lde, (void*)&V, (void*)&T,
                  (void*)&Tw, (void*)&part, (void*)&bar, (void*)&rows,
                  (void*)&b, (void*)&row_start, (void*)&rpb};
  err = cudaLaunchCooperativeKernel(
      (const void*)house_panel_kernel<S, kMode>, dim3(nb), dim3(kThreads),
      args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// doubles of the scratch the cooperative launch needs at most: the
// per-reflector partials of every block (one per SM at most), and the
// alphas
int64_t house_panel_scratch_doubles(int b) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int64_t)b * sms + (int64_t)b * sms * b + b;
}

// V (rows, b) row-major and T (b, b) row-major of E[row_start:, :]; E is
// read through its row stride lde (unit column stride); part holds
// house_panel_scratch_doubles(b) doubles; bar is one zeroed counter. One
// cooperative launch; ``mode`` is kFull or a timing variant.
int house_panel_fp64(const double* E, int64_t lde, double* V, double* T,
                     double* part, unsigned int* bar, int rows, int b,
                     int row_start, int mode, cudaStream_t stream) {
  if (b < 1 || b > kMaxB || rows < 1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kBarrierOnly:
      return launch_coop<double, kBarrierOnly>(E, lde, V, T, T, part, bar,
                                               rows, b, row_start, stream);
    case kNoBarrier:
      return launch_coop<double, kNoBarrier>(E, lde, V, T, T, part, bar,
                                             rows, b, row_start, stream);
    case kNoSums:
      return launch_coop<double, kNoSums>(E, lde, V, T, T, part, bar, rows,
                                          b, row_start, stream);
    default:
      return launch_coop<double, kFull>(E, lde, V, T, T, part, bar, rows, b,
                                        row_start, stream);
  }
}

// The cooperative factorization in fp32: E, V, T and the scratch part
// (house_panel_scratch_doubles(b) floats) in fp32.
int house_panel_fp32(const float* E, int64_t lde, float* V, float* T,
                     float* part, unsigned int* bar, int rows, int b,
                     int row_start, cudaStream_t stream) {
  if (b < 1 || b > kMaxB || rows < 1) return (int)cudaErrorInvalidValue;
  return launch_coop<float, kFull>(E, lde, V, T, T, part, bar, rows, b,
                                   row_start, stream);
}

// The same for a bf16 panel, computed in fp32: V and T in bf16, Tw (b, b)
// and part in fp32.
int house_panel_bf16(const __nv_bfloat16* E, int64_t lde, __nv_bfloat16* V,
                     __nv_bfloat16* T, float* Tw, float* part,
                     unsigned int* bar, int rows, int b, int row_start,
                     cudaStream_t stream) {
  if (b < 1 || b > kMaxB || rows < 1) return (int)cudaErrorInvalidValue;
  return launch_coop<__nv_bfloat16, kFull>(E, lde, V, T, Tw, part, bar, rows,
                                           b, row_start, stream);
}

// The same with the panel in the distributed shared memory of one cluster
// of csize CTAs (the wrapper's plan), rpc active rows a CTA (csize rpc >=
// rows - row_start), smem bytes of dynamic shared memory: rpc b entries
// and cluster_extra_entries(b), 8 bytes an entry for fp64 and 4 (fp32,
// the compute type) for fp32 and bf16. ``mode``: kFull, kBarrierOnly or
// kNoSums. The bf16 instance reads E and writes V and T in bf16.
int house_cluster_fp64(const double* E, int64_t lde, double* V, double* T,
                       int rows, int b, int row_start, int csize, int rpc,
                       int smem, int mode, cudaStream_t stream) {
  return cluster_entry<double>(E, lde, V, T, rows, b, row_start, csize, rpc,
                               smem, mode, stream);
}

int house_cluster_fp32(const float* E, int64_t lde, float* V, float* T,
                       int rows, int b, int row_start, int csize, int rpc,
                       int smem, int mode, cudaStream_t stream) {
  return cluster_entry<float>(E, lde, V, T, rows, b, row_start, csize, rpc,
                              smem, mode, stream);
}

int house_cluster_bf16(const __nv_bfloat16* E, int64_t lde, __nv_bfloat16* V,
                       __nv_bfloat16* T, int rows, int b, int row_start,
                       int csize, int rpc, int smem, int mode,
                       cudaStream_t stream) {
  return cluster_entry<__nv_bfloat16>(E, lde, V, T, rows, b, row_start, csize,
                                      rpc, smem, mode, stream);
}

// How many clusters of csize CTAs with smem bytes each the card holds at
// once, asked of the instance that will run (registers differ between
// instances): 0 none, < 0 a CUDA error, negated.
int house_cluster_capacity_fp64(int csize, int smem) {
  return cluster_capacity<double>(csize, smem);
}

int house_cluster_capacity_fp32(int csize, int smem) {
  return cluster_capacity<float>(csize, smem);
}

int house_cluster_capacity_bf16(int csize, int smem) {
  return cluster_capacity<__nv_bfloat16>(csize, smem);
}

}  // extern "C"
