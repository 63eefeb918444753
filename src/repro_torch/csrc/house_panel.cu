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
// each needs two reductions over the whole panel (the tail norm, then the
// b projections v^T R): 2 b global round trips.
//
// Design. The TPU kernel keeps the whole panel in VMEM; a 1.3 MB panel
// does not fit one block's 227 KB of shared memory, so the panel is split
// by rows over up to one block per SM, each holding its rows in shared
// memory for the whole factorization, and the blocks meet at a grid
// barrier twice per reflector. The launch is cooperative, so all blocks
// are resident and the barrier (a counter in global memory) cannot
// deadlock. Per reflector: every block publishes the partial tail norm of
// its rows (and the pivot's owner publishes alpha); barrier; every block
// sums the partials in block order, so all blocks compute the same tau;
// each block writes v into column j of its rows — column j holds R[:, j]
// until then, columns < j hold V and columns > j hold R — and publishes
// its partial v^T buf over all columns, which gives both the panel
// projections (columns > j) and z = V^T v for the T recurrence (columns
// < j); barrier; every block sums those in block order, updates its rows,
// and block 0 extends T. Partials go to per-reflector slots, so no slot
// is reused within a launch. Every sum runs in a fixed order, so a result
// repeats bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // projection columns per pass over the rows
constexpr int kMaxB = 128;
constexpr int kMaxSmem = 200 * 1024;

// sum over the block, in a fixed order; every thread gets the total
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const double total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

// sum of vals[0], vals[stride], ... over the nb blocks' partials, by one
// warp, in a fixed order (the same in every block); lane 0 gets the sum
__device__ double warp_sum_partials(const double* vals, int64_t stride,
                                    int nb) {
  const int lane = threadIdx.x & 31;
  double t = 0.0;
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

__global__ void __launch_bounds__(kThreads)
house_panel_kernel(const double* __restrict__ E, int64_t lde,
                   double* __restrict__ V, double* __restrict__ T,
                   double* __restrict__ part, unsigned int* bar, int rows,
                   int b, int rs, int rpb) {
  extern __shared__ double P[];          // this block's rows, (rpb, b)
  __shared__ double red[kWarps + 1];
  __shared__ double wred[kWarps][kChunk];
  __shared__ double proj[kMaxB];
  __shared__ double scal[2];             // total tail norm^2, alpha
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  const int r0 = blk * rpb;
  const int nr = max(0, min(rows, r0 + rpb) - r0);
  double* part_sq = part;                          // [b][nb]
  double* part_pr = part + (int64_t)b * nb;        // [b][nb][b]
  double* alphas = part_pr + (int64_t)b * nb * b;  // [b]
  unsigned int target = 0;

  for (int idx = tid; idx < nr * b; idx += kThreads) {
    const int64_t i = r0 + idx / b;
    P[idx] = i >= rs ? E[i * lde + idx % b] : 0.0;
  }
  if (blk == 0)
    for (int idx = tid; idx < b * b; idx += kThreads) T[idx] = 0.0;
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const int pivot = rs + j;
    // ---- the partial tail norm, and alpha from the pivot's owner -------
    if (tid == 0 && pivot >= r0 && pivot < r0 + nr)
      alphas[j] = P[(pivot - r0) * b + j];
    double sq = 0.0;
    for (int i = tid; i < nr; i += kThreads) {
      if (r0 + i >= pivot) {
        const double x = P[i * b + j];
        sq += x * x;
      }
    }
    sq = block_sum(sq, red);
    if (tid == 0) part_sq[(int64_t)j * nb + blk] = sq;
    grid_sync(bar, target);
    if (warp == 0) {
      const double total = warp_sum_partials(part_sq + (int64_t)j * nb, 1,
                                             nb);
      if (lane == 0) {
        scal[0] = total;
        scal[1] = pivot < rows ? __ldcg(alphas + j) : 0.0;
      }
    }
    __syncthreads();
    const double alpha = scal[1];
    double sigma = scal[0] - alpha * alpha;
    sigma = sigma < 0.0 ? 0.0 : sigma;   // max(., 0), NaN passes through
    const bool safe = sigma > 0.0;
    const double norm_x = sqrt(alpha * alpha + sigma);
    const double sgn = alpha >= 0.0 ? 1.0 : -1.0;
    const double beta = safe ? -sgn * norm_x : alpha;
    const double denom = safe ? alpha - beta : 1.0;
    const double tau = safe ? (beta - alpha) / beta : 0.0;

    // ---- v into column j, then the partial v^T buf over every column ---
    for (int i = tid; i < nr; i += kThreads) {
      const int gi = r0 + i;
      if (gi < rs) continue;
      double v;
      if (!safe) v = gi == pivot ? 1.0 : 0.0;
      else if (gi > pivot) v = P[i * b + j] / denom;
      else v = gi == pivot ? 1.0 : 0.0;
      P[i * b + j] = v;
    }
    double* slot = part_pr + ((int64_t)j * nb + blk) * b;
    for (int c0 = 0; c0 < b; c0 += kChunk) {
      const int nc = min(kChunk, b - c0);
      double acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.0;
      for (int i = tid; i < nr; i += kThreads) {
        if (r0 + i < pivot) continue;   // v is zero above the pivot
        const double v = P[i * b + j];
        const double* row = P + i * b + c0;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c < nc) acc[c] += v * row[c];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        double t = acc[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
        if (lane == 0) wred[warp][c] = t;
      }
      __syncthreads();
      if (tid < nc) {
        double t = 0.0;
        for (int w = 0; w < kWarps; ++w) t += wred[w][tid];
        slot[c0 + tid] = t;
      }
      __syncthreads();
    }
    grid_sync(bar, target);
    for (int c = warp; c < b; c += kWarps) {
      const double t = warp_sum_partials(
          part_pr + (int64_t)j * nb * b + c, b, nb);
      if (lane == 0) proj[c] = t;
    }
    __syncthreads();

    // ---- T column j from z = proj[:j]; the update R -= tau v p^T -------
    if (blk == 0) {
      if (tid < j) {
        double t = 0.0;
        for (int k = 0; k < j; ++k) t += T[tid * b + k] * proj[k];
        T[tid * b + j] = -tau * t;
      }
      if (tid == 0) T[j * b + j] = tau;
    }
    for (int i = tid; i < nr; i += kThreads) {
      if (r0 + i <= pivot) continue;   // v = 0 above; the pivot row is done
      const double v = P[i * b + j];
      for (int c = j + 1; c < b; ++c) P[i * b + c] -= tau * (v * proj[c]);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nr * b; idx += kThreads)
    V[(int64_t)r0 * b + idx] = P[idx];
}

}  // namespace

extern "C" {

// doubles of the scratch the launch needs: the per-reflector partials of
// every block, and the alphas
int64_t house_panel_scratch_doubles(int rows, int b) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nb = max(1, min(sms, (rows + 31) / 32));
  return (int64_t)b * nb + (int64_t)b * nb * b + b;
}

// V (rows, b) row-major and T (b, b) row-major of E[row_start:, :]; E is
// read through its row stride lde (unit column stride); part holds
// house_panel_scratch_doubles(rows, b) doubles; bar is one zeroed counter.
int house_panel_fp64(const double* E, int64_t lde, double* V, double* T,
                     double* part, unsigned int* bar, int rows, int b,
                     int row_start, cudaStream_t stream) {
  if (b < 1 || b > kMaxB || rows < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int nb = max(1, min(sms, (rows + 31) / 32));
  int rpb = (rows + nb - 1) / nb;
  nb = (rows + rpb - 1) / rpb;   // every block owns at least one row
  const size_t smem = (size_t)rpb * b * sizeof(double);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err;
  if (!smem_set) {
    err = cudaFuncSetAttribute(house_panel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  void* args[] = {(void*)&E, (void*)&lde, (void*)&V, (void*)&T,
                  (void*)&part, (void*)&bar, (void*)&rows, (void*)&b,
                  (void*)&row_start, (void*)&rpb};
  err = cudaLaunchCooperativeKernel((const void*)house_panel_kernel,
                                    dim3(nb), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int house_panel_max_b() { return kMaxB; }

}  // extern "C"
