// TD2 kernels for Hopper (sm_90a): Sturm bisection and inverse iteration.
//
// Built with nvcc --fmad=false into a shared library with a plain C
// interface (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/tridiag_eig/kernel.py). Every entry point launches
// on the caller's stream, allocates nothing and returns cudaGetLastError().
//
// bisect_sturm replaces _bisect_kernel / bisect_sturm_pallas
// (repro/kernels/tridiag_eig/kernel.py). One thread per wanted index runs
// all 80 bisection sweeps; each sweep is the pivmin-clamped Sturm
// recurrence down all n rows, staged through shared memory in chunks so
// every thread of a block reads the same row (a broadcast). What bounds it
// on this card is latency, not bytes or flops: 80*n DEPENDENT fp64
// divisions per lane, with s lanes on ceil(s/128) of the 132 SMs. The
// recurrence keeps the reference's op order with the _rn intrinsics (no
// FMA contraction), so it agrees bitwise with the plain version.
//
// invit replaces _invit_kernel / invit_pallas (same file), as two launches
// per round:
//   invit_solve — one thread per shift: the DGTTRF partial-pivot LU of
//     T - lam_j I fused with the forward substitution, then the reversed
//     back substitution. The (n, s) row-major scratch D, DU, DU2, Y makes
//     neighbouring lanes touch neighbouring addresses (coalesced). Bound:
//     the dependent division chain of 2n steps per lane, again latency.
//   invit_orth — one block: max-abs-rescaled column norms, then
//     Gram-Schmidt over the columns in order within each cluster (mask
//     (j < i) & (cid_j == cid_i)), each dot product a block reduction in
//     shared memory. The (n, s) block (8 MB at n=9997, s=100) stays in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBisThreads = 128;
constexpr int kBisChunk = 2048;  // rows staged per pass: 2 x 16 KB static shared
constexpr int kSolveThreads = 128;
constexpr int kOrthThreads = 512;
constexpr double kTiny = 2.2250738585072014e-308;  // DBL_MIN, finfo.tiny

__device__ __forceinline__ double clamp_piv(double q, double piv) {
  return fabs(q) < piv ? (q < 0.0 ? -piv : piv) : q;
}

__global__ void __launch_bounds__(kBisThreads)
bisect_sturm_kernel(const double* __restrict__ d, const double* __restrict__ e2,
                    const int64_t* __restrict__ ks,
                    const double* __restrict__ scal, double* __restrict__ lam,
                    int n, int s, int max_iters) {
  __shared__ double sd[kBisChunk];
  __shared__ double se[kBisChunk];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = j < s ? ks[j] : 0;
  const double piv = scal[2];
  double lo = scal[0];
  double hi = scal[1];
  for (int it = 0; it < max_iters; ++it) {
    const double mid = __dmul_rn(0.5, __dadd_rn(lo, hi));
    double q = 1.0;
    int64_t cnt = 0;
    for (int c0 = 0; c0 < n; c0 += kBisChunk) {
      const int m = min(kBisChunk, n - c0);
      __syncthreads();
      for (int r = threadIdx.x; r < m; r += blockDim.x) {
        sd[r] = d[c0 + r];
        se[r] = e2[c0 + r];
      }
      __syncthreads();
      for (int r = 0; r < m; ++r) {
        q = __dsub_rn(__dsub_rn(sd[r], mid), __ddiv_rn(se[r], clamp_piv(q, piv)));
        cnt += (q < 0.0);
      }
    }
    const bool right = cnt <= k;  // lambda_k >= mid
    lo = right ? mid : lo;
    hi = right ? hi : mid;
  }
  if (j < s) lam[j] = __dmul_rn(0.5, __dadd_rn(lo, hi));
}

__global__ void __launch_bounds__(kSolveThreads)
invit_solve_kernel(const double* __restrict__ d, const double* __restrict__ e,
                   const double* __restrict__ lam, const double* __restrict__ pivp,
                   double* __restrict__ Z, double* __restrict__ D,
                   double* __restrict__ DU, double* __restrict__ DU2,
                   double* __restrict__ Y, int n, int s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s) return;
  const double piv = *pivp;
  const double lj = lam[j];
  if (n == 1) {  // the reference's n == 1 branch: unsigned clamp
    const double diag = __dsub_rn(d[0], lj);
    Z[j] = __ddiv_rn(Z[j], fabs(diag) < piv ? piv : diag);
    return;
  }
  double dcur = __dsub_rn(d[0], lj);
  double ducur = e[0];
  double bcur = Z[j];
  for (int i = 0; i < n - 1; ++i) {
    const double dl = e[i];
    const double dnext = __dsub_rn(d[i + 1], lj);
    const double dunext = i + 1 < n - 1 ? e[i + 1] : 0.0;
    const size_t o = (size_t)i * s + j;
    const double bnext = Z[o + s];
    const bool ns = fabs(dcur) >= fabs(dl);
    const double f_ns = __ddiv_rn(dl, clamp_piv(dcur, piv));
    const double f_sw = __ddiv_rn(dcur, clamp_piv(dl, piv));
    D[o] = ns ? dcur : dl;
    DU[o] = ns ? ducur : dnext;
    DU2[o] = ns ? 0.0 : dunext;
    const double L = ns ? f_ns : f_sw;
    const double dn = ns ? __dsub_rn(dnext, __dmul_rn(f_ns, ducur))
                         : __dsub_rn(ducur, __dmul_rn(f_sw, dnext));
    const double dun = ns ? dunext : __dmul_rn(-f_sw, dunext);
    Y[o] = ns ? bcur : bnext;
    const double bn = ns ? __dsub_rn(bnext, __dmul_rn(L, bcur))
                         : __dsub_rn(bcur, __dmul_rn(L, bnext));
    dcur = dn;
    ducur = dun;
    bcur = bn;
  }
  const size_t last = (size_t)(n - 1) * s + j;
  D[last] = dcur;
  DU[last] = 0.0;
  DU2[last] = 0.0;
  Y[last] = bcur;
  double x1 = 0.0, x2 = 0.0;
  for (int i = n - 1; i >= 0; --i) {
    const size_t o = (size_t)i * s + j;
    const double num = __dsub_rn(__dsub_rn(Y[o], __dmul_rn(DU[o], x1)),
                                 __dmul_rn(DU2[o], x2));
    const double xi = __ddiv_rn(num, clamp_piv(D[o], piv));
    Z[o] = xi;
    x2 = x1;
    x1 = xi;
  }
}

// Block-wide reductions; red holds 33 doubles, the result lands in red[32].
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// x / max(m * sqrt(sum((x/m)^2)), tiny) with m = max(max|x|, tiny), for
// column c. Every loop maps row r to the same thread, so a thread reads
// back only what it wrote; the reductions order the rest.
__device__ void normalize_column(double* Z, int c, int n, int s, double* red) {
  double m = 0.0;
  for (int r = threadIdx.x; r < n; r += blockDim.x) m = fmax(m, fabs(Z[(size_t)r * s + c]));
  m = fmax(block_max(m, red), kTiny);
  double ss = 0.0;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const double x = Z[(size_t)r * s + c] / m;
    ss += x * x;
  }
  const double nrm = fmax(m * sqrt(block_sum(ss, red)), kTiny);
  for (int r = threadIdx.x; r < n; r += blockDim.x) Z[(size_t)r * s + c] /= nrm;
}

__global__ void __launch_bounds__(kOrthThreads)
invit_orth_kernel(double* __restrict__ Z, const int* __restrict__ cid, int n, int s) {
  extern __shared__ double coeff[];  // s
  __shared__ double red[33];
  for (int c = 0; c < s; ++c) normalize_column(Z, c, n, s, red);
  for (int i = 1; i < s; ++i) {
    const int ci = cid[i];
    for (int j = 0; j < i; ++j) {
      double c = 0.0;
      if (cid[j] == ci) {  // uniform across the block
        double acc = 0.0;
        for (int r = threadIdx.x; r < n; r += blockDim.x)
          acc += Z[(size_t)r * s + j] * Z[(size_t)r * s + i];
        c = block_sum(acc, red);
      }
      if (threadIdx.x == 0) coeff[j] = c;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      double acc = 0.0;
      for (int j = 0; j < i; ++j)
        if (cid[j] == ci) acc += Z[(size_t)r * s + j] * coeff[j];
      Z[(size_t)r * s + i] -= acc;
    }
    normalize_column(Z, i, n, s, red);
  }
}

}  // namespace

extern "C" {

int tridiag_bisect_sturm(const void* d, const void* e2, const void* ks,
                         const void* scal, void* lam, int n, int s,
                         int max_iters, void* stream) {
  const int blocks = (s + kBisThreads - 1) / kBisThreads;
  bisect_sturm_kernel<<<blocks, kBisThreads, 0, (cudaStream_t)stream>>>(
      (const double*)d, (const double*)e2, (const int64_t*)ks,
      (const double*)scal, (double*)lam, n, s, max_iters);
  return (int)cudaGetLastError();
}

int tridiag_invit_solve(const void* d, const void* e, const void* lam,
                        const void* piv, void* Z, void* D, void* DU,
                        void* DU2, void* Y, int n, int s, void* stream) {
  const int blocks = (s + kSolveThreads - 1) / kSolveThreads;
  invit_solve_kernel<<<blocks, kSolveThreads, 0, (cudaStream_t)stream>>>(
      (const double*)d, (const double*)e, (const double*)lam,
      (const double*)piv, (double*)Z, (double*)D, (double*)DU, (double*)DU2,
      (double*)Y, n, s);
  return (int)cudaGetLastError();
}

int tridiag_invit_orth(void* Z, const void* cid, int n, int s, void* stream) {
  const size_t shm = (size_t)s * sizeof(double);
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        invit_orth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  invit_orth_kernel<<<1, kOrthThreads, shm, (cudaStream_t)stream>>>(
      (double*)Z, (const int*)cid, n, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
