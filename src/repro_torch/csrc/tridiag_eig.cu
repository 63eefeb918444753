// TD2 kernels for Hopper (sm_90a): Sturm bisection and inverse iteration.
//
// Built with nvcc --fmad=false into a shared library with a plain C
// interface (repro_torch/kernels/_build.py) and bound with ctypes
// (repro_torch/kernels/tridiag_eig/kernel.py). Every entry point launches
// on the caller's stream, allocates nothing and returns cudaGetLastError().
//
// bisect_sturm replaces _bisect_kernel / bisect_sturm_pallas
// (repro/kernels/tridiag_eig/kernel.py). Each sweep of the bisection is the
// pivmin-clamped Sturm recurrence down all n rows, and every step of it is
// a DEPENDENT fp64 division: what bounds a lane on this card is that chain
// (~81 ns a step), not bytes or flops. One lane an index takes 80 sweeps of
// n steps (64 ms at n = 9997), and its s lanes fill a sliver of the card.
// So the kernel shortens the chain by exact multisection: bisection from
// (lo, hi) is a deterministic map, so the 2^m - 1 midpoints it could visit
// in its next m levels are known ahead, each by the sequential loop's own
// ops (mid = 0.5 (lo + hi), _rn intrinsics). A wanted index owns a team of
// 2^m threads of one block; in a round, thread t takes heap node t + 1
// (node 1 the round's (lo, hi), node j's children 2j and 2j + 1), derives
// its interval from the root, and runs the Sturm recurrence at its
// midpoint, unchanged; the counts are exchanged (warp shuffles for a team
// within a warp, shared memory above) and every thread walks the same path
// with right = cnt <= k. One sweep thus does m levels, and the result is
// the sequential bisection's bit for bit (m = 1 is that loop). A level that
// leaves (lo, hi) unchanged, bit for bit, has hit a fixed point of the map,
// so the index is done; a block ends once all its indices are (the stop
// flag), its threads meeting every barrier until then. The rows are staged
// in chunks through shared memory (a broadcast: every thread reads the
// same row; read through L1 instead, the sweep was slower at the plan's m,
// PERF.md). The plan (levels, indices a block) is kernel.py's bisect_plan:
// the most levels that keep an SM within the threads at which the step
// holds its one-lane time. The recurrence keeps the reference's op
// order with the _rn intrinsics (no FMA contraction), so it agrees bitwise
// with the plain version.
//
// invit replaces _invit_kernel / invit_pallas (same file), as two launches
// per round, Z (n, s) row-major throughout:
//   invit_solve — one thread per shift, 32 a block (one warp), so s = 100
//     spans 4 SMs and s = 448 spans 14: the DGTTRF partial-pivot LU of
//     T - lam_j I fused with the forward substitution, then the reversed
//     back substitution. Bound: the dependent chain of 2n steps per lane,
//     one fp64 division each (only the pivot branch's factor is computed;
//     the other, which the reference selects away, is not). The loads of
//     the next kSolveU rows (d, e and the right-hand side forward; the
//     packed D, DU, DU2, Y back) are issued before the current rows are
//     computed, so no step waits on memory. The (n, s, 4) scratch keeps a
//     row of a warp's 32 lanes in 1 KB (coalesced, two 16-byte loads a
//     lane). The _rn intrinsics keep the plain version's rounding.
//   invit_orth — one cooperative launch across the card (a block per SM,
//     each owning a contiguous range of rows, so a block's share of a row
//     is contiguous and every access below is coalesced or a broadcast):
//     (a) the max-abs-rescaled norms of all columns (per-block partials,
//     reduced column by column in block order); (b) the same again for
//     singleton columns past the first, which the reference renormalizes
//     after an empty projection; (c) within each cluster of two or more
//     columns, a left-looking classical Gram-Schmidt in panels of kPanel
//     columns: C = Z_prev^T Z_panel from per-block partials reduced in
//     block order, then Z_panel -= Z_prev C; then the panel's columns one
//     at a time from shared memory: dots with the panel's earlier columns,
//     the update, and the rescaled renormalization, each cross-block sum
//     reduced in block order by every block alike. A grid barrier (an
//     atomic counter, as in rot_apply.cu) separates the steps: about three
//     a column. Every sum has a fixed order, so two runs agree bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBisChunk = 2048;  // rows staged per pass: 2 x 16 KB static shared
constexpr int kBisMaxLevels = 10;  // a team of 2^levels threads, a block at most
constexpr int kBisMaxThreads = 1 << kBisMaxLevels;
// flags of tridiag_bisect_sturm
constexpr int kBisStop = 1;  // a block ends when all its indices are fixed
constexpr int kSolveLanes = 32;  // shifts of a solve block
constexpr int kSolveU = 8;       // rows whose loads are in flight ahead
constexpr int kOrthThreads = 256;
constexpr int kPanel = 32;       // columns of a Gram-Schmidt panel
constexpr double kTiny = 2.2250738585072014e-308;  // DBL_MIN, finfo.tiny

__device__ __forceinline__ double clamp_piv(double q, double piv) {
  return fabs(q) < piv ? (q < 0.0 ? -piv : piv) : q;
}

// the index's state after a level: unchanged bit for bit is a fixed point
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// One wanted index per team of 2^levels threads, per_block teams a block.
// sweeps (may be null) gets, per index, the round whose walk found its
// fixed point (1-based), or the rounds its block ran if none did.
__global__ void __launch_bounds__(kBisMaxThreads)
bisect_sturm_kernel(const double* __restrict__ d, const double* __restrict__ e2,
                    const int64_t* __restrict__ ks,
                    const double* __restrict__ scal, double* __restrict__ lam,
                    int* __restrict__ sweeps, int n, int s, int max_iters,
                    int levels, int per_block, bool stop) {
  __shared__ double sd[kBisChunk];
  __shared__ double se[kBisChunk];
  extern __shared__ int scnt[];  // the counts, for teams wider than a warp
  const int T = 1 << levels;
  const int team = threadIdx.x >> levels;
  const int node = (threadIdx.x & (T - 1)) + 1;
  const int depth = 31 - __clz(node);
  const int j = blockIdx.x * per_block + team;
  const bool valid = j < s;
  // the threads of this warp (a block of fewer than 32 fills part of one)
  const int in_warp = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  const unsigned warp_mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1;
  const int64_t k = valid ? ks[j] : 0;
  const double piv = scal[2];
  double lo = scal[0];
  double hi = scal[1];
  bool fixed = !valid;
  int first = 0, rounds = 0;
  for (int done = 0; done < max_iters;) {
    const int L = min(levels, max_iters - done);
    // this node's interval, from the root by the sequential loop's ops
    double nlo = lo, nhi = hi;
    for (int b = depth - 1; b >= 0; --b) {
      const double m = __dmul_rn(0.5, __dadd_rn(nlo, nhi));
      if ((node >> b) & 1) nlo = m;
      else nhi = m;
    }
    const double mid = __dmul_rn(0.5, __dadd_rn(nlo, nhi));
    // a fixed index sweeps on only without the stop (the full-work variant)
    const bool active = valid && depth < L && !(stop && fixed);
    double q = 1.0;
    int cnt = 0;
    for (int c0 = 0; c0 < n; c0 += kBisChunk) {
      const int m = min(kBisChunk, n - c0);
      __syncthreads();
      for (int r = threadIdx.x; r < m; r += blockDim.x) {
        sd[r] = d[c0 + r];
        se[r] = e2[c0 + r];
      }
      __syncthreads();
      if (active) {
        for (int r = 0; r < m; ++r) {
          q = __dsub_rn(__dsub_rn(sd[r], mid), __ddiv_rn(se[r], clamp_piv(q, piv)));
          cnt += (q < 0.0);
        }
      }
    }
    if (T > 32) {
      scnt[threadIdx.x] = cnt;
      __syncthreads();
    }
    ++rounds;
    // the walk: every thread of the team follows the same path
    int at = 1;
    for (int l = 0; l < L; ++l) {
      const int c = T <= 32 ? __shfl_sync(warp_mask, cnt, at - 1, T)
                            : scnt[(team << levels) + at - 1];
      const bool right = c <= k;  // lambda_k >= mid
      if (!fixed) {
        const double m = __dmul_rn(0.5, __dadd_rn(lo, hi));
        const double tlo = right ? m : lo;
        const double thi = right ? hi : m;
        if (same_bits(tlo, lo) && same_bits(thi, hi)) {
          fixed = true;
          first = rounds;
        }
        lo = tlo;
        hi = thi;
      }
      at = 2 * at + (right ? 1 : 0);
    }
    done += L;
    // also the barrier between this round's reads of scnt and the next's
    // writes
    const bool all_fixed = __syncthreads_and(fixed);
    if (stop && all_fixed) break;
  }
  if (valid && node == 1) {
    lam[j] = __dmul_rn(0.5, __dadd_rn(lo, hi));
    if (sweeps) sweeps[j] = first ? first : rounds;
  }
}

// forward step i's inputs for rows i0 .. i0+kSolveU-1: d[i+1], e[i],
// e[i+1] and the right-hand side Z[i+1, j]; rows past n-2 load row n-2's
// (in bounds, never used)
__device__ __forceinline__ void fwd_fetch(
    const double* __restrict__ d, const double* __restrict__ e,
    const double* __restrict__ Z, int i0, int n, int s, int j,
    double (&dn)[kSolveU], double (&e0)[kSolveU], double (&e1)[kSolveU],
    double (&bn)[kSolveU]) {
#pragma unroll
  for (int m = 0; m < kSolveU; ++m) {
    const int i = min(i0 + m, n - 2);
    dn[m] = d[i + 1];
    e0[m] = e[i];
    e1[m] = e[min(i + 1, n - 2)];
    bn[m] = Z[(size_t)(i + 1) * s + j];
  }
}

// back step i's packed (D, DU), (DU2, Y) for rows i0, i0-1, ...; rows
// below 0 load row 0's
__device__ __forceinline__ void bwd_fetch(const double2* __restrict__ W2,
                                          int i0, int s, int j,
                                          double2 (&a)[kSolveU],
                                          double2 (&b)[kSolveU]) {
#pragma unroll
  for (int m = 0; m < kSolveU; ++m) {
    const size_t o = ((size_t)max(i0 - m, 0) * s + j) * 2;
    a[m] = W2[o];
    b[m] = W2[o + 1];
  }
}

__global__ void __launch_bounds__(kSolveLanes)
invit_solve_kernel(const double* __restrict__ d, const double* __restrict__ e,
                   const double* __restrict__ lam, const double* __restrict__ pivp,
                   double* __restrict__ Z, double2* __restrict__ W2, int n,
                   int s) {
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
  {
    double cd[kSolveU], ce0[kSolveU], ce1[kSolveU], cb[kSolveU];
    double nd[kSolveU], ne0[kSolveU], ne1[kSolveU], nb[kSolveU];
    fwd_fetch(d, e, Z, 0, n, s, j, cd, ce0, ce1, cb);
    for (int i0 = 0; i0 < n - 1; i0 += kSolveU) {
      fwd_fetch(d, e, Z, i0 + kSolveU, n, s, j, nd, ne0, ne1, nb);
#pragma unroll
      for (int m = 0; m < kSolveU; ++m) {
        const int i = i0 + m;
        if (i < n - 1) {
          const double dl = ce0[m];
          const double dnext = __dsub_rn(cd[m], lj);
          const double dunext = i + 1 < n - 1 ? ce1[m] : 0.0;
          const double bnext = cb[m];
          const bool ns = fabs(dcur) >= fabs(dl);
          // the factor of the branch taken (the reference computes both)
          const double L = ns ? __ddiv_rn(dl, clamp_piv(dcur, piv))
                              : __ddiv_rn(dcur, clamp_piv(dl, piv));
          const size_t o = ((size_t)i * s + j) * 2;
          W2[o] = make_double2(ns ? dcur : dl, ns ? ducur : dnext);
          W2[o + 1] = make_double2(ns ? 0.0 : dunext, ns ? bcur : bnext);
          const double dn = ns ? __dsub_rn(dnext, __dmul_rn(L, ducur))
                               : __dsub_rn(ducur, __dmul_rn(L, dnext));
          const double dun = ns ? dunext : __dmul_rn(-L, dunext);
          const double bn = ns ? __dsub_rn(bnext, __dmul_rn(L, bcur))
                               : __dsub_rn(bcur, __dmul_rn(L, bnext));
          dcur = dn;
          ducur = dun;
          bcur = bn;
        }
      }
#pragma unroll
      for (int m = 0; m < kSolveU; ++m) {
        cd[m] = nd[m];
        ce0[m] = ne0[m];
        ce1[m] = ne1[m];
        cb[m] = nb[m];
      }
    }
  }
  const size_t last = ((size_t)(n - 1) * s + j) * 2;
  W2[last] = make_double2(dcur, 0.0);
  W2[last + 1] = make_double2(0.0, bcur);
  double x1 = 0.0, x2 = 0.0;
  double2 ca[kSolveU], cb[kSolveU], na[kSolveU], nb[kSolveU];
  bwd_fetch(W2, n - 1, s, j, ca, cb);
  for (int i0 = n - 1; i0 >= 0; i0 -= kSolveU) {
    bwd_fetch(W2, i0 - kSolveU, s, j, na, nb);
#pragma unroll
    for (int m = 0; m < kSolveU; ++m) {
      const int i = i0 - m;
      if (i >= 0) {
        // (Y - DU x1) - DU2 x2, over the clamped pivot D
        const double num = __dsub_rn(__dsub_rn(cb[m].y, __dmul_rn(ca[m].y, x1)),
                                     __dmul_rn(cb[m].x, x2));
        const double xi = __ddiv_rn(num, clamp_piv(ca[m].x, piv));
        Z[(size_t)i * s + j] = xi;
        x2 = x1;
        x1 = xi;
      }
    }
#pragma unroll
    for (int m = 0; m < kSolveU; ++m) {
      ca[m] = na[m];
      cb[m] = nb[m];
    }
  }
}

// Block-wide reductions in a fixed order; red holds 33 doubles, the result
// lands in red[32] and is returned to every thread.
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

// lane 0 gets the sum (max) of the warp's values, in a fixed order
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// A load from L2 (past this SM's L1) of data other blocks wrote before the
// last barrier. Volatile with a memory clobber: __ldcg's asm declares no
// memory access, so the compiler may move it above the barrier.
__device__ __forceinline__ double ld_cg(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// all blocks of the (cooperative, hence co-resident) grid meet here;
// ``target`` counts the arrivals every block waits for, the same in all.
// Data other blocks wrote before the barrier is read with ld_cg (L2).
__device__ void grid_sync(unsigned int* count, unsigned int& target) {
  __threadfence();
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

// The grid's view of one Gram-Schmidt launch: block ``blk`` owns rows
// [r0, r0 + rows) of Z (n, s) row-major.
struct Orth {
  double* Z;
  const int* cid;
  unsigned int* bar;
  unsigned int target;
  int n, s, r0, rows;
  // scratch (doubles): per-block partials of every column, the columns'
  // max and norm, per-block partials of C, C, per-block partial dots,
  // maxima and sums of one column
  double *part_col, *col_m, *col_n, *part_c, *Cm, *part_d, *part_m, *part_s;
};

__device__ __forceinline__ bool singleton_past_first(const int* cid, int c, int s) {
  return c > 0 && cid[c] != cid[c - 1] && (c + 1 == s || cid[c + 1] != cid[c]);
}

// Every selected column scaled by its max-abs-rescaled norm,
// x / max(m sqrt(sum((x/m)^2)), tiny) with m = max(max|x|, tiny): all
// columns, or (singles) the singleton columns past the first.
__device__ void normalize_columns_grid(Orth& o, bool singles) {
  const int tid = threadIdx.x, blk = blockIdx.x, nblk = gridDim.x;
  const int gtid = blk * blockDim.x + tid, gthreads = nblk * blockDim.x;
  const int n_rows = o.rows, s = o.s;
  double* Zb = o.Z + (size_t)o.r0 * s;
  for (int c = tid; c < s; c += blockDim.x) {
    double m = 0.0;
    if (!singles || singleton_past_first(o.cid, c, s))
      for (int r = 0; r < n_rows; ++r) m = fmax(m, fabs(Zb[(size_t)r * s + c]));
    o.part_col[(size_t)blk * s + c] = m;
  }
  grid_sync(o.bar, o.target);
  for (int c = gtid; c < s; c += gthreads) {
    double m = 0.0;
    for (int b = 0; b < nblk; ++b) m = fmax(m, ld_cg(o.part_col + (size_t)b * s + c));
    o.col_m[c] = fmax(m, kTiny);
  }
  grid_sync(o.bar, o.target);
  for (int c = tid; c < s; c += blockDim.x) {
    double ss = 0.0;
    if (!singles || singleton_past_first(o.cid, c, s)) {
      const double m = ld_cg(o.col_m + c);
      for (int r = 0; r < n_rows; ++r) {
        const double x = Zb[(size_t)r * s + c] / m;
        ss += x * x;
      }
    }
    o.part_col[(size_t)blk * s + c] = ss;
  }
  grid_sync(o.bar, o.target);
  for (int c = gtid; c < s; c += gthreads) {
    double ss = 0.0;
    for (int b = 0; b < nblk; ++b) ss += ld_cg(o.part_col + (size_t)b * s + c);
    o.col_n[c] = fmax(ld_cg(o.col_m + c) * sqrt(ss), kTiny);
  }
  grid_sync(o.bar, o.target);
  for (int c = tid; c < s; c += blockDim.x) {
    if (singles && !singleton_past_first(o.cid, c, s)) continue;
    const double nrm = ld_cg(o.col_n + c);
    for (int r = 0; r < n_rows; ++r) Zb[(size_t)r * s + c] /= nrm;
  }
  // the panels read these rows with another thread mapping
  __syncthreads();
}

// Panel [p0, p1) of the cluster that starts at c0: projected against the
// cluster's earlier columns [c0, p0), then its own columns in order.
// Ps holds this block's rows of the panel, kPanel doubles a row.
__device__ void orth_panel(Orth& o, int c0, int p0, int p1, double* Ps,
                           double* red, double* coef, double* bc) {
  const int tid = threadIdx.x, blk = blockIdx.x, nblk = gridDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int gtid = blk * blockDim.x + tid, gthreads = nblk * blockDim.x;
  const int w = p1 - p0, k = p0 - c0, s = o.s, rows = o.rows;
  double* Zb = o.Z + (size_t)o.r0 * s;
  for (int idx = tid; idx < rows * kPanel; idx += blockDim.x) {
    const int rl = idx / kPanel, q = idx % kPanel;
    Ps[idx] = q < w ? Zb[(size_t)rl * s + p0 + q] : 0.0;
  }
  __syncthreads();
  if (k > 0) {
    // this block's rows of C = Z_prev^T Z_panel: a thread per earlier
    // column (a coalesced row segment), the panel's row a broadcast
    for (int jj = tid; jj < k; jj += blockDim.x) {
      double acc[kPanel];
#pragma unroll
      for (int q = 0; q < kPanel; ++q) acc[q] = 0.0;
      for (int rl = 0; rl < rows; ++rl) {
        const double z = Zb[(size_t)rl * s + c0 + jj];
#pragma unroll
        for (int q = 0; q < kPanel; ++q) acc[q] += z * Ps[rl * kPanel + q];
      }
      double* out = o.part_c + ((size_t)blk * s + jj) * kPanel;
#pragma unroll
      for (int q = 0; q < kPanel; ++q)
        if (q < w) out[q] = acc[q];
    }
    grid_sync(o.bar, o.target);
    for (int idx = gtid; idx < k * kPanel; idx += gthreads) {
      const int jj = idx / kPanel, q = idx % kPanel;
      if (q >= w) continue;
      double acc = 0.0;
      for (int b = 0; b < nblk; ++b)
        acc += ld_cg(o.part_c + ((size_t)b * s + jj) * kPanel + q);
      o.Cm[idx] = acc;
    }
    grid_sync(o.bar, o.target);
    // Z_panel -= Z_prev C: a warp a row, a lane a panel column; the row's
    // earlier columns loaded 32 at a time and broadcast by shuffles
    for (int rl = warp; rl < rows; rl += nwarp) {
      const double* zr = Zb + (size_t)rl * s + c0;
      double acc = 0.0;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const double zl = j0 + lane < k ? zr[j0 + lane] : 0.0;
        const int cnt = min(32, k - j0);
        for (int t = 0; t < cnt; ++t)
          acc += __shfl_sync(0xffffffffu, zl, t) *
                 ld_cg(o.Cm + (size_t)(j0 + t) * kPanel + lane);
      }
      if (lane < w) Ps[rl * kPanel + lane] -= acc;
    }
    __syncthreads();
  }
  for (int ii = 0; ii < w; ++ii) {
    if (ii > 0) {
      // dots with the panel's earlier columns: a warp a column, lanes
      // over this block's rows, then every block sums the blocks in order
      for (int jj = warp; jj < ii; jj += nwarp) {
        double acc = 0.0;
        for (int rl = lane; rl < rows; rl += 32)
          acc += Ps[rl * kPanel + jj] * Ps[rl * kPanel + ii];
        acc = warp_sum(acc);
        if (lane == 0) o.part_d[blk * kPanel + jj] = acc;
      }
      grid_sync(o.bar, o.target);
      for (int jj = warp; jj < ii; jj += nwarp) {
        double acc = 0.0;
        for (int b = lane; b < nblk; b += 32) acc += ld_cg(o.part_d + b * kPanel + jj);
        acc = warp_sum(acc);
        if (lane == 0) coef[jj] = acc;
      }
      __syncthreads();
      for (int rl = tid; rl < rows; rl += blockDim.x) {
        double acc = 0.0;
        for (int jj = 0; jj < ii; ++jj) acc += Ps[rl * kPanel + jj] * coef[jj];
        Ps[rl * kPanel + ii] -= acc;
      }
    }
    if (p0 + ii > 0) {
      double m = 0.0;
      for (int rl = tid; rl < rows; rl += blockDim.x)
        m = fmax(m, fabs(Ps[rl * kPanel + ii]));
      m = block_max(m, red);
      if (tid == 0) o.part_m[blk] = m;
      grid_sync(o.bar, o.target);
      if (warp == 0) {
        double v = 0.0;
        for (int b = lane; b < nblk; b += 32) v = fmax(v, ld_cg(o.part_m + b));
        v = warp_max(v);
        if (lane == 0) bc[0] = fmax(v, kTiny);
      }
      __syncthreads();
      m = bc[0];
      double ss = 0.0;
      for (int rl = tid; rl < rows; rl += blockDim.x) {
        const double x = Ps[rl * kPanel + ii] / m;
        ss += x * x;
      }
      ss = block_sum(ss, red);
      if (tid == 0) o.part_s[blk] = ss;
      grid_sync(o.bar, o.target);
      if (warp == 0) {
        double v = 0.0;
        for (int b = lane; b < nblk; b += 32) v += ld_cg(o.part_s + b);
        v = warp_sum(v);
        if (lane == 0) bc[1] = fmax(m * sqrt(v), kTiny);
      }
      __syncthreads();
      const double nrm = bc[1];
      for (int rl = tid; rl < rows; rl += blockDim.x) Ps[rl * kPanel + ii] /= nrm;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < rows * w; idx += blockDim.x) {
    const int rl = idx / w, q = idx % w;
    Zb[(size_t)rl * s + p0 + q] = Ps[rl * kPanel + q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kOrthThreads)
invit_orth_kernel(double* __restrict__ Z, const int* __restrict__ cid,
                  double* __restrict__ scr, unsigned int* bar, int n, int s,
                  int rpb) {
  extern __shared__ double Ps[];  // rpb x kPanel
  __shared__ double red[33];
  __shared__ double coef[kPanel];
  __shared__ double bc[2];
  const int nblk = gridDim.x;
  Orth o;
  o.Z = Z;
  o.cid = cid;
  o.bar = bar;
  o.target = 0;
  o.n = n;
  o.s = s;
  o.r0 = min(n, blockIdx.x * rpb);
  o.rows = min(n, o.r0 + rpb) - o.r0;
  o.part_col = scr;
  o.col_m = o.part_col + (size_t)nblk * s;
  o.col_n = o.col_m + s;
  o.part_c = o.col_n + s;
  o.Cm = o.part_c + (size_t)nblk * s * kPanel;
  o.part_d = o.Cm + (size_t)s * kPanel;
  o.part_m = o.part_d + (size_t)nblk * kPanel;
  o.part_s = o.part_m + nblk;

  normalize_columns_grid(o, false);
  bool singles = false;
  for (int c = 1; c < s && !singles; ++c) singles = singleton_past_first(cid, c, s);
  if (singles) normalize_columns_grid(o, true);
  int c0 = 0;
  for (int p0 = 0; p0 < s;) {
    if (p0 > 0 && cid[p0] != cid[p0 - 1]) c0 = p0;
    int c1 = p0 + 1;
    while (c1 < s && cid[c1] == cid[c0]) ++c1;
    const int p1 = min(c1, p0 + kPanel);
    if (c1 - c0 > 1) orth_panel(o, c0, p0, p1, Ps, red, coef, bc);
    p0 = p1;
  }
}

}  // namespace

extern "C" {

// lam (s,) and, if sweeps is not null, the sweep each index stopped at
// (int32, s); a team of 2^levels threads an index, per_block teams a block.
int tridiag_bisect_sturm(const void* d, const void* e2, const void* ks,
                         const void* scal, void* lam, void* sweeps, int n,
                         int s, int max_iters, int levels, int per_block,
                         int flags, void* stream) {
  if (n < 0 || s < 1 || levels < 1 || levels > kBisMaxLevels || per_block < 1 ||
      (per_block << levels) > kBisMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int threads = per_block << levels;
  const int blocks = (s + per_block - 1) / per_block;
  const size_t shm = levels > 5 ? threads * sizeof(int) : 0;
  bisect_sturm_kernel<<<blocks, threads, shm, (cudaStream_t)stream>>>(
      (const double*)d, (const double*)e2, (const int64_t*)ks,
      (const double*)scal, (double*)lam, (int*)sweeps, n, s, max_iters,
      levels, per_block, (flags & kBisStop) != 0);
  return (int)cudaGetLastError();
}

// Z (n, s) row-major in place; W the (n, s, 4) solve scratch.
int tridiag_invit_solve(const void* d, const void* e, const void* lam,
                        const void* piv, void* Z, void* W, int n, int s,
                        void* stream) {
  const int blocks = (s + kSolveLanes - 1) / kSolveLanes;
  invit_solve_kernel<<<blocks, kSolveLanes, 0, (cudaStream_t)stream>>>(
      (const double*)d, (const double*)e, (const double*)lam,
      (const double*)piv, (double*)Z, (double2*)W, n, s);
  return (int)cudaGetLastError();
}

// doubles of invit_orth's scratch for ``blocks`` blocks and s columns
long long tridiag_invit_orth_scratch(int blocks, int s) {
  return (long long)blocks * s * (1 + kPanel) + (long long)s * (2 + kPanel) +
         (long long)blocks * (kPanel + 2);
}

// The Gram-Schmidt round on Z (n, s) row-major in place, one cooperative
// launch of ``blocks`` blocks of rpb rows each (the wrapper's plan); bar is
// one zeroed counter, scr ``scratch`` doubles.
int tridiag_invit_orth(void* Z, const void* cid, void* scr, long long scratch,
                       void* bar, int n, int s, int blocks, int rpb,
                       void* stream) {
  if (blocks < 1 || (long long)blocks * rpb < n ||
      scratch < tridiag_invit_orth_scratch(blocks, s))
    return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)rpb * kPanel * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      invit_orth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, invit_orth_kernel,
                                                      kOrthThreads, shm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&Z, (void*)&cid, &scr, &bar, &n, &s, &rpb};
  err = cudaLaunchCooperativeKernel((const void*)invit_orth_kernel, dim3(blocks),
                                    dim3(kOrthThreads), args, shm,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
