"""Distributed BLAS-2/3 building blocks over a (rows x 'model') mesh.

The reference's ``repro.dist.sharded_la`` as SPMD code on
``torch.distributed`` (``mesh.Tiling``: row blocks over the merged row
axes, column blocks over 'model'):

  * ``dist_symv`` / ``dist_gemm``: each rank multiplies its (rows, cols)
    tile, one ``all_reduce`` over 'model' finishes its row block; the
    ``*_rs`` forms ``reduce_scatter`` it instead, so the result stays split
    over (rows, 'model');
  * ``dist_syr2k``, ``dist_panel_matmul`` and the compact-WY updates are
    row-local against replicated (n, w) panels: no collective;
  * ``band_sweep`` is the TT1 sweep on row-block storage: per panel one
    all-gather of the (nloc, w) panel, the ``house_panel`` kernel
    replicated, one all-reduce of the (w, w) coupling and one all-gather
    of Z;
  * ``chol_rows``, ``trsm_left_t_rows`` and ``trsm_left_rows`` are the
    blocked Cholesky and the block forward and backward substitutions on
    row-block storage, which the reference leaves to GSPMD: each diagonal
    block is factored or solved on the rank that owns its rows and
    broadcast over the row group; the trailing and substitution updates
    are local GEMMs. Panels are ``_panel``'s size, split where a row
    block ends, so that one rank owns each.

The public ``dist_*`` functions take and return whole (replicated)
tensors, as the reference's accept plain arrays: each rank slices its
tiles, and the result is gathered. The solvers use the ``*_rows`` forms
and keep their operands in row blocks between stages. Any n works: short
row blocks are padded for the gathers.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.cholesky import cholesky_upper
from repro_torch.core.precision import matmul_acc
from repro_torch.core.sbr import _n_panels
from repro_torch.kernels.house_panel.ops import house_panel

from .mesh import Tiling, tiling

_solve_tri = torch.linalg.solve_triangular


def _reduce_scatter_rows(tl: Tiling, y: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``psum_scatter(.., 'model', tiled=True)`` of this
    rank's row block y (of n rows in all): the row block, padded to
    ceil(n / R) rows and then to a multiple of cm, reduced over 'model'
    and cut in cm pieces, of which this rank keeps piece c."""
    import torch.distributed as dist

    if tl.model_group is None:
        return y
    size = -(-n // tl.R)
    piece = -(-size // tl.cm)
    pad = piece * tl.cm - y.shape[0]
    w = tl._wire(torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
                 if pad else y)
    out = torch.empty((piece,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.reduce_scatter(out, list(w.split(piece)), group=tl.model_group)
    tl.counts["reduce_scatter"] += 1
    return out.to(y.dtype)


def _gather_rs(tl: Tiling, piece: torch.Tensor, n: int) -> torch.Tensor:
    """The whole (n, ...) result from every rank's ``_reduce_scatter_rows``
    piece, gathered over the mesh (row block-major, 'model' index minor)."""
    if tl.model_group is None:
        return tl.gather_rows(piece, n)
    full = tl.all_gather(piece, tl.mesh_group)
    size = -(-n // tl.R)
    tail = tuple(full.shape[1:])
    return full.reshape((tl.R, -1) + tail)[:, :size].reshape(
        (-1,) + tail)[:n]


# ------------------------------------------------------------- matvec -----

def dist_symv(mesh, A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x with A split (rows x 'model'): one all_reduce over 'model'
    a call (and the gather of the replicated y)."""
    tl = tiling(mesh)
    n = A.shape[0]
    (r0, r1), (c0, c1) = tl.rows(n), tl.cols(n)
    y = tl.all_reduce(A[r0:r1, c0:c1] @ x[c0:c1], tl.model_group)
    return tl.gather_rows(y, n)


def dist_symv_rs(mesh, A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dist_symv`` with the all_reduce replaced by a reduce_scatter: the
    result is split over (rows, 'model') before its gather."""
    tl = tiling(mesh)
    n = A.shape[0]
    (r0, r1), (c0, c1) = tl.rows(n), tl.cols(n)
    piece = _reduce_scatter_rows(tl, A[r0:r1, c0:c1] @ x[c0:c1], n)
    return _gather_rs(tl, piece, n)


# --------------------------------------------------------------- gemm -----

def dist_gemm(mesh, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = A B with A split (rows x 'model') and B's rows over 'model' (the
    contraction axis): a local tile product and one all_reduce."""
    tl = tiling(mesh)
    n, k = A.shape
    (r0, r1), (c0, c1) = tl.rows(n), tl.cols(k)
    y = tl.all_reduce(A[r0:r1, c0:c1] @ B[c0:c1], tl.model_group)
    return tl.gather_rows(y, n)


def dist_gemm_rs(mesh, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``dist_gemm`` with a row-wise reduce_scatter in place of the
    all_reduce."""
    tl = tiling(mesh)
    n, k = A.shape
    (r0, r1), (c0, c1) = tl.rows(n), tl.cols(k)
    piece = _reduce_scatter_rows(tl, A[r0:r1, c0:c1] @ B[c0:c1], n)
    return _gather_rs(tl, piece, n)


# ------------------------------------------------------- row-local ops -----

def dist_syr2k(mesh, C: torch.Tensor, V: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """C - V W^T - W V^T with C in row blocks and the (n, w) panels
    replicated: each rank updates its rows, no collective."""
    tl = tiling(mesh)
    n = C.shape[0]
    r0, r1 = tl.rows(n)
    out = C[r0:r1] - V[r0:r1] @ W.mT - W[r0:r1] @ V.mT
    return tl.gather_rows(out, n)


def dist_panel_matmul(mesh, C: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """X = C V with C in row blocks and V a replicated (n, w) panel."""
    tl = tiling(mesh)
    n = C.shape[0]
    r0, r1 = tl.rows(n)
    return tl.gather_rows(matmul_acc(C[r0:r1], V), n)


def dist_apply_wy_two_sided(mesh, C: torch.Tensor, V: torch.Tensor,
                            T: torch.Tensor) -> torch.Tensor:
    """Q^T C Q for symmetric C, Q = I - V T V^T, in the SYR2K form: with
    X = C V and S = T^T (V^T X) T, Q^T C Q = C - Z V^T - V Z^T where
    Z = X T - (1/2) V S. One panel matmul and one ``dist_syr2k``; the
    (w, w) couplings are replicated."""
    X = dist_panel_matmul(mesh, C, V)
    S = T.mT @ (V.mT @ X) @ T
    Z = X @ T - 0.5 * (V @ S)
    return dist_syr2k(mesh, C, V, Z)


def dist_apply_wy_right(mesh, M: torch.Tensor, V: torch.Tensor,
                        T: torch.Tensor) -> torch.Tensor:
    """M Q = M - ((M V) T) V^T for M in row blocks (the explicit Q1
    accumulation of the band reduction): two local GEMMs a row block."""
    tl = tiling(mesh)
    n = M.shape[0]
    r0, r1 = tl.rows(n)
    m = M[r0:r1]
    return tl.gather_rows(m - ((m @ V) @ T) @ V.mT, n)


# ------------------------------------------------------- band sweep ---------

def _sub_product(M: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """M -= a @ b in place (a bf16 product accumulated in fp32)."""
    if M.dtype == torch.bfloat16:
        M -= matmul_acc(a, b)
    else:
        M.addmm_(a, b, alpha=-1.0)


def band_sweep(tl: Tiling, M_loc: torch.Tensor, Q_loc: torch.Tensor, n: int,
               w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """TT1 on row-block storage: (W_loc, Q_loc) with W = Q1^T C Q1 band-
    masked (|i - j| > w zeroed, the triangles not yet averaged) and the
    explicit Q1, from this rank's rows of C (``M_loc``) and of I
    (``Q_loc``). n must be a multiple of the row-block count
    (``eigensolver.dist_reduce_to_band`` pads). Per panel: one all-gather
    of the (nloc, w) panel, the ``house_panel`` kernel on it replicated,
    one all-reduce of the (w, w) coupling V^T X, one all-gather of Z; the
    trailing update and the Q1 accumulation are local GEMMs. Products of
    bf16 operands accumulate in fp32 (``matmul_acc``); the coupling and Z
    travel at fp32."""
    if n % tl.R:
        raise ValueError(f"band_sweep needs n ({n}) divisible by the row "
                         f"blocks ({tl.R})")
    r0, r1 = tl.rows(n)
    M, Q = M_loc.clone(), Q_loc.clone()
    mm = matmul_acc
    for k in range(_n_panels(n, w)):
        c0 = k * w
        E = tl.all_gather(M[:, c0:c0 + w].contiguous(), tl.row_group)
        V, T = house_panel(E, c0 + w)
        X = mm(M, V)                                     # (nloc, w)
        V_blk = V[r0:r1]
        W_c = tl.all_reduce(mm(V_blk.mT, X), tl.row_group)
        S = mm(mm(T.mT, W_c), T)
        Z_blk = mm(X, T) - 0.5 * mm(V_blk, S)
        Z = tl.all_gather(Z_blk, tl.row_group)
        _sub_product(M, Z_blk, V.mT)
        _sub_product(M, V_blk, Z.mT)
        _sub_product(Q, mm(mm(Q, V), T), V.mT)
    gi = torch.arange(r0, r1, device=M.device)[:, None]
    far = torch.abs(gi - torch.arange(n, device=M.device)[None, :]) > w
    return M.masked_fill(far, 0.0), Q


# ------------------------------------------- panel factorizations -----------

def _panel(tl: Tiling, n: int, block) -> int:
    """The reference's panel: ``block``, or one per row block clamped to
    [16, 1024]."""
    if block is not None:
        return int(block)
    return max(min(n // max(tl.R, 1), 1024), 16)


def _owned_panels(tl: Tiling, n: int, block: int) -> List[Tuple[int, int,
                                                                 int]]:
    """(k0, k1, owner) of the panels of ``block`` rows, each split where a
    row block ends so that one row block (``owner``) holds it."""
    size = -(-n // tl.R)
    out = []
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        while k0 < k1:
            owner = k0 // size
            end = min(k1, (owner + 1) * size)
            out.append((k0, end, owner))
            k0 = end
    return out


def chol_rows(tl: Tiling, B_loc: torch.Tensor, n: int,
              block=None) -> torch.Tensor:
    """GS1: this rank's rows of the upper U with B = U^T U, from its rows
    of B (right-looking blocked Cholesky). Per panel the owner factors the
    diagonal block (all NaN on breakdown, ``cholesky_upper``) and solves
    the block row, one broadcast ships both, and every rank updates its
    trailing rows."""
    r0, r1 = tl.rows(n)
    M = B_loc.clone()
    U = torch.zeros_like(M)
    for k0, k1, owner in _owned_panels(tl, n, _panel(tl, n, block)):
        buf = M.new_empty((k1 - k0, n - k0))
        if owner == tl.r:
            P = M[k0 - r0:k1 - r0, k0:]
            Ukk = cholesky_upper(P[:, :k1 - k0])
            buf[:, :k1 - k0] = Ukk
            buf[:, k1 - k0:] = _solve_tri(Ukk.mT, P[:, k1 - k0:],
                                          upper=False)
        buf = tl.broadcast(buf, tl.rank_of(owner), tl.row_group)
        if owner == tl.r:
            U[k0 - r0:k1 - r0, k0:] = buf
        lo = max(r0, k1)
        if lo < r1:
            row = buf[:, k1 - k0:]                       # (kb, n - k1)
            M[lo - r0:, k1:] -= row[:, lo - k1:r1 - k1].mT @ row
    return U


def trsm_left_t_rows(tl: Tiling, U_loc: torch.Tensor, B_loc: torch.Tensor,
                     n: int, block=None) -> torch.Tensor:
    """GS2/BT: this rank's rows of W with U^T W = B (U upper), by block
    forward substitution: the owner solves the diagonal block and
    broadcasts [W_k | U_k,t], every rank updates its later rows."""
    r0, r1 = tl.rows(n)
    R = B_loc.clone()
    W = torch.zeros_like(R)
    ncol = R.shape[1]
    for k0, k1, owner in _owned_panels(tl, n, _panel(tl, n, block)):
        buf = R.new_empty((k1 - k0, ncol + n - k1))
        if owner == tl.r:
            Ukk = U_loc[k0 - r0:k1 - r0, k0:k1]
            buf[:, :ncol] = _solve_tri(Ukk.mT, R[k0 - r0:k1 - r0],
                                       upper=False)
            buf[:, ncol:] = U_loc[k0 - r0:k1 - r0, k1:]
        buf = tl.broadcast(buf, tl.rank_of(owner), tl.row_group)
        if owner == tl.r:
            W[k0 - r0:k1 - r0] = buf[:, :ncol]
        lo = max(r0, k1)
        if lo < r1:
            Ukt = buf[:, ncol + lo - k1:ncol + r1 - k1]  # (kb, my rows)
            R[lo - r0:] -= Ukt.mT @ buf[:, :ncol]
    return W


def trsm_left_rows(tl: Tiling, U_loc: torch.Tensor, Y_loc: torch.Tensor,
                   n: int, block=None) -> torch.Tensor:
    """BT1: this rank's rows of X with U X = Y (U upper), by block backward
    substitution: the owner solves the diagonal block and broadcasts X_k,
    every rank updates its earlier rows with its own columns of U."""
    r0, r1 = tl.rows(n)
    R = Y_loc.clone()
    X = torch.zeros_like(R)
    for k0, k1, owner in reversed(_owned_panels(tl, n,
                                                _panel(tl, n, block))):
        buf = R.new_empty((k1 - k0, R.shape[1]))
        if owner == tl.r:
            Ukk = U_loc[k0 - r0:k1 - r0, k0:k1]
            buf[:] = _solve_tri(Ukk, R[k0 - r0:k1 - r0], upper=True)
        buf = tl.broadcast(buf, tl.rank_of(owner), tl.row_group)
        if owner == tl.r:
            X[k0 - r0:k1 - r0] = buf
        hi = min(r1, k0)
        if r0 < hi:
            R[:hi - r0] -= U_loc[:hi - r0, k0:k1] @ buf
    return X


def dist_cholesky(mesh, B: torch.Tensor, block=None) -> torch.Tensor:
    """GS1: the upper U with B = U^T U, distributed over row blocks."""
    tl = tiling(mesh)
    n = B.shape[0]
    r0, r1 = tl.rows(n)
    return tl.gather_rows(chol_rows(tl, B[r0:r1], n, block), n)


def dist_trsm_left_t(mesh, U: torch.Tensor, B: torch.Tensor,
                     block=None) -> torch.Tensor:
    """GS2/BT: W with U^T W = B (U upper), distributed over row blocks."""
    tl = tiling(mesh)
    n = U.shape[0]
    r0, r1 = tl.rows(n)
    return tl.gather_rows(
        trsm_left_t_rows(tl, U[r0:r1], B[r0:r1], n, block), n)


def dist_trsm_left(mesh, U: torch.Tensor, B: torch.Tensor,
                   block=None) -> torch.Tensor:
    """BT1: X with U X = B (U upper), distributed over row blocks."""
    tl = tiling(mesh)
    n = U.shape[0]
    r0, r1 = tl.rows(n)
    return tl.gather_rows(trsm_left_rows(tl, U[r0:r1], B[r0:r1], n, block),
                          n)


__all__ = ["dist_symv", "dist_symv_rs", "dist_gemm", "dist_gemm_rs",
           "dist_syr2k", "dist_panel_matmul", "dist_apply_wy_two_sided",
           "dist_apply_wy_right", "band_sweep", "chol_rows",
           "trsm_left_t_rows", "trsm_left_rows", "dist_cholesky",
           "dist_trsm_left_t", "dist_trsm_left"]
