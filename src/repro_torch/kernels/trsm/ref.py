"""Plain PyTorch versions of the blocked triangular solve.

``trsm_tile_ref`` is the plain version of the tile kernel: a row-by-row
substitution, as the reference kernel's loop runs. ``blocked_solve`` is
the blocked schedule of ``repro/kernels/trsm/ops.py`` (backward over the
block rows for U X = B, forward for U^T X = B; the product update, then
the diagonal tile), written once for both the kernels and the plain
versions; ``trsm_blocked_ref`` runs it with the plain ones on any device.
``trsm_ref`` is the library solve the tests hold both against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.ref import gemm_ref


def trsm_ref(U: torch.Tensor, B: torch.Tensor,
             trans: bool = False) -> torch.Tensor:
    """Solve U^T X = B (``trans``) or U X = B, U upper triangular."""
    vec = B.dim() == 1
    Bm = B[:, None] if vec else B
    if trans:
        X = torch.linalg.solve_triangular(U.mT, Bm, upper=False)
    else:
        X = torch.linalg.solve_triangular(U, Bm, upper=True)
    return X[:, 0] if vec else X


def trsm_tile_ref(U: torch.Tensor, B: torch.Tensor,
                  trans: bool = False) -> torch.Tensor:
    """One (b, b) upper-triangular tile: X (b, s) with U X = B (back
    substitution) or U^T X = B (forward substitution), row by row."""
    b = U.shape[0]
    X = torch.empty_like(B)
    if trans:
        for i in range(b):
            X[i] = (B[i] - U[:i, i] @ X[:i]) / U[i, i]
    else:
        for i in range(b - 1, -1, -1):
            X[i] = (B[i] - U[i, i + 1:] @ X[i + 1:]) / U[i, i]
    return X


def blocked_solve(U: torch.Tensor, X: torch.Tensor, trans: bool, block: int,
                  tile, update) -> torch.Tensor:
    """The reference's blocked schedule, in place on X (n, s), whose rows
    hold B on entry. ``tile(U_kk, X_k, trans)`` solves a diagonal tile in
    place; ``update(X_k, A, X_j)`` subtracts A X_j from X_k in place."""
    n = X.shape[0]
    blocks = [(k0, min(k0 + block, n)) for k0 in range(0, n, block)]
    if trans:
        # forward over block rows: U^T is lower triangular
        for k0, k1 in blocks:
            if k0 > 0:
                update(X[k0:k1], U[:k0, k0:k1].mT, X[:k0])
            tile(U[k0:k1, k0:k1], X[k0:k1], True)
    else:
        # backward over block rows
        for k0, k1 in reversed(blocks):
            if k1 < n:
                update(X[k0:k1], U[k0:k1, k1:], X[k1:])
            tile(U[k0:k1, k0:k1], X[k0:k1], False)
    return X


def _tile_ref(U, Xk, trans):
    Xk.copy_(trsm_tile_ref(U, Xk, trans))


def _update_ref(Xk, A, Xj):
    Xk.sub_(gemm_ref(A, Xj))


def trsm_blocked_ref(U: torch.Tensor, B: torch.Tensor, trans: bool = False,
                     block: int = 128) -> torch.Tensor:
    """The blocked solve on the plain tile solve and product; B (n,) or
    (n, s)."""
    vec = B.dim() == 1
    Bm = B[:, None] if vec else B
    n = Bm.shape[0]
    X = torch.empty(Bm.shape, dtype=B.dtype, device=B.device).copy_(Bm)
    if n:
        blocked_solve(U, X, trans, min(block, n), _tile_ref, _update_ref)
    return X[:, 0] if vec else X


__all__ = ["trsm_ref", "trsm_tile_ref", "blocked_solve", "trsm_blocked_ref"]
