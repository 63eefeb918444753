"""GS1 — Cholesky factorization B = U^T U (upper factor).

Two paths, as in the reference:
  * ``cholesky_upper``  — the library's fused factorization (the paper's
    DPOTRF analogue);
  * ``cholesky_blocked`` — the right-looking blocked algorithm (the
    PLASMA analogue) on the port's block kernels: per block a factor of
    the diagonal block, a triangular solve of the block row (``trsm``)
    and the SYRK trailing update (``gemm``).

``torch.linalg.cholesky`` raises on a matrix that is not SPD, where JAX's
returns NaN rows that the health sentinel reads. ``cholesky_ex`` reports
the breakdown in ``info`` instead; ``cholesky_upper`` turns a nonzero
``info`` into the same all-NaN factor, on the device and without a host
sync, so ``resilience.health.chol_health`` catches it as in the reference.
``cholesky_blocked`` factors each diagonal block that way, so a breakdown
leaves NaN from that block on, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.ops import gemm_accum
from repro_torch.kernels.trsm.ops import trsm


def cholesky_upper(B: torch.Tensor) -> torch.Tensor:
    """Return upper-triangular U with B = U^T U (all NaN on breakdown)."""
    L, info = torch.linalg.cholesky_ex(B)
    return torch.where(info == 0, L.mT, float("nan"))


def diag_shifted(B: torch.Tensor, tau: float) -> torch.Tensor:
    """B + tau * max|diag B| * I — the GS1 breakdown-recovery shift."""
    scale = torch.max(torch.abs(torch.diagonal(B)))
    out = B.clone()
    torch.diagonal(out).add_(tau * scale)
    return out


def cholesky_blocked(B: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Right-looking blocked Cholesky (upper factor), B = U^T U.

    for k in blocks:
        U_kk  = chol(B_kk)
        U_k,: = U_kk^{-T} B_k,:          (triangular solve on the block row)
        B_t,t = B_t,t - U_k,:^T U_k,:    (SYRK trailing update)

    Works in place on one copy of B: the factor fills its upper triangle
    (the strictly lower part, left stale, is cut off at the end).
    """
    n = B.shape[0]
    M = B.clone(memory_format=torch.contiguous_format)
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        Ukk = cholesky_upper(M[k0:k1, k0:k1])
        M[k0:k1, k0:k1] = Ukk
        if k1 < n:
            row = trsm(Ukk, M[k0:k1, k1:], trans=True)
            M[k0:k1, k1:] = row
            gemm_accum(M[k1:, k1:], row.mT, row, alpha=-1.0)
    return torch.triu(M)
