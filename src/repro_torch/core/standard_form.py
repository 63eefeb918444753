"""GS2 — reduction of the generalized problem to standard form.

C := U^{-T} A U^{-1}   (so A x = lambda B x  <=>  C y = lambda y, y = U x)

Two variants, as in the reference (the paper's Sec. 2.1):
  * ``to_standard_two_trsm`` — two triangular solves, 2 n^3 flops (the
    DTRSM path the paper found faster), on the library solve;
  * ``to_standard_sygst``    — the blocked two-sided reduction exploiting
    symmetry, ~n^3 flops (the DSYGST path), on the port's block kernels:
    ``trsm`` for the triangular solves, ``gemm`` for the half-updates and
    ``syr2k`` (symmetrized, in place) for the trailing update.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.ops import gemm_accum
from repro_torch.kernels.syr2k.ops import syr2k
from repro_torch.kernels.trsm.ops import trsm

from .linalg_utils import symmetrize


def to_standard_two_trsm(A: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """C = U^{-T} A U^{-1} via two TRSMs (2 n^3 flops)."""
    Ut = U.mT
    # W = U^{-T} A : solve U^T W = A
    W = torch.linalg.solve_triangular(Ut, A, upper=False)
    # C = W U^{-1} : U^T C^T = W^T
    C = torch.linalg.solve_triangular(Ut, W.mT, upper=False).mT
    return symmetrize(C)


def _sygs2(Akk: torch.Tensor, Ukk: torch.Tensor) -> torch.Tensor:
    """Unblocked diagonal-block reduction: U_kk^{-T} A_kk U_kk^{-1}."""
    W = trsm(Ukk, Akk, trans=True)
    return symmetrize(trsm(Ukk, W.mT, trans=True).mT)


def to_standard_sygst(A: torch.Tensor, U: torch.Tensor,
                      block: int = 256) -> torch.Tensor:
    """Blocked DSYGST (itype=1, upper): C = U^{-T} A U^{-1} in ~n^3 flops.

    LAPACK-style blocked sweep; per block k (ranges [k0, k1), trailing
    t = [k1, n)), in place on one copy of A:
        A_kk   <- U_kk^{-T} A_kk U_kk^{-1}
        A_k,t  <- U_kk^{-T} A_k,t
        A_k,t  <- A_k,t - 1/2 A_kk U_k,t
        A_t,t  <- A_t,t - U_k,t^T A_k,t - A_k,t^T U_k,t     (SYR2K)
        A_k,t  <- A_k,t - 1/2 A_kk U_k,t
        A_k,t  <- A_k,t U_tt^{-1}
    """
    n = A.shape[0]
    M = A.clone(memory_format=torch.contiguous_format)
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        Ukk = U[k0:k1, k0:k1]
        Ckk = _sygs2(M[k0:k1, k0:k1], Ukk)
        M[k0:k1, k0:k1] = Ckk
        if k1 < n:
            Ukt = U[k0:k1, k1:]
            row = trsm(Ukk, M[k0:k1, k1:], trans=True)
            gemm_accum(row, Ckk, Ukt, alpha=-0.5)
            # SYR2K trailing update, then (R + R^T)/2 — one launch, in place
            Mtt = M[k1:, k1:]
            syr2k(Mtt, Ukt.mT, row.mT, alpha=-1.0, symmetrize=True, out=Mtt)
            gemm_accum(row, Ckk, Ukt, alpha=-0.5)
            # row <- row U_tt^{-1}: U_tt^T row^T = row^T
            row = trsm(U[k1:, k1:], row.mT, trans=True).mT
            M[k0:k1, k1:] = row
            M[k1:, k0:k1] = row.mT
    return symmetrize(M)
