"""GS2 — reduction of the generalized problem to standard form.

C := U^{-T} A U^{-1}, by two triangular solves (2 n^3 flops, the DTRSM
path of the paper). The blocked DSYGST form comes later (ROADMAP.md §1
item 4).
"""
from __future__ import annotations

import torch

from .linalg_utils import symmetrize


def to_standard_two_trsm(A: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """C = U^{-T} A U^{-1} via two TRSMs (2 n^3 flops)."""
    Ut = U.mT
    # W = U^{-T} A : solve U^T W = A
    W = torch.linalg.solve_triangular(Ut, A, upper=False)
    # C = W U^{-1} : U^T C^T = W^T
    C = torch.linalg.solve_triangular(Ut, W.mT, upper=False).mT
    return symmetrize(C)
