"""Accuracy metrics — the two quantities of the paper's Tables 3/7.

  orth  = || I - X^T B X ||_F / || B ||_F
  resid = || A X - B X Lambda ||_F / max(||A||_F, ||B||_F)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AccuracyReport(NamedTuple):
    b_orthogonality: torch.Tensor
    relative_residual: torch.Tensor


def b_orthogonality(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    s = X.shape[1]
    G = X.mT @ (B @ X)
    eye = torch.eye(s, dtype=X.dtype, device=X.device)
    return torch.linalg.norm(G - eye) / torch.linalg.norm(B)


def relative_residual(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                      lam: torch.Tensor) -> torch.Tensor:
    R = A @ X - (B @ X) * lam[None, :]
    denom = torch.maximum(torch.linalg.norm(A), torch.linalg.norm(B))
    return torch.linalg.norm(R) / denom


def accuracy_report(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                    lam: torch.Tensor) -> AccuracyReport:
    return AccuracyReport(b_orthogonality=b_orthogonality(X, B),
                          relative_residual=relative_residual(A, B, X, lam))


def b_normalize(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Scale columns of X to unit B-norm (x^T B x = 1)."""
    nrm2 = torch.einsum("is,is->s", X, B @ X)
    nrm = torch.sqrt(torch.clamp_min(nrm2, torch.finfo(X.dtype).tiny))
    return X / nrm[None, :]
