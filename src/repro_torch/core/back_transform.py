"""BT1 — back-transform from standard to generalized eigenvectors."""
from __future__ import annotations

import torch


def back_transform_generalized(U: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """BT1: X = U^{-1} Y, the final map from STDEIG to GSYEIG eigenvectors."""
    return torch.linalg.solve_triangular(U, Y, upper=True)


def forward_transform_generalized(U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = U X (inverse of BT1)."""
    return torch.triu(U) @ X
