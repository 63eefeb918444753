"""Plain PyTorch versions of the tiled matrix product."""
from __future__ import annotations

import torch


def gemm_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B."""
    return A @ B


def gemm_accum_ref(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   alpha: float = 1.0) -> torch.Tensor:
    """C + alpha * A @ B (the trailing-update and block-update form)."""
    return C + alpha * (A @ B)


__all__ = ["gemm_ref", "gemm_accum_ref"]
