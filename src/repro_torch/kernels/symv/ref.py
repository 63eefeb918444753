"""Plain PyTorch versions of the one-triangle symmetric product.

Like the CUDA kernel, they read only the upper triangle of A: whatever
the strictly lower triangle holds does not reach the result. The CPU
tests use them; on the card only ``chip_smoke.py``'s comparison runs them
(on CPU copies of the kernel's inputs).
"""
from __future__ import annotations

import torch


def symv_upper_ref(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for symmetric A (n, n), from its upper triangle; x (n,)."""
    return torch.triu(A) @ x + torch.triu(A, 1).mT @ x


def symm_block_upper_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for symmetric A (n, n), from its upper triangle; X (n, p)."""
    return torch.triu(A) @ X + torch.triu(A, 1).mT @ X


__all__ = ["symv_upper_ref", "symm_block_upper_ref"]
