"""Plain PyTorch versions of the one-triangle symmetric product.

Like the CUDA kernel, they read only the upper triangle of A: whatever
the strictly lower triangle holds does not reach the result. The CPU
tests use them; on the card only ``chip_smoke.py``'s comparison runs them
(on CPU copies of the kernel's inputs). Below fp64 they compute in fp32
(the product's sums; bf16 operands widen exactly) and round the result
to the operands' dtype, as the kernel's reduced instances do; the sums
run in another order than the kernel's, so the two agree within
gamma_n(fp32) |A||X| before that rounding.
"""
from __future__ import annotations

import torch


def symm_block_upper_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for symmetric A (n, n), from its upper triangle; X (n, p)
    (or a vector)."""
    if A.dtype == torch.float64:
        return torch.triu(A) @ X + torch.triu(A, 1).mT @ X
    Af, Xf = A.float(), X.float()
    return (torch.triu(Af) @ Xf + torch.triu(Af, 1).mT @ Xf).to(A.dtype)


def symv_upper_ref(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for symmetric A (n, n), from its upper triangle; x (n,)."""
    return symm_block_upper_ref(A, x)


__all__ = ["symv_upper_ref", "symm_block_upper_ref"]
