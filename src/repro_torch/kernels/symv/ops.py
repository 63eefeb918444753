"""Dispatch for the one-triangle product: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor, and nothing in between — a
failed build or launch raises, it never gives way to the plain version.

The reference pads A to its block multiple on every call and p to 128
lanes; that is TPU tiling and is gone: the kernel takes n and p as they
are and masks the ragged edge itself, so a matvec never copies A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launches

from . import kernel, ref


def symv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for symmetric A, from its upper triangle; x (n,)."""
    _launches.note("symv", A.dtype, k=int(A.shape[0] > 0))
    if A.device.type == "cpu":
        return ref.symv_upper_ref(A, x)
    return kernel.symv(A, x)


def symm_block(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for symmetric A, from its upper triangle; X (n, p)."""
    _launches.note("symm_block", A.dtype, k=int(X.numel() > 0))
    if A.device.type == "cpu":
        return ref.symm_block_upper_ref(A, X)
    return kernel.symm_block(A, X)


__all__ = ["symv", "symm_block"]
