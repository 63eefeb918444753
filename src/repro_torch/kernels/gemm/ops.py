"""Dispatch for the tiled product: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor, and nothing in between — a failed
build or launch raises, it never gives way to the plain version.

The reference zero-pads every operand to its tile multiples
(``gemm/ops.py:29-33``); that is TPU tiling and is gone: the kernel masks
the ragged edge itself. A B of another layout than row-major is copied
once (the kernel reads A transposed in place, but not B).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launches

from . import kernel, ref


def _fp64(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float64:
            raise NotImplementedError(
                f"gemm in {t.dtype} is not ported yet (ROADMAP.md §1 item "
                f"8: the bf16 path with fp32 accumulation); the port runs "
                f"torch.float64")


def _note(A: torch.Tensor, B: torch.Tensor, bm, bn, bk) -> None:
    # the kernel's launches for this product: its plan's (a split K adds
    # the reduce pass), none for an empty output
    if _launches.recording_active():
        m, k = A.shape
        n = B.shape[1]
        _launches.note("gemm", k=kernel.plan(m, n, k, bm, bn, bk).launches
                       if m and n else 0)


def _operands(A: torch.Tensor, B: torch.Tensor):
    if kernel.layout(A) is None:
        A = A.contiguous()
    lb = kernel.layout(B)
    if lb is None or lb[0]:
        B = B.contiguous()
    return A, B


def gemm(A: torch.Tensor, B: torch.Tensor, bm: int | None = None,
         bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """C = A @ B; ``bm``, ``bn``, ``bk`` override the CUDA kernel's plan
    (``kernel.plan``: the output tile of a block and the K it covers);
    ``None`` leaves them to the planner."""
    _fp64(A, B)
    _note(A, B, bm, bn, bk)
    if A.device.type == "cpu":
        return ref.gemm_ref(A, B)
    A, B = _operands(A, B)
    return kernel.gemm(A, B, bm=bm, bn=bn, bk=bk)


def gemm_accum(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               alpha: float = 1.0, bm: int | None = None,
               bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """C += alpha A @ B in place (C row-major, a view of a larger matrix
    included); returns C."""
    _fp64(C, A, B)
    _note(A, B, bm, bn, bk)
    if C.device.type == "cpu":
        return C.copy_(ref.gemm_accum_ref(C, A, B, alpha))
    A, B = _operands(A, B)
    return kernel.gemm(A, B, out=C, alpha=alpha, accumulate=True, bm=bm,
                       bn=bn, bk=bk)


__all__ = ["gemm", "gemm_accum"]
