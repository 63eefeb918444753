"""Operators of the Krylov variants.

  * ExplicitC — KE: y = C w (one symmetric product, 2 n^2 flops)
  * ImplicitC — KI: y = U^{-T}(A(U^{-1} w)) (two triangular solves around
    the symmetric product, 4 n^2)

``use_kernel=True`` routes the symmetric product through
``kernels/symv/ops.py`` (the one-triangle CUDA kernel for a CUDA tensor,
its plain version for a CPU tensor); ``False`` is ``torch.matmul`` on the
full matrix, the plain product XLA computes in the reference. The
triangular solves stay library calls, as the reference leaves them to XLA.

An operator may hold fp32 or bf16 matrices (the demoted Krylov operator
of ``precision="mixed"``/``"fast"``): the product then runs in that dtype,
bf16 accumulated in fp32 (``precision.matmul_acc`` off the kernel path),
and a bf16 triangular solve runs in fp32 and rounds its result to bf16.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from .precision import matmul_acc


class ExplicitC(NamedTuple):
    C: torch.Tensor


class ImplicitC(NamedTuple):
    A: torch.Tensor
    U: torch.Tensor


Operator = Union[ExplicitC, ImplicitC]


def _symm(M: torch.Tensor, w: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """y = M w for a vector or an (n, p) block, in one product."""
    if use_kernel:
        from repro_torch.kernels.symv import ops as symv_ops
        if w.dim() == 1:
            return symv_ops.symv(M, w)
        return symv_ops.symm_block(M, w)
    return matmul_acc(M, w)


def _solve_upper(U: torch.Tensor, w: torch.Tensor, trans: bool) -> torch.Tensor:
    """U^{-1} w (``trans`` False) or U^{-T} w (True), reading only the upper
    triangle of U; w is (n,) or (n, p)."""
    W = w.unsqueeze(-1) if w.dim() == 1 else w
    dtype = W.dtype
    if dtype == torch.bfloat16:
        U, W = U.float(), W.float()
    if trans:
        out = torch.linalg.solve_triangular(U.mT, W, upper=False)
    else:
        out = torch.linalg.solve_triangular(U, W, upper=True)
    out = out.to(dtype)
    return out.squeeze(-1) if w.dim() == 1 else out


def apply_op(op: Operator, w: torch.Tensor,
             use_kernel: bool = False) -> torch.Tensor:
    """One operator application: KE1, or KI1-KI3. ``w`` is (n,) or an
    (n, p) Lanczos block."""
    if isinstance(op, ExplicitC):
        return _symm(op.C, w, use_kernel)
    if isinstance(op, ImplicitC):
        wbar = _solve_upper(op.U, w, trans=False)      # KI1: U^{-1} w
        what = _symm(op.A, wbar, use_kernel)           # KI2: A wbar
        return _solve_upper(op.U, what, trans=True)    # KI3: U^{-T} what
    raise TypeError(f"unknown operator {type(op)}")


def op_dim(op: Operator) -> int:
    if isinstance(op, ExplicitC):
        return op.C.shape[0]
    return op.A.shape[0]


def matvecs_per_apply(op: Operator) -> int:
    """Bookkeeping for the stage tables: flop-equivalent 2 n^2 units."""
    return 1 if isinstance(op, ExplicitC) else 2


__all__ = ["ExplicitC", "ImplicitC", "Operator", "apply_op", "op_dim",
           "matvecs_per_apply"]
