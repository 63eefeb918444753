"""Precision policy of the solver pipeline (``repro.core.precision`` in
torch).

Three levels, threaded as ``precision=`` through ``gsyeig.solve``:

  ``fp64``  — every stage in float64 (the default)
  ``mixed`` — the GEMM-heavy stages in IEEE float32 (never TF32)
  ``fast``  — the GEMM-heavy stages in bfloat16, accumulated in float32

Only the GEMM-heavy stages demote: the TT1 panel sweep and its SYR2K
updates, the TT2 rotation wavefront, the TT4 back-transform, the KE/KI
operator, and TD1/TD3. Cholesky, the standard form, the tridiagonal
eigensolve and all convergence and residual math stay float64, and
``core.refinement`` restores fp64 accuracy of the returned eigenpairs
against the original pencil. ``declared_downcasts`` lists the demotions
each level may introduce.
"""
from __future__ import annotations

from typing import Tuple

import torch

PRECISIONS = ("fp64", "mixed", "fast")

_COMPUTE = {"fp64": torch.float64, "mixed": torch.float32,
            "fast": torch.bfloat16}
# bf16 products accumulate in fp32; fp32 and fp64 accumulate in kind
_ACC = {"fp64": torch.float64, "mixed": torch.float32, "fast": torch.float32}
_DECLARED = {
    "fp64": (),
    "mixed": ("float64->float32",),
    "fast": ("float64->bfloat16", "float64->float32"),
}
_REFINE_STEPS = {"fp64": 0, "mixed": 8, "fast": 16}


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def compute_dtype(precision: str) -> torch.dtype:
    """Storage and compute dtype of the demoted GEMM-heavy stages."""
    return _COMPUTE[validate_precision(precision)]


def acc_dtype(precision: str) -> torch.dtype:
    """Accumulation dtype of reduced-precision contractions."""
    return _ACC[validate_precision(precision)]


def compute_eps(precision: str) -> float:
    return float(torch.finfo(compute_dtype(precision)).eps)


def declared_downcasts(precision: str) -> Tuple[str, ...]:
    return _DECLARED[validate_precision(precision)]


def default_refine_steps(precision: str) -> int:
    """The reference's fixed refinement step counts (for its batched
    pipelines): enough sweeps to land below the 1e-12 Table-3 bars from
    fp32 (bf16) pipeline output on its benchmark matrix."""
    return _REFINE_STEPS[validate_precision(precision)]


def demote(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.to(compute_dtype(precision))


def promote(x: torch.Tensor, dtype: torch.dtype = torch.float64
            ) -> torch.Tensor:
    return x.to(dtype)


def ensure_strong(x, device) -> torch.Tensor:
    """The working dtype on the target device: float64 on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def check_fp32_matmul(precision: str) -> None:
    """``mixed`` means IEEE fp32: TF32 products would drop ~10 bits of
    every fp32 stage, so a demoted solve refuses to run with the flag on."""
    if precision != "fp64" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"precision={precision!r} needs IEEE float32 products; "
            f"torch.backends.cuda.matmul.allow_tf32 is True")


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation for bf16 operands (the result back
    in ``a``'s dtype); fp32 and fp64 products in kind."""
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b
