"""Precision policy of the port: the fp64 row of ``repro.core.precision``.

The mixed (fp32) and fast (bf16) levels are not ported yet
(ROADMAP.md §1 item 8); asking for them raises instead of running fp64.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp64", "mixed", "fast")


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision != "fp64":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP.md §1 "
            f"item 8); the port runs precision='fp64' only")
    return precision


def compute_dtype(precision: str) -> torch.dtype:
    """Storage/compute dtype of the pipeline's stages."""
    validate_precision(precision)
    return torch.float64


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stage GEMM: a plain ``@`` in fp64 (the reference's fp64 row;
    its demoted rows accumulate in fp32 and come with item 8)."""
    return a @ b


def ensure_strong(x, device) -> torch.Tensor:
    """The working dtype on the target device: float64 on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)
