"""GS1 — Cholesky factorization B = U^T U (upper factor).

``torch.linalg.cholesky`` raises on a matrix that is not SPD, where JAX's
returns NaN rows that the health sentinel reads. ``cholesky_ex`` reports
the breakdown in ``info`` instead; ``cholesky_upper`` turns a nonzero
``info`` into the same all-NaN factor, on the device and without a host
sync, so ``resilience.health.chol_health`` catches it as in the reference.
The blocked factorization comes later (ROADMAP.md §1 item 4).
"""
from __future__ import annotations

import torch


def cholesky_upper(B: torch.Tensor) -> torch.Tensor:
    """Return upper-triangular U with B = U^T U (all NaN on breakdown)."""
    L, info = torch.linalg.cholesky_ex(B)
    return torch.where(info == 0, L.mT, float("nan"))


def diag_shifted(B: torch.Tensor, tau: float) -> torch.Tensor:
    """B + tau * max|diag B| * I — the GS1 breakdown-recovery shift."""
    scale = torch.max(torch.abs(torch.diagonal(B)))
    out = B.clone()
    torch.diagonal(out).add_(tau * scale)
    return out
