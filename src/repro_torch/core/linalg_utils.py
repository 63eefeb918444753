"""Dense helpers of the TD pipeline (``repro.core.linalg_utils``).

Plain tensor code, no host synchronisation: the Householder reflector
keeps its ``safe`` branch as a ``torch.where`` so the TD1 loop never waits
on the card. The compact-WY and Givens helpers come with the TT slice.
"""
from __future__ import annotations

import torch


def symmetrize(M: torch.Tensor) -> torch.Tensor:
    """Return (M + M^T)/2 — used after two-sided updates to kill drift."""
    return 0.5 * (M + M.mT)


def householder_masked(x: torch.Tensor, pivot: int):
    """Householder reflector for the tail x[pivot:] of a full-length vector.

    Entries at indices < pivot are ignored; the returned v is full-length
    with v[pivot] = 1 and zeros before ``pivot``. Returns (v, tau, beta),
    ``tau``/``beta`` as 0-d tensors. Both guards of the reference stay: the
    pivot read is clipped to the last index, and a negative ``sigma`` from
    cancellation is clamped to 0 (the last TD1 steps give NaN without it).
    """
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    xm = torch.where(idx >= pivot, x, 0.0)
    alpha = x[min(pivot, n - 1)]
    sigma = torch.sum(xm * xm) - alpha * alpha
    sigma = torch.clamp_min(sigma, 0.0)
    safe = sigma > 0.0
    norm_x = torch.sqrt(alpha * alpha + sigma)
    sgn = torch.where(alpha >= 0.0, 1.0, -1.0).to(x.dtype)
    beta = torch.where(safe, -sgn * norm_x, alpha)
    denom = torch.where(safe, alpha - beta, 1.0)
    unit = (idx == pivot).to(x.dtype)
    v = torch.where(idx > pivot, xm / denom, unit)
    v = torch.where(safe, v, unit)
    tau = torch.where(safe, (beta - alpha) / beta, 0.0)
    return v, tau, beta


def extract_tridiag(M: torch.Tensor):
    """Return (d, e): diagonal and first subdiagonal of M."""
    return torch.diagonal(M).clone(), torch.diagonal(M, -1).clone()


def gershgorin_bounds(d: torch.Tensor, e: torch.Tensor):
    """Eigenvalue bounds for the symmetric tridiagonal (d, e), as 0-d
    tensors on d's device."""
    ea = torch.abs(e)
    zero = torch.zeros((1,), dtype=d.dtype, device=d.device)
    radius = torch.cat([zero, ea]) + torch.cat([ea, zero])
    lo = torch.min(d - radius)
    hi = torch.max(d + radius)
    span = torch.clamp_min(hi - lo, torch.finfo(d.dtype).tiny)
    return lo - 1e-3 * span, hi + 1e-3 * span


def eigh_or_nan(M: torch.Tensor):
    """``torch.linalg.eigh`` of a symmetric M, with JAX's answer to a
    non-finite input: NaN eigenvalues (torch raises instead, which would
    turn a poisoned Lanczos state into an exception rather than the
    health verdict). The check stays on the device."""
    finite = torch.isfinite(M).all()
    w, V = torch.linalg.eigh(torch.where(finite, M, torch.zeros_like(M)))
    return torch.where(finite, w, float("nan")), V
