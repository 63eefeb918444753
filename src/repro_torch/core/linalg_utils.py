"""Dense helpers of the TD pipeline (``repro.core.linalg_utils``).

Plain tensor code, no host synchronisation: the Householder reflector
keeps its ``safe`` branch as a ``torch.where`` so the TD1 loop never waits
on the card. The compact-WY and Givens helpers serve the TT pipeline
(``core.sbr``).
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import matmul_acc


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


def qr_wy_masked(E: torch.Tensor, row_start: int) -> tuple:
    """Householder QR of the sub-panel E[row_start:, :] in fixed shapes.

    E is full-height (n, w); reflector j pivots at row ``row_start + j`` and
    only touches rows >= row_start. Returns (V, T, R) with V (n, w) masked
    (zeros above the pivot rows), T (w, w), R = Q^T E (full height: rows
    above row_start pass through unchanged).
    """
    n, w = E.shape
    V = E.new_zeros((n, w))
    T = E.new_zeros((w, w))
    R = E
    for j in range(w):
        v, tau, _ = householder_masked(R[:, j], row_start + j)
        R = R - tau * torch.outer(v, v @ R)
        V[:, j] = v
        if j > 0:
            z = V[:, :j].mT @ v
            T[:j, j] = -tau * (T[:j, :j] @ z)
        T[j, j] = tau
    return V, T, R


def wy_syr2k_panel(C: torch.Tensor, V: torch.Tensor,
                   T: torch.Tensor) -> torch.Tensor:
    """The Z panel of the SYR2K-form two-sided update (LAPACK DSYRDB).

    With X = C V and S = T^T (V^T X) T (symmetric because C is),

        Q^T C Q = C - Z V^T - V Z^T,   Z = X T - (1/2) V S,

    so the two-sided compact-WY update is ONE rank-2w SYR2K against the
    (n, w) panels (V, Z).
    """
    mm = matmul_acc
    X = mm(C, V)
    S = mm(mm(T.mT, mm(V.mT, X)), T)
    return mm(X, T) - 0.5 * mm(V, S)


def apply_wy_two_sided_syr2k(C: torch.Tensor, V: torch.Tensor,
                             T: torch.Tensor) -> torch.Tensor:
    """Q^T C Q for symmetric C via the SYR2K form (see `wy_syr2k_panel`)."""
    Z = wy_syr2k_panel(C, V, T)
    return symmetrize(C - matmul_acc(Z, V.mT) - matmul_acc(V, Z.mT))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device. torch's CPU sqrt
    is off by an ulp on ~1% of float64 inputs; numpy's, like the card's,
    is IEEE-rounded, so CPU tensors take it (a copy-free round trip)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def givens(a: torch.Tensor, b: torch.Tensor):
    """Return (c, s) with c*a + s*b = r, -s*a + c*b = 0; the identity
    (1, 0) when a = b = 0. Elementwise over tensors of any shape; the
    same bits on the CPU as on the card (``sqrt_rn``, no FMA)."""
    r = sqrt_rn(a * a + b * b)
    safe = r > 0.0
    rr = torch.where(safe, r, 1.0)
    c = torch.where(safe, a / rr, 1.0)
    s = torch.where(safe, b / rr, 0.0)
    return c, s


def rotate_rows(M: torch.Tensor, p: int, q: int, c, s) -> torch.Tensor:
    """Rows p, q of M <- (c*row_p + s*row_q, -s*row_p + c*row_q), IN PLACE;
    returns M."""
    row_p, row_q = M[p, :].clone(), M[q, :].clone()
    M[p, :] = c * row_p + s * row_q
    M[q, :] = -s * row_p + c * row_q
    return M


def rotate_cols(M: torch.Tensor, p: int, q: int, c, s) -> torch.Tensor:
    """Cols p, q of M <- (c*col_p + s*col_q, -s*col_p + c*col_q), IN PLACE;
    returns M."""
    col_p, col_q = M[:, p].clone(), M[:, q].clone()
    M[:, p] = c * col_p + s * col_q
    M[:, q] = -s * col_p + c * col_q
    return M


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


def eigh_input(M: torch.Tensor):
    """(finite, operand): whether M is finite, and the matrix
    ``eigh_or_nan`` decomposes (M, or zeros where M is not finite)."""
    finite = torch.isfinite(M).all()
    return finite, torch.where(finite, M, torch.zeros_like(M))


def eigh_output(finite: torch.Tensor, w: torch.Tensor, V: torch.Tensor):
    """``eigh_or_nan``'s result from the ``eigh`` of ``eigh_input``'s
    operand: NaN eigenvalues where the input was not finite."""
    return torch.where(finite, w, float("nan")), V


def eigh_or_nan(M: torch.Tensor):
    """``torch.linalg.eigh`` of a symmetric M, with JAX's answer to a
    non-finite input: NaN eigenvalues (torch raises instead, which would
    turn a poisoned Lanczos state into an exception rather than the
    health verdict). The check stays on the device; the ``eigh`` itself
    reads its ``info`` on the host, so ``core.batched`` runs it between
    two CUDA graphs (``eigh_input``/``eigh_output`` are its two sides)."""
    finite, Mc = eigh_input(M)
    w, V = torch.linalg.eigh(Mc)
    return eigh_output(finite, w, V)
