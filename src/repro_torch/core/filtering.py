"""Chebyshev polynomial filtering of the Lanczos start block.

Clustered spectra stall the plain restart loop, so before iterating the
block is multiplied by a degree-d Chebyshev polynomial of the operator that
damps the unwanted end (Zhou, Saad, Tiago, Chelikowsky). The spectral
bounds come from a k-step single-vector Lanczos probe: with Ritz values
theta_1 <= ... <= theta_k and last residual norm beta_k, the interval
[theta_1 - beta_k, theta_k + beta_k] encloses the spectrum up to the
probe's accuracy, and the cutoff sits at the probe's s-th Ritz value.
The three-term sigma recurrence keeps the iterates O(1) at the wanted end.

The arithmetic follows ``repro.core.filtering`` operation for operation.
The interval ends stay 0-d tensors on the operator's device, so neither
the probe nor the filter waits for the card.
"""
from __future__ import annotations

import torch

from .linalg_utils import eigh_or_nan


def probe_steps(s: int, n: int) -> int:
    """Length of the bound-estimation probe: enough Ritz values to place
    the cutoff above the s wanted ones, capped by the dimension."""
    return int(min(max(2 * s, 12), n - 1))


def probe_matrix(matvec, v: torch.Tensor, k: int):
    """The k-step probe up to its ``eigh``: (T_k symmetrized, beta_k).

    ``matvec`` takes (n, p) blocks (p=1 here)."""
    from .lanczos import _segment_impl  # late import: lanczos imports us

    n = v.shape[0]
    V = torch.zeros((n, k + 1), dtype=v.dtype, device=v.device)
    V[:, 0] = v / torch.linalg.vector_norm(v)
    T = torch.zeros((k + 1, k + 1), dtype=v.dtype, device=v.device)
    V, T, B_q = _segment_impl(matvec, V, T, 0, p=1)
    return 0.5 * (T[:k, :k] + T[:k, :k].mT), torch.abs(B_q[0, 0])


def estimate_bounds(matvec, v: torch.Tensor, k: int):
    """k-step single-vector Lanczos probe -> (theta (k,) ascending, beta_k)."""
    Tk, beta_k = probe_matrix(matvec, v, k)
    theta, _ = eigh_or_nan(Tk)
    return theta, beta_k


def filter_interval(theta: torch.Tensor, beta_k: torch.Tensor, s: int,
                    which: str):
    """(a, b, a0): damp [a, b], normalize at the wanted-end bound a0.

    which='SA': wanted low end -> damp [cutoff, hi]; 'LA' mirrors it. The
    cutoff is the probe's s-th Ritz value from the wanted end, clipped 5%
    inside the safeguarded interval so the damped window is never empty.
    """
    k = theta.shape[0]
    lo = theta[0] - beta_k
    hi = theta[-1] + beta_k
    margin = 0.05 * (hi - lo)
    if which == "SA":
        cut = torch.clamp(theta[min(s, k - 1)], lo + margin, hi - margin)
        return cut, hi, lo
    cut = torch.clamp(theta[k - 1 - min(s, k - 1)], lo + margin, hi - margin)
    return lo, cut, hi


def chebyshev_filter(matvec, X: torch.Tensor, degree: int, a, b, a0):
    """Degree-d scaled Chebyshev filter of the block X: damps [a, b],
    amplifies toward a0 (the wanted end). Each iterate is rescaled so its
    value at a0 stays 1."""
    if degree <= 0:
        return X
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    d0 = a0 - c
    # keep the normalization point strictly outside the damped interval
    tiny = torch.finfo(X.dtype).tiny
    d0 = torch.where(torch.abs(d0) < e * 1e-8,
                     torch.where(d0 < 0, -e * 1e-8, e * 1e-8) + tiny, d0)
    sigma1 = e / d0
    Y = (matvec(X) - c * X) * (sigma1 / e)
    Xp, sig = X, sigma1
    for _ in range(1, degree):
        sig_new = 1.0 / (2.0 / sigma1 - sig)
        Yn = (matvec(Y) - c * Y) * (2.0 * sig_new / e) - (sig * sig_new) * Xp
        Xp, Y, sig = Y, Yn, sig_new
    return Y


__all__ = ["probe_steps", "probe_matrix", "estimate_bounds",
           "filter_interval", "chebyshev_filter"]
