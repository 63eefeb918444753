"""Plain PyTorch versions of the symmetric band matrix-vector product.

Band storage: ``band`` is (n, w+1); band[i, d] = A[i, i+d] for d = 0..w
(upper diagonals; symmetric A implied). Entries past the matrix edge are
ignored. (The TT pipeline's (w+1, n) lower band is the transpose:
``core.band_storage.to_band_mv_layout``.)
"""
from __future__ import annotations

import torch


def band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """The dense symmetric (n, n) matrix of (n, w+1) band storage."""
    n, wp1 = band.shape
    A = band.new_zeros((n, n))
    for d in range(min(wp1, n)):
        diag = band[: n - d, d]
        A += torch.diag(diag, d)
        if d > 0:
            A += torch.diag(diag, -d)
    return A


def dense_to_band(A: torch.Tensor, w: int) -> torch.Tensor:
    """(n, w+1) band storage of the upper diagonals 0..w of A, zero past
    the edge."""
    n = A.shape[0]
    band = A.new_zeros((n, w + 1))
    for d in range(min(w, n - 1) + 1):
        band[: n - d, d] = torch.diagonal(A, offset=d)
    return band


def band_mv_ref(band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x through the dense matrix."""
    return band_to_dense(band) @ x


__all__ = ["band_to_dense", "dense_to_band", "band_mv_ref"]
