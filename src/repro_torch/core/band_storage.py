"""Compact symmetric band storage (LAPACK lower 'SB' convention).

Packed layout: a symmetric matrix A of bandwidth w is stored as a
``(w + 1, n)`` tensor with

    band[d, i] = A[i + d, i],   d = 0..w  (main + lower diagonals),

entries past the matrix edge (``i + d >= n``) are zero. The TT pipeline's
intermediate lives in it between TT1 (``core.sbr.reduce_to_band``) and
the TT2 bulge chase: O(n w) memory instead of O(n^2).

``kernels/band_mv`` of the reference keeps the transposed ``(n, w+1)``
upper layout (``bm[i, d] = A[i, i+d]``); for symmetric matrices the two
are each other's transpose (``to_band_mv_layout`` /
``from_band_mv_layout``).
"""
from __future__ import annotations

import torch


def pack_band(A: torch.Tensor, w: int, symmetrize: bool = False
              ) -> torch.Tensor:
    """Pack the (main + w lower) diagonals of ``A`` into (w+1, n) storage.

    With ``symmetrize=True`` each packed diagonal is the average of the
    corresponding lower and upper diagonal of ``A``.
    """
    n = A.shape[-1]
    band = A.new_zeros(A.shape[:-2] + (w + 1, n))
    for d in range(min(w, n - 1) + 1):
        lo = torch.diagonal(A, offset=-d, dim1=-2, dim2=-1)
        if symmetrize and d > 0:
            lo = 0.5 * (lo + torch.diagonal(A, offset=d, dim1=-2, dim2=-1))
        band[..., d, : n - d] = lo
    return band


def unpack_band(band: torch.Tensor) -> torch.Tensor:
    """Expand (w+1, n) packed storage back to the dense symmetric (n, n):
    ``A[i, j] = band[|i-j|, min(i, j)]`` within the band, zero outside."""
    wp1, n = band.shape[-2], band.shape[-1]
    idx = torch.arange(n, device=band.device)
    dd = torch.abs(idx[:, None] - idx[None, :])
    vals = band[..., torch.clamp(dd, 0, wp1 - 1),
                torch.minimum(idx[:, None], idx[None, :])]
    return torch.where(dd < wp1, vals, 0.0)


def clean_band(band: torch.Tensor) -> torch.Tensor:
    """Zero the out-of-range tail entries (``i + d >= n``) of packed storage."""
    wp1, n = band.shape[-2], band.shape[-1]
    d = torch.arange(wp1, device=band.device)[:, None]
    i = torch.arange(n, device=band.device)[None, :]
    return torch.where(i + d < n, band, 0.0)


def band_extract_tridiag(band: torch.Tensor):
    """Return (d, e) — the main and first sub-diagonal of packed storage."""
    n = band.shape[-1]
    return band[..., 0, :], band[..., 1, : n - 1]


def to_band_mv_layout(band: torch.Tensor) -> torch.Tensor:
    """(w+1, n) lower-packed -> the (n, w+1) upper layout of ``band_mv``.

    For symmetric A, ``bm[i, d] = A[i, i+d] = A[(i+d), i] = band[d, i]``:
    the conversion is a transpose.
    """
    return band.transpose(-1, -2)


def from_band_mv_layout(bm: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_band_mv_layout`."""
    return bm.transpose(-1, -2)


__all__ = ["pack_band", "unpack_band", "clean_band", "band_extract_tridiag",
           "to_band_mv_layout", "from_band_mv_layout"]
