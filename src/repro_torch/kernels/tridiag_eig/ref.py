"""Plain PyTorch versions of the two TD2 kernels, on the kernels' inputs.

``bisect_sturm_ref`` repeats the exact interval sequence of the reference
``bisect_eigenvalues`` (same Gershgorin start, same ``mid = 0.5 (lo+hi)``
splits, same pivmin-clamped Sturm recurrence in the same op order), so the
CUDA kernel, compiled without FMA contraction, agrees with it bitwise.

``invit_ref`` is the TPU kernel's round: the pivoted tridiagonal solve for
every shift, max-abs-rescaled column norms, then Gram-Schmidt within
clusters. The CUDA kernel sums its reductions in another order, so the two
agree to rounding, not bitwise.

The CPU tests use these; on the card only ``chip_smoke.py``'s comparison
runs them (on CPU copies of the kernels' inputs).
"""
from __future__ import annotations

import torch

from repro_torch.core.tridiag_eig import (_gttrf_gtts2, _mgs_clustered,
                                         normalize_columns, sturm_counts)


def bisect_sturm_ref(d: torch.Tensor, e2: torch.Tensor, ks: torch.Tensor,
                     scal: torch.Tensor, max_iters: int = 80) -> torch.Tensor:
    """Eigenvalues of tridiag(d, e) at indices ``ks``.

    ``e2 = [0, e*e]`` (n,); ``scal = [lo0, hi0, pivmin]`` (3,). Returns
    lam (s,)."""
    lo0, hi0, piv = scal.tolist()
    lo = torch.full(ks.shape, lo0, dtype=d.dtype, device=d.device)
    hi = torch.full(ks.shape, hi0, dtype=d.dtype, device=d.device)
    for _ in range(max_iters):
        mid = 0.5 * (lo + hi)
        go_right = sturm_counts(d, e2, mid, piv) <= ks
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def invit_ref(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
              cid: torch.Tensor, pivmin: torch.Tensor, X0: torch.Tensor,
              iters: int = 3) -> torch.Tensor:
    """Eigenvectors for SORTED shifts ``lam`` (s,) from the column-normalized
    start block ``X0`` (n, s); ``cid`` (s,) int cluster ids, ``pivmin`` a
    0-d tensor. Returns Z (n, s)."""
    piv = float(pivmin)
    Z = X0
    for _ in range(iters):
        Z = _gttrf_gtts2(d, e, lam, Z, piv)
        Z = normalize_columns(Z)
        Z = _mgs_clustered(Z, cid)
    return Z


__all__ = ["bisect_sturm_ref", "invit_ref"]
