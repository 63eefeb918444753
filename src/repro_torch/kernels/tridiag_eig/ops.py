"""Dispatch for the TD2 pair: the CUDA kernels for a CUDA tensor, the plain
PyTorch versions for a CPU tensor, and nothing in between — a failed
build or launch raises, it never gives way to the plain version.

The reference's (8, 128) row and lane padding is TPU tiling and is gone:
the kernels take n and s as they are.
"""
from __future__ import annotations

import torch

from repro_torch.core.tridiag_eig import (_gttrf_gtts2, _mgs_clustered,
                                         bisect_inputs, inverse_iteration,
                                         normalize_columns)
from . import kernel, ref


def bisect_sturm(d: torch.Tensor, e: torch.Tensor, ks: torch.Tensor,
                 max_iters: int = 80) -> torch.Tensor:
    """Eigenvalues at indices ``ks`` (any order) by Sturm bisection."""
    e2, scal = bisect_inputs(d, e)
    ks = ks.to(device=d.device, dtype=torch.int64).contiguous()
    if d.device.type == "cpu":
        return ref.bisect_sturm_ref(d, e2, ks, scal, max_iters=max_iters)
    return kernel.bisect_sturm(d.contiguous(), e2, ks, scal,
                               max_iters=max_iters)


def invit_batched(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                  cid: torch.Tensor, pivmin: torch.Tensor, X0: torch.Tensor,
                  iters: int = 3) -> torch.Tensor:
    """Eigenvectors for SORTED shifts ``lam`` from the column-normalized
    start block ``X0``."""
    if d.device.type == "cpu":
        return ref.invit_ref(d, e, lam, cid, pivmin, X0, iters=iters)
    return kernel.invit(d.contiguous(), e.contiguous(), lam.contiguous(),
                        cid.to(torch.int32).contiguous(), pivmin,
                        X0.contiguous(), iters=iters)


def invit_solve(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                pivmin: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One inverse-iteration round's solve: column j of X (n, s) through
    (T - lam_j I)^{-1}, each column on its own (the spectrum-partitioned
    TT3 solves its slice of the shifts with it). Returns a new tensor."""
    if d.device.type == "cpu":
        return _gttrf_gtts2(d, e, lam, X, float(pivmin))
    return kernel.invit_solve(d.contiguous(), e.contiguous(),
                              lam.contiguous(), pivmin,
                              X.clone(memory_format=torch.contiguous_format))


def invit_orth(Z: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """One round's normalization and Gram-Schmidt within the clusters
    ``cid`` of the whole block Z (n, s). Returns a new tensor."""
    if Z.device.type == "cpu":
        return _mgs_clustered(normalize_columns(Z), cid)
    return kernel.invit_orth(Z.clone(memory_format=torch.contiguous_format),
                             cid.to(torch.int32).contiguous())


def tridiag_eig_kernel(d: torch.Tensor, e: torch.Tensor, ks: torch.Tensor,
                       x0: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       max_iters: int = 80, iters: int = 3):
    """All of TD2 for SORTED ``ks``: bisection, then inverse iteration."""
    lam = bisect_sturm(d, e, ks, max_iters=max_iters)
    Z = inverse_iteration(d, e, lam, x0=x0, generator=generator, iters=iters)
    return lam, Z


__all__ = ["bisect_sturm", "invit_batched", "invit_solve", "invit_orth",
           "tridiag_eig_kernel"]
