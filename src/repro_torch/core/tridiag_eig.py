"""TD2 — symmetric tridiagonal eigensolver for s << n wanted pairs.

The same O(ns) pair as ``repro.core.tridiag_eig``: Sturm-count bisection
for the eigenvalues, then shifted inverse iteration with a pivoted
tridiagonal LU (DGTTRF-style) and cluster-wise reorthogonalization
(DSTEIN-style) for the vectors.

The building blocks here are plain PyTorch. ``bisect_eigenvalues`` and
``inverse_iteration`` go through ``kernels.tridiag_eig.ops``, which runs
the CUDA kernels for a CUDA tensor and these plain versions for a CPU
tensor.

Norms are max-abs rescaled everywhere, as in the TPU kernel: a solve at a
converged shift returns columns near 1/pivmin (~1e292), whose naive sum of
squares overflows — ``torch.linalg.vector_norm``, ``np.linalg.norm`` and
``jnp.linalg.norm`` all return inf there. The JAX ``inverse_iteration``
uses the naive norm; where the two differ, this module follows the kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg_utils import gershgorin_bounds

#: default seed of the inverse-iteration start block when no ``x0`` is given
START_SEED = 12021


def _pivmin(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    scale = _scale(d, e)
    scale = torch.clamp_min(scale, 1.0)
    fi = torch.finfo(d.dtype)
    return (fi.tiny / fi.eps) * scale


def _scale(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    s = torch.max(torch.abs(d))
    if e.numel():
        s = torch.maximum(s, torch.max(torch.abs(e)))
    return s


def _clamp(q: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """Pivmin clamp away from zero, sign-preserving (DSTEBZ / DGTTRF).

    The reference's ``where(|q| < piv, where(q < 0, -piv, piv), q)`` in
    fewer launches, with the same value for every q (-0.0 goes to +piv,
    NaN stays NaN). ``piv`` is a 0-d tensor of q's dtype."""
    return torch.where(q < 0, torch.minimum(q, -piv), torch.maximum(q, piv))


def sturm_counts(d: torch.Tensor, e2: torch.Tensor, xs: torch.Tensor,
                 pivmin: float) -> torch.Tensor:
    """Number of eigenvalues of tridiag(d, e) strictly below each shift in
    ``xs``, with ``e2 = [0, e*e]``. The pivmin-clamped recurrence runs down
    the rows in the reference's op order, vectorised across the shifts.

    Every division has a tensor numerator: ``float / tensor`` is computed
    by torch as a multiplication by the reciprocal, which rounds
    differently and breaks the bitwise agreement."""
    piv = torch.tensor(pivmin, dtype=xs.dtype, device=xs.device)
    q = torch.ones_like(xs)
    cnt = torch.zeros(xs.shape, dtype=torch.int64, device=xs.device)
    for di, ei2 in zip(d.tolist(), e2.unbind()):
        # (d_i - x) - e2_i / clamp(q), rounded as written
        q = torch.addcdiv(di - xs, ei2, _clamp(q, piv), value=-1.0)
        cnt += q < 0
    return cnt


def sturm_count(d: torch.Tensor, e: torch.Tensor, x: float) -> int:
    """Number of eigenvalues of tridiag(d, e) strictly below the scalar x."""
    e2 = torch.cat([torch.zeros((1,), dtype=d.dtype, device=d.device), e * e])
    xs = torch.full((1,), x, dtype=d.dtype, device=d.device)
    return int(sturm_counts(d, e2, xs, float(_pivmin(d, e)))[0])


def bisect_inputs(d: torch.Tensor, e: torch.Tensor) -> tuple:
    """(e2, scal) for the bisection: ``e2 = [0, e*e]`` and the (3,) tensor
    ``[lo0, hi0, pivmin]`` — the Gershgorin interval and the clamp."""
    lo0, hi0 = gershgorin_bounds(d, e)
    zero = torch.zeros((1,), dtype=d.dtype, device=d.device)
    e2 = torch.cat([zero, e * e])
    return e2, torch.stack([lo0, hi0, _pivmin(d, e)])


def bisect_eigenvalues(d: torch.Tensor, e: torch.Tensor, ks: torch.Tensor,
                       max_iters: int = 80) -> torch.Tensor:
    """k-th smallest eigenvalues, 0-indexed by the int tensor ``ks`` (any
    order: each lane bisects its own index)."""
    from repro_torch.kernels.tridiag_eig.ops import bisect_sturm
    return bisect_sturm(d, e, ks, max_iters=max_iters)


def _gttrf_gtts2(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                 b: torch.Tensor, pivmin: float) -> torch.Tensor:
    """Solve (T - lam_j I) x_j = b_j for every column j, with partial
    pivoting (DGTTRF + DGTTS2); pivots clamped away from zero so that a
    solve at a converged eigenvalue stays finite.

    ``lam`` is (s,), ``b`` (n, s). The row loops run in the TPU kernel's
    order — factorization fused with the forward substitution, then the
    reversed back substitution — vectorised across the shifts.
    """
    n = b.shape[0]
    piv = torch.tensor(pivmin, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    if n == 1:
        diag = d[0] - lam
        return (b[0] / torch.where(torch.abs(diag) < pivmin, pivmin, diag))[None]
    dl = d.tolist()
    el = e.tolist() + [0.0]
    # 0-d tensors for the numerators and divisors (see ``sturm_counts``)
    et = list(_clamp(e, piv).unbind())
    en = list(e.unbind())
    D = torch.empty_like(b)
    DU = torch.empty_like(b)
    DU2 = torch.empty_like(b)
    Y = torch.empty_like(b)
    dcur = dl[0] - lam
    ducur = torch.full_like(lam, el[0])
    bcur = b[0]
    for i in range(n - 1):
        dl_i = el[i]
        dnext = dl[i + 1] - lam
        dunext = el[i + 1]
        b_next = b[i + 1]
        no_swap = torch.abs(dcur) >= abs(dl_i)
        fact_ns = en[i] / _clamp(dcur, piv)
        fact_sw = dcur / et[i]
        D[i] = torch.where(no_swap, dcur, dl_i)
        DU[i] = torch.where(no_swap, ducur, dnext)
        DU2[i] = torch.where(no_swap, zero, dunext)
        L_i = torch.where(no_swap, fact_ns, fact_sw)
        dcur, ducur = (torch.where(no_swap, dnext - fact_ns * ducur,
                                   ducur - fact_sw * dnext),
                       torch.where(no_swap, dunext, -fact_sw * dunext))
        Y[i] = torch.where(no_swap, bcur, b_next)
        bcur = torch.where(no_swap, b_next - L_i * bcur, bcur - L_i * b_next)
    D[n - 1] = dcur
    DU[n - 1] = 0.0
    DU2[n - 1] = 0.0
    Y[n - 1] = bcur
    Dsafe = _clamp(D, piv)
    X = torch.empty_like(b)
    x1 = torch.zeros_like(lam)
    x2 = torch.zeros_like(lam)
    for i in range(n - 1, -1, -1):
        x_i = (Y[i] - DU[i] * x1 - DU2[i] * x2) / Dsafe[i]
        X[i] = x_i
        x1, x2 = x_i, x1
    return X


def _cluster_ids(lam: torch.Tensor, scale) -> torch.Tensor:
    """DSTEIN-style clustering: eigenvalues closer than 1e-3*scale share a
    group (int32 ids, ascending)."""
    gaps = torch.diff(lam)
    new_cluster = (gaps > 1e-3 * scale).to(torch.int32)
    zero = torch.zeros((1,), dtype=torch.int32, device=lam.device)
    return torch.cat([zero, torch.cumsum(new_cluster, 0).to(torch.int32)])


def rescaled_norm(X: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """2-norm along ``dim`` computed as ``m * sqrt(sum((x/m)^2))`` with
    ``m = max(max|x|, tiny)`` — finite wherever the entries are."""
    tiny = torch.finfo(X.dtype).tiny
    m = torch.clamp_min(torch.amax(torch.abs(X), dim=dim, keepdim=True), tiny)
    Xs = X / m
    return m * torch.sqrt(torch.sum(Xs * Xs, dim=dim, keepdim=True))


def normalize_columns(X: torch.Tensor) -> torch.Tensor:
    return X / torch.clamp_min(rescaled_norm(X, 0), torch.finfo(X.dtype).tiny)


def _mgs_clustered(X: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """Orthogonalize columns of X within clusters (masked Gram-Schmidt over
    the columns in order), renormalize; returns a new tensor."""
    X = X.clone()
    s = X.shape[1]
    tiny = torch.finfo(X.dtype).tiny
    lanes = torch.arange(s, device=X.device)
    for i in range(1, s):
        xi = X[:, i]
        mask = ((lanes < i) & (cid == cid[i])).to(X.dtype)
        coeff = (X.mT @ xi) * mask
        xi = xi - X @ coeff
        X[:, i] = xi / torch.clamp_min(rescaled_norm(xi, 0), tiny)
    return X


def start_block(n: int, s: int, generator: torch.Generator | None,
                device) -> torch.Tensor:
    """Gaussian (n, s) start block drawn from ``generator`` (a fresh one
    seeded with ``START_SEED`` when None) on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(START_SEED)
    return torch.randn((n, s), generator=generator, dtype=torch.float64,
                       device=device)


def inverse_iteration(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                      x0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      iters: int = 3) -> torch.Tensor:
    """Eigenvectors for the (sorted) eigenvalues ``lam``; returns Z (n, s).

    ``x0`` is the (n, s) start block (its columns are normalized here);
    without it one is drawn from ``generator``. Torch cannot replay the
    reference's threefry draw, so parity runs pass in the block JAX drew.
    """
    from repro_torch.kernels.tridiag_eig.ops import invit_batched
    n, s = d.shape[0], lam.shape[0]
    if x0 is None:
        x0 = start_block(n, s, generator, d.device)
    cid = _cluster_ids(lam, _scale(d, e))
    X0 = normalize_columns(x0.to(device=d.device, dtype=d.dtype))
    return invit_batched(d, e, lam, cid, _pivmin(d, e), X0, iters=iters)


class TridiagEigResult(NamedTuple):
    lam: torch.Tensor  # (s,) eigenvalues, in the order of ``ks``
    Z: torch.Tensor    # (n, s) eigenvectors of T


def eigh_tridiag_selected(d: torch.Tensor, e: torch.Tensor, ks,
                          x0: torch.Tensor | None = None,
                          generator: torch.Generator | None = None
                          ) -> TridiagEigResult:
    """Selected eigenpairs of tridiag(d, e) at indices ``ks`` (any order).

    ``ks`` is sorted internally and the result unpermuted, so ``lam[i],
    Z[:, i]`` answer ``ks[i]`` as given: the gap-based clustering and the
    masked Gram-Schmidt assume ascending shifts. ``x0``, when given, is the
    start block in the column order of the SORTED ``ks``, as the reference
    draws it.
    """
    ks = torch.as_tensor(ks, device=d.device).to(torch.int64)
    order = torch.argsort(ks)
    inv = torch.argsort(order)
    ks_sorted = ks[order]
    lam = bisect_eigenvalues(d, e, ks_sorted)
    Z = inverse_iteration(d, e, lam, x0=x0, generator=generator)
    return TridiagEigResult(lam=lam[inv], Z=Z[:, inv])
