"""fp64 iterative refinement of approximate generalized eigenpairs
(``repro.core.refinement`` in torch).

Closes the mixed-precision loop: a reduced-precision pipeline returns
eigenpairs of ``A X = B X Lambda`` accurate to about the compute dtype's
epsilon; this module refines them against the original fp64 pencil until
the Table-3 tolerances hold.

The method is correction-form subspace inverse iteration with one shared
shift and a guard buffer:

  1. pick sigma outside the wanted end of the spectrum and factor
     ``A - sigma B`` once, in fp32 (``torch.linalg.lu_factor``, as the
     reference uses ``jax.scipy``'s LU: the factor is only a
     preconditioner, the residuals that drive convergence are fp64);
  2. widen the s columns with ``guard`` guard columns, which converge to
     the next-nearest eigenvectors and deflate them;
  3. per step (fp64 but for the triangular solves):
     ``R = A X - B X diag(lam)``, ``X <- X - (A - sigma B)^{-1} R``,
     B-orthonormalize by Cholesky-QR, Rayleigh-Ritz on the fp64 pencil;
  4. stop when ``relative_residual`` and ``b_orthogonality`` of the s
     wanted pairs are under tolerance.

The guard block is a random start: the reference draws it from
``jax.random.normal(PRNGKey(1203), (n, guard))``. Here it is the
``guard0`` argument (``interop.guard_block_from_numpy`` carries the
reference's across), else a draw from ``generator`` (by default one
seeded with ``GUARD_SEED``).

``refine_eigenpairs`` is the host-loop driver (early exit, re-shift,
trajectory recording) that ``gsyeig.solve`` runs;
``refine_eigenpairs_fixed`` is the fixed-step form of the reference's
batched pipelines. The fixed form waits on the host nowhere but in the
Rayleigh-Ritz ``eigh`` of each step (the library checks its ``info`` on
the host): its shift stays a 0-d tensor (``sigma_fixed``) and its factor
is ``lu_factor_ex``, so ``core.batched`` captures everything between two
``eigh`` calls in a CUDA graph. ``fixed_refactors`` is its schedule,
``refine_pre`` the part of a step before the ``eigh``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .residuals import b_orthogonality, relative_residual

#: the shared Table-3 tolerance
REFINE_TOL = 1e-12
#: seed of the default guard block (the reference's key)
GUARD_SEED = 1203


def default_guard(s: int, n: int) -> int:
    """Guard-buffer width: ~3 s, at least 8, at most 32 and n - s."""
    return max(0, min(max(8, 3 * s), 32, n - s))


def sigma_fixed(lam: torch.Tensor, which: str) -> torch.Tensor:
    """Shift outside the wanted end of ``lam``, as a 0-d tensor on its
    device (no host sync): a margin of 5% of the wanted set's spread plus
    1% of its scale, with a scale-aware floor, so an estimate's error
    cannot land sigma on an eigenvalue. Each operation rounds as the
    reference's float arithmetic does."""
    lo, hi = lam.min(), lam.max()
    scale = torch.maximum(torch.abs(lo), torch.abs(hi))
    margin = 0.05 * (hi - lo) + 0.01 * scale
    margin = torch.maximum(margin, 1e-6 * (1.0 + scale))
    return lo - margin if which == "smallest" else hi + margin


def _factor_f32(A: torch.Tensor, B: torch.Tensor, sigma: float):
    """fp32 LU of the shifted pencil (partial pivoting)."""
    return torch.linalg.lu_factor((A - sigma * B).float())


def factor_fixed(A: torch.Tensor, B: torch.Tensor, sigma: torch.Tensor):
    """``_factor_f32`` at a 0-d tensor shift, by ``lu_factor_ex``: the same
    factor, with its ``info`` left on the device (no host sync)."""
    lu, piv, _ = torch.linalg.lu_factor_ex((A - sigma * B).float())
    return lu, piv


def fixed_refactors(steps: int) -> Tuple[bool, ...]:
    """Whether step k of a fixed refinement first re-shifts and refactors:
    phases of two steps, so steps 0, 2, 4, ..."""
    return tuple(k % 2 == 0 for k in range(steps))


def refine_pre(lu, piv, A, B, lam, X):
    """A refinement step up to its Rayleigh-Ritz ``eigh``: returns (Z, H),
    Z the B-orthonormalized corrected block and H = Z^T A Z (symmetrized);
    the step is ``lam, S = eigh(H)``, ``X = Z @ S``."""
    R = A @ X - (B @ X) * lam[None, :]
    D = torch.linalg.lu_solve(lu, piv, R.float()).double()
    Y = X - D
    # column equilibration before the Gram matrix
    Y = Y / torch.clamp_min(torch.linalg.vector_norm(Y, dim=0),
                            torch.finfo(Y.dtype).tiny)
    G = Y.mT @ (B @ Y)
    G = 0.5 * (G + G.mT)
    L, bad = torch.linalg.cholesky_ex(G)
    L = torch.where(bad == 0, L, float("nan"))   # a breakdown is non-finite
    Z = torch.linalg.solve_triangular(L, Y.mT, upper=False).mT
    H = Z.mT @ (A @ Z)
    return Z, 0.5 * (H + H.mT)


def _refine_step(lu, piv, A, B, lam, X):
    """One fp64 correction, Cholesky-QR B-orthonormalization and
    Rayleigh-Ritz step."""
    Z, H = refine_pre(lu, piv, A, B, lam, X)
    lam, S = torch.linalg.eigh(H)
    return lam, Z @ S


def _select(lam, X, s: int, which: str):
    """The wanted s of the q refined pairs (RR order is ascending)."""
    if which == "smallest":
        return lam[:s], X[:, :s]
    return lam[-s:], X[:, -s:]


def _metrics(A, B, lam, X, s: int, which: str) -> Tuple[float, float]:
    lam_s, X_s = _select(lam, X, s, which)
    return (float(relative_residual(A, B, X_s, lam_s)),
            float(b_orthogonality(X_s, B)))


def _guard_block(n: int, guard: int, guard0, generator, like) -> torch.Tensor:
    if guard0 is not None:
        G = torch.as_tensor(guard0).to(device=like.device, dtype=like.dtype)
        if tuple(G.shape) != (n, guard):
            raise ValueError(f"guard0 must be ({n}, {guard}), got "
                             f"{tuple(G.shape)}")
        return G
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(
            GUARD_SEED)
    return torch.randn((n, guard), generator=generator, dtype=like.dtype,
                       device=like.device)


def with_guards(lam, X, guard: int, which: str, G):
    """Append the guard columns (unit-normalized) and end-value Ritz
    placeholders (the first Rayleigh-Ritz step replaces them)."""
    if guard <= 0:
        return lam, X
    G = G / torch.linalg.vector_norm(G, dim=0)
    end = lam[0] if which == "largest" else lam[-1]
    pad = end.expand(guard)
    if which == "largest":
        return torch.cat([pad, lam]), torch.cat([G, X], dim=1)
    return torch.cat([lam, pad]), torch.cat([X, G], dim=1)


def _prepare(A, B, lam, X):
    dev = X.device
    return tuple(torch.as_tensor(t).to(device=dev, dtype=torch.float64)
                 for t in (A, B, lam, X))


def refine_eigenpairs(A, B, lam, X, which: str = "smallest", *,
                      tol: float = REFINE_TOL, max_steps: int = 60,
                      guard: int | None = None,
                      guard0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Refine (lam, X) against the fp64 pencil until the Table-3 bars.

    Returns ``(lam, X, info)``; ``info`` records the steps, the shifts,
    and the full relative-residual and B-orthogonality trajectories
    (index 0 is the unrefined input), plus ``stalled`` and ``finite``, the
    inputs of the ladder's ``escalate_precision`` rung.
    """
    A, B, lam, X = _prepare(A, B, lam, X)
    n, s = X.shape
    if guard is None:
        guard = default_guard(s, n)
    sigma = float(sigma_fixed(lam, which))
    lu, piv = _factor_f32(A, B, sigma)

    # the input's metrics: its columns are ascending, as the solver returns
    resid, orth = _metrics(A, B, lam, X, s, "smallest")
    resid_traj, orth_traj = [resid], [orth]
    lam_q, X_q = with_guards(lam, X, guard, which,
                             _guard_block(n, guard, guard0, generator, X)
                             if guard > 0 else None)
    steps = stalled = refactors = 0
    sigmas = [sigma]
    finite = True
    while (resid_traj[-1] > tol or orth_traj[-1] > tol) and steps < max_steps:
        lam_new, X_new = _refine_step(lu, piv, A, B, lam_q, X_q)
        r, o = _metrics(A, B, lam_new, X_new, s, which)
        if not (math.isfinite(r) and math.isfinite(o)):
            finite = False
            break                      # degenerate input; keep the last good
        lam_q, X_q = lam_new, X_new
        resid_traj.append(r)
        orth_traj.append(o)
        steps += 1
        if r <= tol and o <= tol:
            break
        lam_s, _ = _select(lam_q, X_q, s, which)
        end = float(lam_s[0] if which == "smallest" else lam_s[-1])
        sig2 = float(sigma_fixed(lam_s, which))
        if refactors < 3 and abs(sig2 - sigma) > 0.25 * abs(end - sigma):
            # the Ritz values moved enough that a fresh shift contracts
            # materially faster: refactor
            sigma = sig2
            lu, piv = _factor_f32(A, B, sigma)
            sigmas.append(sigma)
            refactors += 1
            stalled = 0
            continue
        # three non-improving steps in a row: the fp64 floor, or a shift
        # that cannot contract further
        stalled = stalled + 1 if r >= 0.95 * resid_traj[-2] else 0
        if stalled >= 3:
            break

    if steps > 0:
        lam, X = _select(lam_q, X_q, s, which)
    info = {
        "steps": steps,
        "sigma": sigmas,
        "guard": int(guard),
        "tol": float(tol),
        "converged": bool(resid_traj[-1] <= tol and orth_traj[-1] <= tol),
        "relative_residual": resid_traj,
        "b_orthogonality": orth_traj,
        "stalled": bool(stalled >= 3),
        "finite": bool(finite),
    }
    return lam, X, info


def refine_eigenpairs_fixed(A, B, lam, X, which: str = "smallest",
                            steps: int = 2, guard: int = 0,
                            guard0: torch.Tensor | None = None,
                            generator: torch.Generator | None = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-step refinement with no convergence test: phases of two steps
    (``fixed_refactors``), each first re-shifting at the wanted Ritz values
    (the input's for the first) and refactoring in fp32; otherwise the
    arithmetic of ``refine_eigenpairs``. Its shift stays on the device
    (``sigma_fixed``)."""
    A, B, lam, X = _prepare(A, B, lam, X)
    if steps == 0:
        return lam, X
    n, s = X.shape
    lam_q, X_q = with_guards(lam, X, guard, which,
                             _guard_block(n, guard, guard0, generator, X)
                             if guard > 0 else None)
    anchor = lam
    for refactor in fixed_refactors(steps):
        if refactor:
            lu, piv = factor_fixed(A, B, sigma_fixed(anchor, which))
        lam_q, X_q = _refine_step(lu, piv, A, B, lam_q, X_q)
        anchor = _select(lam_q, X_q, s, which)[0]
    return _select(lam_q, X_q, s, which)


__all__ = ["REFINE_TOL", "GUARD_SEED", "default_guard", "refine_eigenpairs",
           "refine_eigenpairs_fixed", "sigma_fixed", "factor_fixed",
           "fixed_refactors", "refine_pre", "with_guards"]
