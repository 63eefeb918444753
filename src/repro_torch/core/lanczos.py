"""KE/KI — thick-restart BLOCK Lanczos (ARPACK DSAUPD/DSEUPD analogue).

The symmetric thick-restart method (Wu & Simon) on (n, p) blocks: each
block step applies the operator ONCE to the whole block (one multi-RHS
product), reorthogonalizes against the full basis twice, and takes a
sign-fixed QR of the residual block. For p == 1 this is the classical
single-vector method. State is one (n, m+p) basis and a dense (m+p, m+p)
projected matrix; a restart is the eigh of its leading m x m block.

``lanczos_solve`` is host-driven, as the reference's: each restart runs
the block steps of one segment as a Python loop, then the restart math,
then fetches the two verdicts (converged, healthy) in ONE device-to-host
copy. The block-step loop reads nothing back from the device; the matvec
count is host arithmetic. Unlike the reference's donated jit buffers, the
segment updates V and T in place.

Random starts are explicit: ``v0`` is the (n, p) start block and
``probe_v0`` the filter probe's (n,) vector (the reference draws them as
``normal(key, (n, p))`` and ``normal(fold_in(key, 2), (n,))``; torch
cannot replay threefry, so parity runs pass in what JAX drew). Without
them both are drawn from ``generator``. The fully jitted variant of the
batched path (``lanczos_solve_jit``) comes with that path (ROADMAP.md §1
item 9).

``compute_dtype`` (fp32 or bf16) demotes only the operator: its matrices
are cast once (the product's matrix into a copy with padded rows,
``demote_op``), each block goes in cast and comes out in fp64, and the
basis, T and all restart and convergence math stay fp64. The convergence
test then also accepts bounds under 8 eps(compute dtype) max|theta|, the
floor a demoted product can reach; fp64 refinement recovers the rest.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .filtering import (chebyshev_filter, estimate_bounds, filter_interval,
                        probe_steps)
from .linalg_utils import eigh_or_nan
from .operators import ExplicitC, ImplicitC, apply_op, op_dim
from .precision import padded_copy

#: seed of the default start block when no generator is given (the
#: reference's default key of ``lanczos_solve``)
START_SEED = 272727


class LanczosResult(NamedTuple):
    evals: torch.Tensor         # (s,) wanted end first
    evecs: torch.Tensor         # (n, s) Ritz vectors (orthonormal)
    n_matvec: int               # operator applications
    n_restart: int
    converged: bool
    resid_bounds: torch.Tensor  # (s,) ||B_q S[m-p:m, i]|| at exit
    healthy: bool = True        # finite-sentinel verdict at exit


def _qr_posdiag(W: torch.Tensor):
    """Reduced QR with the R diagonal forced nonnegative (for p == 1 exactly
    v = w/||w||, beta = ||w||)."""
    Q, R = torch.linalg.qr(W)
    sgn = torch.sign(torch.diagonal(R))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return Q * sgn[None, :], R * sgn[:, None]


def _block_step_impl(matvec, V: torch.Tensor, T: torch.Tensor, j: int,
                     p: int):
    """Extend the factorization by one (n, p) block: basis columns
    [j*p, (j+1)*p) of V (n, m+p) are applied, the new block goes to
    columns [(j+1)*p, (j+2)*p), and T (m+p, m+p) gets the block column.
    V and T are updated in place. One call = p operator applications."""
    c0 = j * p
    W = matvec(V[:, c0:c0 + p])
    # two-pass full block reorthogonalization (Kahan: twice is enough);
    # coefficients against columns not yet built are zeroed, as the
    # reference's mask does
    H1 = V.mT @ W
    H1[c0 + p:] = 0.0
    W = W - V @ H1
    H2 = V.mT @ W
    H2[c0 + p:] = 0.0
    W = W - V @ H2
    H = H1 + H2                           # (m+p, p) projection coefficients
    Q, B = _qr_posdiag(W)                 # residual block QR
    # block column of T: H on rows < (j+1)p, the new coupling B below
    H[c0 + p:c0 + 2 * p] += B
    T[:, c0:c0 + p] = H
    T[c0:c0 + p, :] = H.mT
    V[:, c0 + p:c0 + 2 * p] = Q
    return V, T, B


def _segment_impl(matvec, V: torch.Tensor, T: torch.Tensor, j0: int,
                  p: int = 1):
    """Block steps j0..q-1 (q = m/p): the reference's fori_loop with its
    ``j >= j0`` skip, as a loop that starts at j0. Returns (V, T, B_q), B_q
    the last (p, p) coupling."""
    q = (V.shape[1] - p) // p
    B = torch.zeros((p, p), dtype=V.dtype, device=V.device)
    for j in range(j0, q):
        V, T, B = _block_step_impl(matvec, V, T, j, p)
    return V, T, B


def _restart_math(V: torch.Tensor, T: torch.Tensor, B_q: torch.Tensor,
                  tol_eff: float, s: int, keep: int, m: int, p: int,
                  which: str, resid_floor_rel: float = 0.0):
    """eigh of T_m, Ritz selection, residual bounds, the thick-restart state
    and the convergence verdict, all on the device.

    The residual bound of Ritz pair i is ``||B_q S[m-p:m, i]||``; the
    restart keeps the leading ``keep`` Ritz vectors plus the (n, p)
    residual block, with the coupling ``B_q S[m-p:m, :keep]`` in the
    arrowhead of the new T."""
    Tm = 0.5 * (T[:m, :m] + T[:m, :m].mT)
    theta, S = eigh_or_nan(Tm)            # ascending
    if which == "LA":  # want the largest: reorder descending, wanted first
        theta = torch.flip(theta, (0,))
        S = torch.flip(S, (1,))
    b = B_q @ S[m - p:m, :]                # (p, m) residual couplings
    resid = torch.linalg.vector_norm(b, dim=0)
    # ARPACK dsconv criterion: bound_i <= tol * max(eps^{2/3}, |theta_i|)
    eps23 = torch.finfo(V.dtype).eps ** (2.0 / 3.0)
    thresh = tol_eff * torch.clamp_min(torch.abs(theta[:s]), eps23)
    if resid_floor_rel:
        # a demoted product floors the attainable bound at ~eps_c ||C||
        thresh = torch.clamp_min(thresh, resid_floor_rel
                                 * torch.abs(theta).max())
    all_conv = torch.all(resid[:s] <= thresh)
    healthy = torch.isfinite(theta).all() & torch.isfinite(resid).all()
    V_restart = torch.zeros_like(V)
    V_restart[:, :keep] = V[:, :m] @ S[:, :keep]
    V_restart[:, keep:keep + p] = V[:, m:m + p]
    T_new = torch.zeros_like(T)
    idx = torch.arange(keep, device=T.device)
    T_new[idx, idx] = theta[:keep]
    T_new[keep:keep + p, :keep] = b[:, :keep]
    T_new[:keep, keep:keep + p] = b[:, :keep].mT
    return theta, S, resid, V_restart, T_new, all_conv, healthy


def default_subspace(s: int, n: int, p: int = 1) -> int:
    """ARPACK-style default NCV: m in [2s, n), at least 20 — rounded up to
    a multiple of the block size p (and down so the (n, m+p) basis fits).
    For blocks the subspace scales with p: m ~ 10p keeps ~10 block steps
    per sweep."""
    m = int(min(max(2 * s + 1, 20), n - 1))
    if p > 1:
        m = max(m, min(10 * p, n // 2))
        m = -(-m // p) * p                  # round up to a block multiple
        m = min(m, ((n - p) // p) * p)      # basis must fit: m + p <= n
    return m


def restart_schedule(s: int, m: int, p: int = 1) -> tuple:
    """(keep, per_restart): each restart keeps ``keep`` Ritz pairs (a
    multiple of p, so restarts stay block-aligned) and extends by
    ``per_restart = m - keep`` matvecs."""
    keep = min(s + max((m - s) // 2, 1), m - 2)
    if p > 1:
        keep = min(-(-keep // p) * p, m - p)
    return keep, max(m - keep, 1)


def _seed_block(v0, n: int, p: int, generator, dtype, device):
    """(n, p) start block: v0 (or a random block) in the leading columns,
    random fill for the rest; orthonormalized by the caller."""
    if v0 is None:
        return torch.randn((n, p), generator=generator, dtype=dtype,
                           device=device)
    v0 = torch.as_tensor(v0).to(device=device, dtype=dtype)
    if v0.dim() == 1:
        if p == 1:
            return v0[:, None]
        rest = torch.randn((n, p - 1), generator=generator, dtype=dtype,
                           device=device)
        return torch.cat([v0[:, None], rest], dim=1)
    if tuple(v0.shape) != (n, p):
        raise ValueError(f"v0 must be ({n},) or ({n}, {p}), got "
                         f"{tuple(v0.shape)}")
    return v0


def demote_op(op, compute_dtype):
    """The operator in ``compute_dtype``: the product's matrix (``C``, or
    ``A`` of the implicit operator) in a padded copy (``padded_copy``:
    rows on 16-byte boundaries, for the reduced kernels' 16-byte loads),
    ``U`` cast as it is (it goes to ``solve_triangular``)."""
    if isinstance(op, ExplicitC):
        return ExplicitC(padded_copy(op.C, compute_dtype))
    return ImplicitC(padded_copy(op.A, compute_dtype),
                     op.U.to(compute_dtype))


def _demoted(op, matvec, compute_dtype, use_kernel: bool):
    """(matvec, resid_floor_rel) with the operator in ``compute_dtype``."""
    if compute_dtype in (None, torch.float64):
        return matvec, 0.0
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float64, float32 or "
                         f"bfloat16, got {compute_dtype!r}")
    if isinstance(op, (ExplicitC, ImplicitC)):
        op_c = demote_op(op, compute_dtype)
        inner = lambda X: apply_op(op_c, X.to(compute_dtype),  # noqa: E731
                                   use_kernel=use_kernel)
    else:
        inner = lambda X: op(X.to(compute_dtype))  # noqa: E731
    return (lambda X: inner(X).to(torch.float64),
            8.0 * torch.finfo(compute_dtype).eps)


def lanczos_solve(op, s: int, which: str = "SA", m: int | None = None,
                  tol: float = 0.0, max_restarts: int = 500,
                  use_kernel: bool = False, v0=None, probe_v0=None,
                  generator: torch.Generator | None = None,
                  n: int | None = None, p: int = 1, filter_degree: int = 0,
                  compute_dtype=None) -> LanczosResult:
    """Host-driven thick-restart block Lanczos for s extremal eigenpairs.

    ``op`` is an ``ExplicitC``/``ImplicitC`` operator or any block-matvec
    callable X -> C X on (n, p) blocks; for a callable the dimension comes
    from ``v0`` (or the explicit ``n``) and the device from ``v0`` (or
    ``generator``, else the CPU). which: 'SA' (smallest algebraic) or 'LA'
    (largest algebraic). tol=0.0 is ARPACK's default machine-precision
    criterion. ``p`` is the block size; ``filter_degree > 0``
    Chebyshev-filters the start block, with bounds from a probe started at
    ``probe_v0``. ``v0`` is (n,) or (n, p); what is not given is drawn
    from ``generator`` (by default one seeded with ``START_SEED``).
    ``compute_dtype`` (None, or torch.float32/bfloat16) demotes the
    operator only (module docstring).
    """
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be 'SA' or 'LA', got {which!r}")
    if isinstance(op, (ExplicitC, ImplicitC)):
        n = op_dim(op)
        M = op.C if isinstance(op, ExplicitC) else op.A
        dtype, device = M.dtype, M.device
        matvec = lambda X: apply_op(op, X, use_kernel=use_kernel)  # noqa: E731
    elif callable(op):
        if n is None:
            if v0 is None:
                raise ValueError("callable op needs `v0` or `n`")
            n = v0.shape[0]
        dtype = torch.float64
        device = (v0.device if isinstance(v0, torch.Tensor)
                  else generator.device if generator is not None
                  else torch.device("cpu"))
        matvec = op
    else:
        raise TypeError(f"op must be an Operator or a matvec callable: {op!r}")
    if dtype != torch.float64:
        raise ValueError(
            f"the Lanczos state is float64 and so is the operator it is "
            f"given, got {dtype}; compute_dtype= demotes the operator")
    matvec, resid_floor_rel = _demoted(op, matvec, compute_dtype, use_kernel)
    if m is None:
        m = default_subspace(s, n, p)
    if m % p or m + p > n + (1 if p == 1 else 0):
        raise ValueError(f"m={m} must be a multiple of p={p} with m + p <= n "
                         f"(n={n})")
    if not 2 * s < m + 1:
        raise ValueError(f"the subspace m={m} must exceed 2 s - 1 (s={s})")
    if max_restarts < 1:
        raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
    keep, _ = restart_schedule(s, m, p)
    tol_eff = tol if tol > 0.0 else torch.finfo(dtype).eps
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(START_SEED)

    X0 = _seed_block(v0, n, p, generator, dtype, device)
    n_matvec = 0
    if filter_degree > 0:
        kb = probe_steps(s, n)
        if probe_v0 is None:
            probe_v0 = torch.randn((n,), generator=generator, dtype=dtype,
                                   device=device)
        probe_v0 = torch.as_tensor(probe_v0).to(device=device, dtype=dtype)
        theta_p, beta_k = estimate_bounds(matvec, probe_v0, kb)
        a, b, a0 = filter_interval(theta_p, beta_k, s, which)
        X0 = chebyshev_filter(matvec, X0, filter_degree, a, b, a0)
        n_matvec += kb + filter_degree * p
    V = torch.zeros((n, m + p), dtype=dtype, device=device)
    T = torch.zeros((m + p, m + p), dtype=dtype, device=device)
    Q0, _ = _qr_posdiag(X0)
    V[:, :p] = Q0

    j0 = 0
    for k_restart in range(max_restarts):
        V, T, B_q = _segment_impl(matvec, V, T, j0, p)
        n_matvec += m - j0 * p
        theta, S, resid, V_restart, T_new, all_conv, healthy = _restart_math(
            V, T, B_q, tol_eff, s=s, keep=keep, m=m, p=p, which=which,
            resid_floor_rel=resid_floor_rel)
        # the one device-to-host copy of the restart: both verdicts
        conv_ok, health_ok = torch.stack([all_conv, healthy]).tolist()
        if not health_ok:
            # the restart state is poisoned: a NaN residual never converges
            evecs = V[:, :m] @ S[:, :s]
            return LanczosResult(theta[:s], evecs, n_matvec, k_restart + 1,
                                 False, resid[:s], healthy=False)
        if conv_ok:
            evecs, _ = torch.linalg.qr(V[:, :m] @ S[:, :s])
            return LanczosResult(theta[:s], evecs, n_matvec, k_restart + 1,
                                 True, resid[:s])
        if k_restart + 1 == max_restarts:
            break
        V, T = V_restart, T_new
        j0 = keep // p

    # the Ritz vectors of the last segment's basis (the reference takes the
    # restarted basis here, which mixes two bases: ROADMAP.md queue 3)
    evecs, _ = torch.linalg.qr(V[:, :m] @ S[:, :s])
    return LanczosResult(theta[:s], evecs, n_matvec, max_restarts, False,
                         resid[:s])


__all__ = ["LanczosResult", "lanczos_solve", "default_subspace",
           "restart_schedule", "START_SEED"]
