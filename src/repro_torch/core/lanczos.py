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
them both are drawn from ``generator``.

``lanczos_solve_jit`` is the reference's fixed-trip driver (its
``lax.while_loop``): a ``KrylovStack`` of one lane, the loop that
``core.batched`` runs over a bucket's lanes. The state of one pencil
lives in the preallocated buffers of a ``KrylovLane``, a restart is the
segment (``_segment_impl``) and the restart math (``_restart_post``), and
a done flag (converged, unhealthy or out of restarts) freezes the Ritz
pairs, the verdicts and the restart count by ``torch.where`` (a later
segment still writes a done lane's basis, which no result reads). Only the
``eigh`` of each restart and the host's read of the done flag leave the
device; ``core.batched`` captures everything between them in CUDA graphs.

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
                        probe_matrix, probe_steps)
from .instrument import DispatchCounter
from .linalg_utils import eigh_input, eigh_or_nan, eigh_output
from .operators import ExplicitC, ImplicitC, apply_op, op_dim
from .precision import padded_copy

#: seed of the default start block when no generator is given (the
#: reference's default key of ``lanczos_solve``)
START_SEED = 272727

_dispatch = DispatchCounter()

#: stage entries since the last ``reset_dispatch_count()``: in
#: ``lanczos_solve`` the bounds probe, the filter, and each restart's
#: segment and restart math (the reference's ``dispatch_count``,
#: ``repro/core/lanczos.py:215-220``, counted at the same call sites); in
#: ``lanczos_solve_jit`` each piece it runs (what ``core.batched``
#: replays from a CUDA graph)
dispatch_count = _dispatch.count
reset_dispatch_count = _dispatch.reset


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
    theta, S = eigh_or_nan(restart_matrix(T, m))      # ascending
    return _restart_post(V, B_q, theta, S, tol_eff, s, keep, m, p, which,
                         resid_floor_rel)


def restart_matrix(T: torch.Tensor, m: int) -> torch.Tensor:
    """The restart's ``eigh`` operand: the leading m x m block of T,
    symmetrized."""
    return 0.5 * (T[:m, :m] + T[:m, :m].mT)


def _restart_post(V: torch.Tensor, B_q: torch.Tensor, theta: torch.Tensor,
                  S: torch.Tensor, tol_eff: float, s: int, keep: int, m: int,
                  p: int, which: str, resid_floor_rel: float = 0.0):
    """``_restart_math`` after its ``eigh`` (theta ascending, S)."""
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
    T_new = V.new_zeros((m + p, m + p))
    idx = torch.arange(keep, device=V.device)
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
                  compute_dtype=None, callback=None) -> LanczosResult:
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
    operator only (module docstring). ``callback(k_restart, V, T, m)``, if
    given, is called after each restart's math with that segment's basis
    and projected matrix, before the verdicts are read (the checkpoint
    hook of ``dist.checkpoint.lanczos_callback``).
    """
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be 'SA' or 'LA', got {which!r}")
    if isinstance(op, (ExplicitC, ImplicitC)):
        n = op_dim(op)
        M = op.C if isinstance(op, ExplicitC) else op.A
        dtype, device = M.dtype, M.device
    elif callable(op):
        if n is None:
            if v0 is None:
                raise ValueError("callable op needs `v0` or `n`")
            n = v0.shape[0]
        dtype = torch.float64
        device = (v0.device if isinstance(v0, torch.Tensor)
                  else generator.device if generator is not None
                  else torch.device("cpu"))
    else:
        raise TypeError(f"op must be an Operator or a matvec callable: {op!r}")
    if dtype != torch.float64:
        raise ValueError(
            f"the Lanczos state is float64 and so is the operator it is "
            f"given, got {dtype}; compute_dtype= demotes the operator")
    matvec, resid_floor_rel = krylov_matvec(op, use_kernel, compute_dtype)
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
        theta_p, beta_k = _dispatch(estimate_bounds, matvec, probe_v0, kb)
        a, b, a0 = filter_interval(theta_p, beta_k, s, which)
        X0 = _dispatch(chebyshev_filter, matvec, X0, filter_degree, a, b, a0)
        n_matvec += kb + filter_degree * p
    V = torch.zeros((n, m + p), dtype=dtype, device=device)
    T = torch.zeros((m + p, m + p), dtype=dtype, device=device)
    Q0, _ = _qr_posdiag(X0)
    V[:, :p] = Q0

    j0 = 0
    for k_restart in range(max_restarts):
        V, T, B_q = _dispatch(_segment_impl, matvec, V, T, j0, p)
        n_matvec += m - j0 * p
        theta, S, resid, V_restart, T_new, all_conv, healthy = _dispatch(
            _restart_math, V, T, B_q, tol_eff, s=s, keep=keep, m=m, p=p,
            which=which, resid_floor_rel=resid_floor_rel)
        if callback is not None:
            callback(k_restart, V, T, m)
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


class KrylovLane:
    """One pencil's fixed-trip thick-restart state, in buffers allocated
    once and updated in place, so that a CUDA graph captured over its
    methods replays on the same memory (``core.batched``).

    The reference's ``lax.while_loop`` state: the basis V, T, the last
    coupling B_q, the restart count ``k``, ``converged``, ``healthy``, the
    Ritz pair ``(evals, evecs)`` of the last restart and ``done`` (out of
    restarts, converged or unhealthy: the loop's negated condition). None
    of the methods reads a value back to the host; each ``eigh`` is the
    caller's, between ``segment`` (or ``probe``) and ``restart`` (or
    ``begin``)."""

    def __init__(self, n: int, s: int, m: int, p: int, which: str,
                 max_restarts: int, resid_floor_rel: float, device):
        f64 = torch.float64
        self.s, self.m, self.p, self.which = s, m, p, which
        self.max_restarts = max_restarts
        self.keep = restart_schedule(s, m, p)[0]
        self.resid_floor_rel = resid_floor_rel
        self.V = torch.zeros((n, m + p), dtype=f64, device=device)
        self.T = torch.zeros((m + p, m + p), dtype=f64, device=device)
        self.B_q = torch.zeros((p, p), dtype=f64, device=device)
        self.k = torch.zeros((), dtype=torch.int64, device=device)
        self.converged = torch.zeros((), dtype=torch.bool, device=device)
        self.healthy = torch.ones((), dtype=torch.bool, device=device)
        self.done = torch.zeros((), dtype=torch.bool, device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.beta = torch.zeros((), dtype=f64, device=device)
        self.evals = torch.zeros((s,), dtype=f64, device=device)
        self.evecs = torch.zeros((n, s), dtype=f64, device=device)

    def probe(self, matvec, v: torch.Tensor, k: int) -> torch.Tensor:
        """The filter probe up to its ``eigh``; returns the operand."""
        Tk, beta = probe_matrix(matvec, v, k)
        self.beta.copy_(beta)
        finite, Tk = eigh_input(Tk)
        self.finite.copy_(finite)
        return Tk

    def begin(self, matvec, X0: torch.Tensor, filter_degree: int = 0,
              w: torch.Tensor | None = None) -> None:
        """Reset the state to the start block X0 (n, p), Chebyshev-filtered
        first when ``filter_degree > 0`` from the probe's eigenvalues w
        (the ``eigh`` of ``probe``'s operand)."""
        if filter_degree > 0:
            theta, _ = eigh_output(self.finite, w, None)
            a, b, a0 = filter_interval(theta, self.beta, self.s, self.which)
            X0 = chebyshev_filter(matvec, X0, filter_degree, a, b, a0)
        Q0, _ = _qr_posdiag(X0)
        self.V.zero_()
        self.V[:, :self.p] = Q0
        self.T.zero_()
        for t in (self.k, self.evals, self.evecs):
            t.zero_()
        self.converged.fill_(False)
        self.done.fill_(False)
        self.healthy.fill_(True)

    def segment(self, matvec, first: bool) -> torch.Tensor:
        """The block steps of one restart (from block 0 on the first, from
        ``keep / p`` after a thick restart); returns the ``eigh`` operand."""
        j0 = 0 if first else self.keep // self.p
        _, _, B_q = _segment_impl(matvec, self.V, self.T, j0, self.p)
        self.B_q.copy_(B_q)
        finite, Tm = eigh_input(restart_matrix(self.T, self.m))
        self.finite.copy_(finite)
        return Tm

    def restart(self, w: torch.Tensor, S: torch.Tensor) -> None:
        """The restart math from the ``eigh`` (w, S) of ``segment``'s
        operand, applied where the lane is not done."""
        theta, S = eigh_output(self.finite, w, S)
        m, s = self.m, self.s
        theta, S, _, V_restart, T_new, conv, healthy = _restart_post(
            self.V, self.B_q, theta, S, torch.finfo(torch.float64).eps, s,
            self.keep, m, self.p, self.which, self.resid_floor_rel)
        live = ~self.done
        self.evecs.copy_(torch.where(live, self.V[:, :m] @ S[:, :s],
                                     self.evecs))
        self.evals.copy_(torch.where(live, theta[:s], self.evals))
        self.V.copy_(torch.where(live, V_restart, self.V))
        self.T.copy_(torch.where(live, T_new, self.T))
        self.converged.copy_(torch.where(live, conv, self.converged))
        self.healthy.copy_(torch.where(live, healthy, self.healthy))
        self.k.add_(live.to(torch.int64))
        self.done.copy_((self.k >= self.max_restarts) | self.converged
                        | ~self.healthy)

    def result(self):
        """(evals (s,), evecs (n, s) orthonormalized, k, converged,
        healthy): ``lanczos_solve_jit``'s outputs."""
        q, _ = torch.linalg.qr(self.evecs)
        return self.evals, q, self.k, self.converged, self.healthy


def krylov_matvec(op, use_kernel: bool, compute_dtype):
    """(matvec, resid_floor_rel) on (n, p) blocks of an ``ExplicitC``/
    ``ImplicitC`` operator or a block-matvec callable, demoted to
    ``compute_dtype`` (None, a torch dtype or its name) when it is below
    float64."""
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    if isinstance(op, (ExplicitC, ImplicitC)):
        base = lambda X: apply_op(op, X, use_kernel=use_kernel)  # noqa: E731
    else:
        base = op
    return _demoted(op, base, compute_dtype, use_kernel)


def eigh_stack(M: torch.Tensor, w: torch.Tensor, V: torch.Tensor) -> None:
    """One batched ``eigh`` of the (b, k, k) stack M into (w, V), in place.
    A matrix that is not finite gives NaN (JAX's answer; the library
    raises), so that a poisoned lane reaches its health verdict and not an
    exception. ``torch.linalg.eigh`` reads its ``info`` on the host, so in
    ``core.batched`` each such call is a split point between two graphs."""
    finite = torch.isfinite(M).flatten(1).all(1)
    w_, V_ = torch.linalg.eigh(torch.where(finite[:, None, None], M, 0.0))
    w.copy_(torch.where(finite[:, None], w_, float("nan")))
    V.copy_(torch.where(finite[:, None, None], V_, float("nan")))


class KrylovStack:
    """``lanczos_solve_jit``'s loop over a stack of lanes, one pencil each:
    the reference's ``lax.while_loop`` under ``vmap``, which runs until
    every lane is done while each done lane stays frozen.

    Its pieces (``pieces()``: ``krylov_init``, ``krylov_filter`` with a
    filter, ``krylov_restart``, ``krylov_segment``) run every lane in turn
    and read nothing back to the host. ``drive`` runs them by name through
    ``run`` around the batched ``eigh``s and the one host read of a
    restart, so that ``core.batched`` can replay each piece from a CUDA
    graph. ``operator(i)`` gives lane i's (matvec, resid_floor_rel) inside
    ``krylov_init``; ``v0`` (b, n, p) and ``probe_v0`` (b, n) hold the
    starts, read when the pieces run."""

    def __init__(self, lanes, operator, v0: torch.Tensor,
                 probe_v0: torch.Tensor | None, filter_degree: int):
        b, n, m = len(lanes), v0.shape[1], lanes[0].m
        f64 = dict(dtype=torch.float64, device=v0.device)
        self.lanes, self.operator = lanes, operator
        self.v0, self.probe_v0 = v0, probe_v0
        self.filter_degree = filter_degree
        self.matvec: list = [None] * b
        self.kb = probe_steps(lanes[0].s, n)
        if filter_degree > 0:
            self.Tk = torch.zeros((b, self.kb, self.kb), **f64)
            self.wk = torch.zeros((b, self.kb), **f64)
            self.Sk = torch.zeros_like(self.Tk)
        self.Tm = torch.zeros((b, m, m), **f64)
        self.wm = torch.zeros((b, m), **f64)
        self.Sm = torch.zeros_like(self.Tm)
        self.all_done = torch.zeros((), dtype=torch.bool, device=v0.device)
        self.restarts = 0

    def pieces(self) -> dict:
        out = {"krylov_init": self.init}
        if self.filter_degree > 0:
            out["krylov_filter"] = self.filter
        out.update(krylov_restart=self.restart, krylov_segment=self.segment)
        return out

    def init(self) -> None:
        for i, lane in enumerate(self.lanes):
            self.matvec[i], lane.resid_floor_rel = self.operator(i)
            if self.filter_degree > 0:
                self.Tk[i].copy_(lane.probe(self.matvec[i],
                                            self.probe_v0[i], self.kb))
            else:
                lane.begin(self.matvec[i], self.v0[i])
                self.Tm[i].copy_(lane.segment(self.matvec[i], True))

    def filter(self) -> None:
        for i, lane in enumerate(self.lanes):
            lane.begin(self.matvec[i], self.v0[i], self.filter_degree,
                       self.wk[i])
            self.Tm[i].copy_(lane.segment(self.matvec[i], True))

    def restart(self) -> None:
        for i, lane in enumerate(self.lanes):
            lane.restart(self.wm[i], self.Sm[i])
        self.all_done.copy_(torch.stack([lane.done
                                         for lane in self.lanes]).all())

    def segment(self) -> None:
        for i, lane in enumerate(self.lanes):
            self.Tm[i].copy_(lane.segment(self.matvec[i], False))

    def drive(self, run, segment_once: bool = False) -> None:
        """Run the loop; ``run(name)`` runs a piece. The host reads the
        all-done flag after each restart and stops on it, with
        ``segment_once`` not before one ``krylov_segment`` has run (a
        capture's warm-up runs every piece; a segment and restart of done
        lanes change none of their results)."""
        run("krylov_init")
        if self.filter_degree > 0:
            eigh_stack(self.Tk, self.wk, self.Sk)
            run("krylov_filter")
        self.restarts, segmented = 0, False
        while True:
            eigh_stack(self.Tm, self.wm, self.Sm)
            run("krylov_restart")
            self.restarts += 1
            if bool(self.all_done) and (segmented or not segment_once):
                break                       # the restart's one host read
            run("krylov_segment")
            segmented = True


def lanczos_solve_jit(op, v0: torch.Tensor, s: int, m: int,
                      which: str = "SA", max_restarts: int = 50,
                      use_kernel: bool = False, p: int = 1,
                      filter_degree: int = 0, compute_dtype=None,
                      probe_v0: torch.Tensor | None = None):
    """Thick-restart block Lanczos with the reference's fixed-trip loop:
    a ``KrylovStack`` of one lane, its pieces run eagerly.

    ``v0`` is (n,) for p == 1 or the (n, p) start block; the filter probe
    starts at ``probe_v0``, by default ``v0``'s first column (the
    reference's). Runs restarts until converged (the machine-precision
    criterion), unhealthy or ``max_restarts``. Returns (evals (s,), evecs
    (n, s), k, converged, healthy): 0-d tensors for the last three, evals
    the wanted end first. ``compute_dtype`` demotes the operator only,
    as in ``lanczos_solve``.
    """
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be 'SA' or 'LA', got {which!r}")
    n = op_dim(op)
    X0 = v0[:, None] if v0.dim() == 1 else v0
    if m % p or tuple(X0.shape) != (n, p):
        raise ValueError(f"m={m} must be a multiple of p={p} and v0 ({n},) "
                         f"or ({n}, {p}), got {tuple(v0.shape)}")
    matvec, floor = krylov_matvec(op, use_kernel, compute_dtype)
    lane = KrylovLane(n, s, m, p, which, max_restarts, floor, X0.device)
    probe = None
    if filter_degree > 0:
        probe = (X0[:, 0] if probe_v0 is None else probe_v0)[None]
    stack = KrylovStack([lane], lambda i: (matvec, floor), X0[None], probe,
                        filter_degree)
    pieces = stack.pieces()
    stack.drive(lambda name: _dispatch(pieces[name]))
    return lane.result()


__all__ = ["LanczosResult", "lanczos_solve", "lanczos_solve_jit",
           "KrylovLane", "KrylovStack", "eigh_stack", "krylov_matvec",
           "default_subspace", "restart_schedule", "START_SEED",
           "dispatch_count", "reset_dispatch_count"]
