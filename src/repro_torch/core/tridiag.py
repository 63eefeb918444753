"""TD1/TD3 — one-stage Householder tridiagonalization (DSYTRD analogue).

Q^T C Q = T with Q = H_0 H_1 ... H_{n-3}. The reflectors are kept in
factored form (V, tau), and the back-transform applies them directly
(TD3, the DORMTR analogue).

The reference runs a fixed-shape loop whose every step updates the whole
(n, n) matrix under a mask. Here the eager loop works in place on a copy
of C and touches only the trailing window ``M[j:, j:]`` at step j: the
same reflectors, the rank-2 update as one ``addmm_`` of rank 2, and about
1/3 of the bytes of the full-size update. Entries outside the window are
left as they were; ``d`` and ``e`` come from inside it. The loop queues
its launches without waiting on the card; CUDA graphs for it come later.

``tridiagonalize_blocked`` is the reference's dlatrd-style blocked form:
per panel the column work is BLAS-2 against the matrix as it stood at
the panel's start, and the trailing update is one SYR2K per panel (the
``syr2k`` kernel on the card, in place on the window).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.syr2k.ops import syr2k

from .linalg_utils import extract_tridiag, householder_masked


class TridiagResult(NamedTuple):
    d: torch.Tensor    # (n,)  diagonal of T
    e: torch.Tensor    # (n-1,) subdiagonal of T
    V: torch.Tensor    # (n, n) Householder vectors, column j = v_j (v_j[j+1] = 1)
    tau: torch.Tensor  # (n,)  reflector scales (tau[j] for column j)


def tridiagonalize(C: torch.Tensor) -> TridiagResult:
    """Reduce symmetric C to tridiagonal T via n-2 Householder steps."""
    n = C.shape[0]
    M = C.clone()
    V = torch.zeros_like(C)
    tau = torch.zeros((n,), dtype=C.dtype, device=C.device)
    for j in range(max(n - 2, 0)):
        v, tj, _ = householder_masked(M[:, j], j + 1)
        V[:, j] = v
        tau[j] = tj
        vw = v[j:]
        Mw = M[j:, j:]
        # two-sided rank-2 update on the window: M <- H M H, H = I - tau v v^T
        w = tj * (Mw @ vw)
        w = w - (0.5 * tj * (vw @ w)) * vw
        Mw.addmm_(torch.stack([vw, w], 1), torch.stack([w, vw], 0),
                  alpha=-1.0)
    d, e = extract_tridiag(M)
    return TridiagResult(d=d, e=e, V=V, tau=tau)


def tridiagonalize_blocked(C: torch.Tensor, panel: int = 32) -> TridiagResult:
    """Blocked DSYTRD: per-panel BLAS-2 column work plus one rank-2b SYR2K
    trailing update per panel; the same (d, e, V, tau) contract as
    ``tridiagonalize``.

    Panel recurrences (LAPACK dlatrd): within a panel starting at column
    c, having processed columns c..j-1 with accumulators V_p, W_p:
        a_j   = (A - V_p W_p^T - W_p V_p^T) e_j        (update column j)
        v_j   = householder(a_j)
        w_j   = tau (A v - V_p (W_p^T v) - W_p (V_p^T v));
        w_j  -= (tau/2)(w_j^T v) v
    then A <- A - V_p W_p^T - W_p V_p^T once per panel.

    Every reflector of a panel starting at c is zero above row c + 1, so
    the panel works on the trailing window ``M[c:, c:]`` (a view, updated
    in place): the rows above it meet only zeros of v. The reference runs
    whole panels and masks the columns past ``n - 2``; here the last panel
    stops there, which leaves the same (zero) V columns and tau entries.
    """
    n = C.shape[0]
    n_cols = max(n - 2, 0)
    M = C.clone(memory_format=torch.contiguous_format)
    V = torch.zeros_like(C)
    tau = C.new_zeros((n,))
    for c0 in range(0, n_cols, panel):
        c1 = min(c0 + panel, n_cols)
        Mw = M[c0:, c0:]
        Vp = C.new_zeros((n - c0, c1 - c0))
        Wp = C.new_zeros((n - c0, c1 - c0))
        for jj in range(c1 - c0):
            Vj, Wj = Vp[:, :jj], Wp[:, :jj]
            # column j refreshed with the panel's pending rank-2b updates
            col = Mw[:, jj] - Vj @ Wp[jj, :jj] - Wj @ Vp[jj, :jj]
            v, tj, _ = householder_masked(col, jj + 1)
            w = Mw @ v - Vj @ (Wj.mT @ v) - Wj @ (Vj.mT @ v)
            w = tj * w
            w = w - (0.5 * tj * (v @ w)) * v
            Vp[:, jj] = v
            Wp[:, jj] = w
            V[c0:, c0 + jj] = v
            tau[c0 + jj] = tj
        # the BLAS-3 trailing update of the panel, in place on the window
        syr2k(Mw, Vp, Wp, alpha=-1.0, out=Mw)
    d, e = extract_tridiag(M)
    return TridiagResult(d=d, e=e, V=V, tau=tau)


def apply_q(res: TridiagResult, Z: torch.Tensor) -> torch.Tensor:
    """TD3 — Y := Q Z = H_0 (H_1 (... (H_{n-3} Z))).

    H_j changes rows j+1: only, so each step updates that slab of a copy
    of Z in place."""
    n = res.V.shape[0]
    Y = Z.clone()
    for j in range(n - 3, -1, -1):
        _reflect(Y, res.V[j + 1:, j], res.tau[j], j + 1)
    return Y


def apply_qt(res: TridiagResult, Z: torch.Tensor) -> torch.Tensor:
    """Y := Q^T Z (forward reflector order)."""
    n = res.V.shape[0]
    Y = Z.clone()
    for j in range(max(n - 2, 0)):
        _reflect(Y, res.V[j + 1:, j], res.tau[j], j + 1)
    return Y


def _reflect(Y: torch.Tensor, v: torch.Tensor, tj: torch.Tensor,
             row0: int) -> None:
    Yw = Y[row0:]
    Yw -= tj * torch.outer(v, v @ Yw)
