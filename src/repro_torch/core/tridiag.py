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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
