"""The blocked triangular solve with multiple right-hand sides, on the
tile-solve and gemm kernels for a CUDA tensor and on their plain versions
for a CPU tensor — nothing in between: a failed build or launch raises,
it never gives way to the plain version.

Block for block the reference's ``trsm/ops.py``: backward over the block
rows for U X = B, forward for U^T X = B; each block row first takes the
product update of the rows already solved (``gemm``, reading U's
off-diagonal block in place, transposed for U^T), then the diagonal tile
(``trsm_tile``). At n = 9997 and ``block=128`` that is 79 tile solves and
78 products (9997 = 78 * 128 + 13); a product whose output is too small
to fill the card is split over K, one more launch (``launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm import kernel as gemm_kernel

from repro_torch.kernels import _launches

from . import kernel, ref


def _update_kernel(Xk, A, Xj):
    # the planner splits K where the (block, s) output is too small to
    # fill the card (gemm_kernel.plan)
    gemm_kernel.gemm(A, Xj, out=Xk, alpha=-1.0, accumulate=True)


def launches(n: int, s: int, trans: bool = False, block: int = 128) -> dict:
    """The kernel launches of one card ``trsm`` of an (n, s) right-hand
    side: the schedule run on meta tensors (shapes only), a ``trsm_tile``
    per block row and per product update the launches its
    ``gemm_kernel.plan`` gives (two where K is split)."""
    counts = {"trsm_tile": 0, "gemm": 0}

    def tile(Uk, Xk, t):
        counts["trsm_tile"] += 1

    def update(Xk, A, Xj):
        counts["gemm"] += gemm_kernel.plan(*Xk.shape, A.shape[1]).launches

    if n and s:
        meta = dict(dtype=torch.float64, device="meta")
        ref.blocked_solve(torch.empty((n, n), **meta),
                          torch.empty((n, s), **meta), trans, min(block, n),
                          tile, update)
    return counts


def trsm(U: torch.Tensor, B: torch.Tensor, trans: bool = False,
         block: int = 128) -> torch.Tensor:
    """Solve U X = B (``trans=False``) or U^T X = B (``trans=True``) for
    upper-triangular U (only its upper triangle is read); B may be (n,)
    or (n, s). Returns a new X; ``block = min(block, n)``, at most 128 on
    the card (the tile kernel holds the tile in shared memory)."""
    for t in (U, B):
        if t.dtype != torch.float64:
            raise NotImplementedError(
                f"trsm in {t.dtype} is not ported yet (ROADMAP.md §1 item "
                f"8); the port runs torch.float64")
    if _launches.recording_active():
        n_, s_ = B.shape[0], (B.shape[1] if B.dim() > 1 else 1)
        for name, k in launches(n_, s_, trans, block).items():
            _launches.note(name, k=k)
    if U.device.type == "cpu":
        return ref.trsm_blocked_ref(U, B, trans=trans, block=block)
    vec = B.dim() == 1
    Bm = B[:, None] if vec else B
    n = Bm.shape[0]
    if U.shape != (n, n):
        raise ValueError(f"U must be ({n}, {n}), got {tuple(U.shape)}")
    block = min(block, n)
    if block > kernel.MAX_B:
        raise ValueError(f"block must be at most {kernel.MAX_B} on the card, "
                         f"got {block}")
    if U.stride(-1) != 1:
        U = U.contiguous()
    # the solution is written over a fresh row-major copy of B
    X = torch.empty(Bm.shape, dtype=B.dtype, device=B.device).copy_(Bm)
    if n and X.shape[1]:
        ref.blocked_solve(U, X, trans, block, kernel.trsm_tile,
                          _update_kernel)
    return X[:, 0] if vec else X


__all__ = ["trsm", "launches"]
