"""The blocked triangular solve with multiple right-hand sides, on the
tile-solve and gemm kernels for a CUDA tensor and on their plain versions
for a CPU tensor — nothing in between: a failed build or launch raises,
it never gives way to the plain version.

Block for block the reference's ``trsm/ops.py``: backward over the block
rows for U X = B, forward for U^T X = B; each block row first takes the
product update of the rows already solved (``gemm``, reading U's
off-diagonal block in place, transposed for U^T), then the diagonal tile
(``trsm_tile``). At n = 9997 and ``block=128`` that is 79 tile solves and
78 products (9997 = 78 * 128 + 13).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm import kernel as gemm_kernel

from . import kernel, ref


def _update_tiles(rows: int, cols: int) -> int:
    """The output tile of a product update: the largest compiled edge that
    still gives about one block per SM of an H100 (132), since a block row
    is only ``block`` rows tall and K runs over every solved row."""
    for t in reversed(gemm_kernel.TILES):
        if -(-rows // t) * -(-cols // t) >= 132:
            return t
    return gemm_kernel.TILES[0]


def _update_kernel(Xk, A, Xj):
    t = _update_tiles(*Xk.shape)
    gemm_kernel.gemm(A, Xj, out=Xk, alpha=-1.0, accumulate=True, bm=t, bn=t,
                     bk=gemm_kernel.MAX_BK)


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


__all__ = ["trsm"]
