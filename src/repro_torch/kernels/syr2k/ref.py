"""Plain PyTorch versions of the symmetric rank-2k update (TT1).

``syr2k_ref`` is the update in the operands' dtype (the fp64 kernel's
plain version). ``syr2k_reduced_ref`` is the fp32/bf16 instances' plain
version: it computes in fp32 in the kernel's order (each product and sum
rounded on its own, the k columns summed in order, V W^T and W V^T apart
and then added) and rounds to the storage dtype where the kernel stores,
so the kernel repeats it bit for bit.
"""
from __future__ import annotations

import torch


def syr2k_ref(C: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
              alpha: float = -1.0) -> torch.Tensor:
    """C + alpha (V W^T + W V^T)."""
    return C + alpha * (V @ W.mT + W @ V.mT)


def syr2k_reduced_ref(C: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
                      alpha: float = -1.0,
                      symmetrize: bool = False) -> torch.Tensor:
    """[sym](C + alpha (V W^T + W V^T)) for fp32 or bf16 C, V, W: computed
    in fp32, rounded to C's dtype at the store and after the symmetrizing
    average, as ``csrc/syr2k.cu``'s reduced instances do."""
    dt = C.dtype

    def rnd(x):
        return x.to(dt).float()

    Vf, Wf = V.float(), W.float()
    D = torch.zeros(C.shape, dtype=torch.float32, device=C.device)
    for c in range(Vf.shape[1]):
        D = D + Vf[:, c, None] * Wf[None, :, c]
    R = rnd(C.float() + alpha * (D + D.mT))
    if symmetrize:
        R = rnd(0.5 * (R + R.mT))
    return R.to(dt)


__all__ = ["syr2k_ref", "syr2k_reduced_ref"]
