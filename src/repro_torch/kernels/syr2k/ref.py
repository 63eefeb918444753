"""Plain PyTorch version of the symmetric rank-2k update (TT1)."""
from __future__ import annotations

import torch


def syr2k_ref(C: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
              alpha: float = -1.0) -> torch.Tensor:
    """C + alpha (V W^T + W V^T)."""
    return C + alpha * (V @ W.mT + W @ V.mT)


__all__ = ["syr2k_ref"]
