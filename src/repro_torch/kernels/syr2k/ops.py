"""Dispatch for the rank-2k update: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor, and nothing in between — a failed
build or launch raises, it never gives way to the plain version.

The reference pads n to its tile size on every call; that is TPU tiling
and is gone: the kernel masks the ragged edge itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launches

from . import kernel, ref


def syr2k(C: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
          alpha: float = -1.0, symmetrize: bool = False,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """R = C + alpha (V W^T + W V^T), or (R + R^T)/2 with ``symmetrize``.

    ``out`` receives the result (``out=C`` updates C in place). float64,
    float32, or bfloat16 computed in float32 (the kernel's instances).
    """
    _launches.note("syr2k", C.dtype, k=int(C.shape[0] > 0))
    if C.device.type != "cpu":
        return kernel.syr2k(C, V, W, alpha=alpha, symmetrize=symmetrize,
                            out=out)
    if C.dtype == torch.float64:
        R = ref.syr2k_ref(C, V, W, alpha)
        if symmetrize:
            R = 0.5 * (R + R.mT)
    else:
        R = ref.syr2k_reduced_ref(C, V, W, alpha, symmetrize)
    if out is None:
        return R
    return out.copy_(R)


__all__ = ["syr2k"]
