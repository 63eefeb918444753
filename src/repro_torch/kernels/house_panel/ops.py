"""Dispatch for the panel QR: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, and nothing in between — a failed build
or launch raises, it never gives way to the plain version.

The reference pads the rows to the sublane multiple; that is TPU tiling
and is gone: the kernel takes the panel as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launches

from . import kernel, ref


def house_panel(E: torch.Tensor, row_start: int):
    """Compact-WY (V, T) of E[row_start:, :]; Q = I - V T V^T.

    E is a (rows, b) full-height panel; reflector j pivots at row
    ``row_start + j``; V is (rows, b) with zeros above each pivot, T is
    (b, b) upper triangular. float64 and float32 factor in kind; a
    bfloat16 panel is factored in float32 and V, T are rounded to
    bfloat16, as the reference's bf16 path does.
    """
    _launches.note("house_panel", E.dtype, k=int(E.shape[0] > 0))
    if E.device.type != "cpu":
        return kernel.house_panel(E, row_start)
    if E.dtype == torch.bfloat16:
        V, T = ref.house_panel_ref(E.float(), row_start)
        return V.to(E.dtype), T.to(E.dtype)
    return ref.house_panel_ref(E, row_start)


__all__ = ["house_panel"]
