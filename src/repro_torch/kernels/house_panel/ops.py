"""Dispatch for the panel QR: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, and nothing in between — a failed build
or launch raises, it never gives way to the plain version.

The reference pads the rows to the sublane multiple; that is TPU tiling
and is gone: the kernel takes the panel as it is.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def house_panel(E: torch.Tensor, row_start: int):
    """Compact-WY (V, T) of E[row_start:, :]; Q = I - V T V^T.

    E is a (rows, b) full-height panel; reflector j pivots at row
    ``row_start + j``; V is (rows, b) with zeros above each pivot, T is
    (b, b) upper triangular. fp64 only: the fp32/bf16 paths come with
    ROADMAP.md §1 item 8.
    """
    if E.dtype != torch.float64:
        raise NotImplementedError(
            f"house_panel in {E.dtype} is not ported yet (ROADMAP.md §1 "
            f"item 8); the port runs torch.float64")
    if E.device.type == "cpu":
        return ref.house_panel_ref(E, row_start)
    return kernel.house_panel(E, row_start)


__all__ = ["house_panel"]
