"""Plain PyTorch version of the compact-WY panel factorization.

``house_panel_ref(E, row_start)`` factors the sub-panel ``E[row_start:, :]``
of a full-height (rows, b) panel into compact-WY form: reflector ``j``
pivots at row ``row_start + j`` and only touches rows ``>= row_start``, so

    Q = I - V T V^T   is orthogonal and   (Q^T E)[row_start + j + 1:, j] = 0.

This is ``linalg_utils.qr_wy_masked`` without the R output. Reflectors
whose pivot falls past the panel come out as identity (tau = 0). The CPU
tests use it; on the card only ``chip_smoke.py``'s comparison runs it (on
CPU copies of the kernel's inputs).
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg_utils import householder_masked


def house_panel_ref(E: torch.Tensor, row_start: int):
    """Compact-WY factorization of E[row_start:, :]: returns (V, T)."""
    rows, b = E.shape
    V = E.new_zeros((rows, b))
    T = E.new_zeros((b, b))
    R = E
    for j in range(b):
        v, tau, _ = householder_masked(R[:, j], row_start + j)
        R = R - tau * torch.outer(v, v @ R)
        V[:, j] = v
        if j > 0:
            z = V[:, :j].mT @ v
            T[:j, j] = -tau * (T[:j, :j] @ z)
        T[j, j] = tau
    return V, T


__all__ = ["house_panel_ref"]
