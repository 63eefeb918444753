"""Dispatch for the band product: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor, and nothing in between — a failed
build or launch raises, it never gives way to the plain version.

The reference shrinks ``bm`` to a divisor of n and pads rows
(``band_mv/ops.py:23-31``), and its kernel needs w < bm; on the card a
block is ``bm`` rows with the ragged edge masked, and any w works
(diagonals at d >= n hold no entry of A).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launches

from . import kernel, ref


def band_mv(band: torch.Tensor, x: torch.Tensor, w: int,
            bm: int = 128) -> torch.Tensor:
    """y = A x for symmetric band A in (n, w+1) storage."""
    for t in (band, x):
        if t.dtype != torch.float64:
            raise NotImplementedError(
                f"band_mv in {t.dtype} is not ported yet (ROADMAP.md §1 "
                f"item 8); the port runs torch.float64")
    if band.shape[-1] != w + 1:
        raise ValueError(f"band must be (n, w+1) = (n, {w + 1}), got "
                         f"{tuple(band.shape)}")
    _launches.note("band_mv", k=int(band.shape[0] > 0))
    if band.device.type == "cpu":
        return ref.band_mv_ref(band, x)
    return kernel.band_mv(band, x, w, bm=bm)


__all__ = ["band_mv"]
