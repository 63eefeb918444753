"""Dispatch for the Givens rotations: the CUDA kernels for a CUDA tensor,
the plain PyTorch versions for a CPU tensor, and nothing in between — a
failed build or launch raises, it never gives way to the plain version.

The reference pads G and L to its (8, 128) tiles; that is TPU tiling and
is gone. Where the reference calls ``rot_apply`` twice per chase step and
once per replay sweep, the port runs a whole pass per launch
(``chase_pass``, ``replay_pass``); both update their storage in place.
fp64 only: the fp32/bf16 paths come with ROADMAP.md §1 item 8.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _fp64(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float64:
        raise NotImplementedError(
            f"{what} in {t.dtype} is not ported yet (ROADMAP.md §1 item 8); "
            f"the port runs torch.float64")


def rot_apply(pairs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """G rotations of G row pairs: pairs (G, 2, L), cs (G, 2) ->
    (c x0 + s x1, -s x0 + c x1) per pair."""
    _fp64(pairs, "rot_apply")
    if pairs.device.type == "cpu":
        return ref.rot_apply_ref(pairs, cs)
    return kernel.rot_apply(pairs, cs)


def chase_pass(Wp: torch.Tensor, b: int, w: int, n: int) -> torch.Tensor:
    """One wavefront bandwidth pass b -> b-1 over the padded band ``Wp``
    (updated in place); returns its (J+1, K0+1, 2) rotation table."""
    _fp64(Wp, "chase_pass")
    if Wp.device.type == "cpu":
        return ref.chase_pass_ref(Wp, b, w, n)
    return kernel.chase_pass(Wp, b, w, n)


def replay_pass(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                reverse: bool) -> torch.Tensor:
    """One pass of recorded rotations applied to the rows of ``Xp`` (in
    place): backward with (c, -s) for Q2 Z, forward for Q1 Q2."""
    _fp64(Xp, "replay_pass")
    if Xp.device.type == "cpu":
        return ref.replay_pass_ref(Xp, CS, b, n, reverse)
    return kernel.replay_pass(Xp, CS, b, n, reverse)


__all__ = ["rot_apply", "chase_pass", "replay_pass"]
