"""Carry the reference's state across: the pencil and the random start block.

The solver has no weights. What a parity run hands over is the pencil
(A, B and its exact spectrum) and the inverse-iteration start block the
reference drew from ``jax.random`` — torch cannot replay threefry. Arrays
cross as numpy; ``np.array`` copies first, because ``np.asarray`` of a jax
array is read-only and ``torch.from_numpy`` warns on it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.problems import GSyEigProblem
from repro_torch.device import resolve_device


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float64)).to(device)


def problem_from_numpy(A, B, exact_evals, name: str,
                       device=None) -> GSyEigProblem:
    dev = resolve_device(device)
    return GSyEigProblem(A=_tensor(A, dev), B=_tensor(B, dev),
                         exact_evals=_tensor(exact_evals, dev), name=name)


def start_block_from_numpy(X0, device=None) -> torch.Tensor:
    """The (n, s) start block, in the column order of the sorted wanted
    indices, as ``solve(..., x0=)`` takes it."""
    return _tensor(X0, resolve_device(device))
