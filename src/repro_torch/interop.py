"""Carry the reference's state across: the pencil and the random starts.

The solver has no weights. What a parity run hands over is the pencil
(A, B and its exact spectrum) and the random starts the reference drew
from ``jax.random`` (TD2's inverse-iteration block, the Lanczos start
block, the filter probe and the refinement's guard block) — torch cannot
replay threefry. Arrays cross
as numpy; ``np.array`` copies first, because ``np.asarray`` of a jax
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
    """A random start the reference drew, as ``solve`` takes it: TD2's
    (n, s) block in the column order of the sorted wanted indices
    (``x0=``), the (n, p) Lanczos start block (``v0=``) or the filter
    probe's (n,) vector (``probe_v0=``)."""
    return _tensor(X0, resolve_device(device))


def guard_block_from_numpy(G0, device=None) -> torch.Tensor:
    """The refinement's (n, guard) guard block as the reference draws it
    (``normal(PRNGKey(1203), (n, guard))``), for ``refine_eigenpairs``'s
    and ``solve``'s ``guard0=``."""
    return _tensor(G0, resolve_device(device))
