"""Carry the reference's state across: the pencil, the random starts and
the LM weights.

What a solver parity run hands over is the pencil (A, B and its exact
spectrum) and the random starts the reference drew from ``jax.random``
(TD2's inverse-iteration block, the Lanczos start block, the filter probe
and the refinement's guard block) — torch cannot replay threefry. An LM
parity run hands over the reference's ``init_params`` tree. Arrays cross
as numpy; ``np.array`` copies first, because ``np.asarray`` of a jax
array is read-only and ``torch.from_numpy`` warns on it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.problems import GSyEigProblem
from repro_torch.device import resolve_device
from repro_torch.models.model import LM, layer_plan


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


def _leaves(tree, prefix: str):
    """(dotted path, leaf) of a nested dict/tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}.{i}")
    else:
        yield prefix, tree


def lm_params_from_numpy(tree, cfg, device=None):
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    ``LM``. The tree holds ``embed``, ``ln_f``, ``blocks`` (one subtree a
    period position, each leaf leading with the repeats R), ``tail`` and,
    for encoder-decoder models, ``encoder`` and ``ln_enc``; leaf ``r`` of
    ``blocks[i]`` is layer ``r * P + i`` and ``tail[t]`` is layer
    ``P * R + t`` (``models.model.layer_plan``). Every leaf must land on a
    parameter of the same shape, and every parameter must get a leaf."""
    model = LM(cfg, device=resolve_device(device))
    _, P, R, _ = layer_plan(cfg)
    named = dict(model.named_parameters())
    loaded = set()

    def put(name: str, leaf) -> None:
        if name not in named:
            raise KeyError(f"the reference leaf {name} has no parameter")
        arr = np.array(leaf)
        t = named[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"shape {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(arr))
        loaded.add(name)

    for top in ("embed", "ln_f", "ln_enc", "encoder"):
        if top in tree:
            for name, leaf in _leaves(tree[top], top):
                put(name, leaf)
    for i, block in enumerate(tree["blocks"]):
        for path, leaf in _leaves(block, ""):
            for r in range(R):
                put(f"layers.{r * P + i}{path}", leaf[r])
    for t, layer in enumerate(tree["tail"]):
        for path, leaf in _leaves(layer, ""):
            put(f"layers.{P * R + t}{path}", leaf)
    missing = sorted(set(named) - loaded)
    if missing:
        raise KeyError(f"parameters with no reference leaf: {missing}")
    return model
