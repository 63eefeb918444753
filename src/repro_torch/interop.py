"""Carry the reference's state across: the pencil, the random starts, the
LM weights and the LM training state.

What a solver parity run hands over is the pencil (A, B and its exact
spectrum) and the random starts the reference drew from ``jax.random``
(TD2's inverse-iteration block, the Lanczos start block, the filter probe
and the refinement's guard block) — torch cannot replay threefry. An LM
parity run hands over the reference's ``init_params`` tree (or its
``TrainState``, and flat vectors in its ``ravel_pytree`` order). Arrays cross
as numpy; ``np.array`` copies first, because ``np.asarray`` of a jax
array is read-only and ``torch.from_numpy`` warns on it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.problems import GSyEigProblem
from repro_torch.device import resolve_device
from repro_torch.models.model import LM, layer_plan
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainState


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


def _reference_leaves(tree, cfg):
    """(port parameter name, numpy leaf) of the reference's ``init_params``
    tree, blocks unstacked by the layer plan: leaf ``r`` of ``blocks[i]``
    is layer ``r * P + i`` and ``tail[t]`` is layer ``P * R + t``."""
    _, P, R, _ = layer_plan(cfg)
    for top in ("embed", "ln_f", "ln_enc", "encoder"):
        if top in tree:
            for name, leaf in _leaves(tree[top], top):
                yield name, np.array(leaf)
    for i, block in enumerate(tree["blocks"]):
        for path, leaf in _leaves(block, ""):
            for r in range(R):
                yield f"layers.{r * P + i}{path}", np.array(leaf[r])
    for t, layer in enumerate(tree["tail"]):
        for path, leaf in _leaves(layer, ""):
            yield f"layers.{P * R + t}{path}", np.array(leaf)


def _fill(named: dict, leaves, what: str) -> None:
    """Copy each (name, array) of ``leaves`` into ``named[name]``: every
    leaf must land on a tensor of its shape, and every tensor must get a
    leaf."""
    loaded = set()
    with torch.no_grad():
        for name, arr in leaves:
            if name not in named:
                raise KeyError(f"the reference leaf {name} has no {what}")
            t = named[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, "
                                 f"port shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
            loaded.add(name)
    missing = sorted(set(named) - loaded)
    if missing:
        raise KeyError(f"{what}s with no reference leaf: {missing}")


def lm_params_from_numpy(tree, cfg, device=None):
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    ``LM``. The tree holds ``embed``, ``ln_f``, ``blocks`` (one subtree a
    period position, each leaf leading with the repeats R), ``tail`` and,
    for encoder-decoder models, ``encoder`` and ``ln_enc``; leaf ``r`` of
    ``blocks[i]`` is layer ``r * P + i`` and ``tail[t]`` is layer
    ``P * R + t`` (``models.model.layer_plan``). Every leaf must land on a
    parameter of the same shape, and every parameter must get a leaf."""
    model = LM(cfg, device=resolve_device(device))
    _fill(dict(model.named_parameters()), _reference_leaves(tree, cfg),
          "parameter")
    return model


def train_state_from_numpy(tree, cfg, device=None):
    """The reference's ``TrainState`` (numpy leaves, e.g. ``jax.tree.map(
    np.asarray, state)``: ``params``, ``opt.mu``, ``opt.nu``,
    ``opt.count``, ``step``) as the port's ``TrainState``: the params
    through ``lm_params_from_numpy``, the moments (the params' tree)
    through the same mapping onto the port's names."""
    params = lm_params_from_numpy(tree.params, cfg, device=device)
    opt = init_opt_state(params)
    _fill(opt.mu, _reference_leaves(tree.opt.mu, cfg), "first moment")
    _fill(opt.nu, _reference_leaves(tree.opt.nu, cfg), "second moment")
    opt.count.fill_(int(np.asarray(tree.opt.count)))
    step = torch.full((), int(np.asarray(tree.step)), dtype=torch.int32,
                      device=opt.count.device)
    return TrainState(params=params, opt=opt, step=step)


def _flat_index(tree, cfg) -> np.ndarray:
    """For each entry of the port's flat parameter vector (the ``LM``'s
    ``named_parameters()`` order, each raveled row-major:
    ``train.spectral.flat_params``), its index in the reference's
    ``ravel_pytree`` vector of the ``init_params`` tree ``tree`` (JAX's
    flattening order: dict keys sorted, tuples by index)."""
    _, P, R, _ = layer_plan(cfg)
    start = {}
    offset = 0
    for path, leaf in _leaves(tree, ""):
        shape = np.shape(leaf)
        size = int(np.prod(shape))
        top, _, rest = path[1:].partition(".")
        if top == "blocks":
            i, _, sub = rest.partition(".")
            per = size // R
            for r in range(R):
                start[f"layers.{r * P + int(i)}.{sub}"] = offset + r * per
        elif top == "tail":
            t, _, sub = rest.partition(".")
            start[f"layers.{P * R + int(t)}.{sub}"] = offset
        else:
            start[path[1:]] = offset
        offset += size
    port = LM(cfg, device="meta")
    return np.concatenate([
        np.arange(start[name], start[name] + p.numel())
        for name, p in port.named_parameters()])


def reference_flat_to_port(vec, tree, cfg) -> np.ndarray:
    """A vector in the reference's ``ravel_pytree`` order of ``tree`` (the
    reference's ``init_params`` tree, or any tree of its structure) in the
    port's flat order."""
    return np.asarray(vec)[_flat_index(tree, cfg)]


def port_flat_to_reference(vec, tree, cfg) -> np.ndarray:
    """The inverse of ``reference_flat_to_port``."""
    vec = np.asarray(vec)
    out = np.empty_like(vec)
    out[_flat_index(tree, cfg)] = vec
    return out
