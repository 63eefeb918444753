"""Atomic, manifest-based checkpointing for trees of tensors.

The on-disk format is ``repro.dist.checkpoint``'s, so either package
reads what the other wrote: one directory per step,
``<dir>/step_<8-digit>/``, holding ``leaf_00000.npy ...`` in the tree's
flattened order and ``manifest.json`` (``step``, ``n_leaves``,
``leaf_paths``, ``extra``). A tree is nested dicts, lists and tuples of
tensors or arrays, flattened in JAX's order (dict keys sorted); each leaf
path is written as ``jax.tree_util.keystr`` writes it (``"['V']"``,
``"[0]"``). Writes go to ``step_*.tmp`` and are renamed into place after
the manifest lands, so a crash mid-write never leaves a directory that
``load_latest`` would trust: directories without a manifest (or still
named ``.tmp``) are skipped.

``load`` returns tensors of the template's dtype on the template's
device. A bfloat16 leaf raises ``TypeError``: numpy cannot hold it.

``lanczos_callback`` is the hook of ``core.lanczos.lanczos_solve``'s
``callback=`` that persists the thick-restart factorization (V, T) every
``every`` restarts.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")
_MANIFEST = "manifest.json"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order: dict keys
    sorted, lists and tuples by index, anything else a leaf."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``
    (consumed from the front)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return out if isinstance(like, list) else type(like)(out)
    return leaves.pop(0)


def _to_numpy(leaf: Any, path: str) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {path} is bfloat16, which a "
                            f".npy file cannot hold")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: Optional[int] = None) -> str:
    """Atomically persist ``tree`` at ``step``; returns the step directory.

    ``extra`` is a small JSON-serializable dict stored in the manifest.
    ``keep`` bounds retention: after a save only the newest ``keep``
    committed steps survive.
    """
    pairs = _flatten(tree)
    arrays = [_to_numpy(leaf, path) for path, leaf in pairs]
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for i, arr in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr,
                allow_pickle=False)
    manifest = {"step": int(step), "n_leaves": len(arrays),
                "leaf_paths": [path for path, _ in pairs],
                "extra": extra or {}}
    # the manifest last: its presence is the commit marker
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    if keep is not None:
        for old in _valid_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return final


def _valid_steps(directory: str) -> List[int]:
    """Ascending step numbers of committed (manifest-bearing) directories."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in entries:
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step, or None when nothing valid exists."""
    steps = _valid_steps(directory)
    return steps[-1] if steps else None


def load(directory: str, step: int, like: Any) -> Tuple[int, Any, dict]:
    """(step, tree, extra) saved at ``step``, in the structure of ``like``:
    each tensor leaf comes back in the template leaf's dtype on its
    device, any other leaf as a CPU tensor of the saved dtype."""
    d = _step_dir(directory, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    refs = [leaf for _, leaf in _flatten(like)]
    n = manifest["n_leaves"]
    if n != len(refs):
        raise ValueError(f"checkpoint at step {step} has {n} leaves; "
                         f"template has {len(refs)}")
    leaves = []
    for i, ref in enumerate(refs):
        t = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy"),
                                     allow_pickle=False))
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        leaves.append(t)
    return manifest["step"], _unflatten(like, leaves), manifest["extra"]


def load_latest(directory: str,
                like: Any) -> Optional[Tuple[int, Any, dict]]:
    """(step, tree, extra) of the newest committed checkpoint, else None."""
    step = latest_step(directory)
    if step is None:
        return None
    return load(directory, step, like)


def lanczos_callback(directory: str, every: int = 1, keep: int = 2):
    """Checkpoint hook for ``lanczos_solve(..., callback=...)``: saves
    ``{"V": V, "T": T}`` every ``every`` restarts (step = restart index)
    with ``extra={"kind": "lanczos", "j": j}``."""

    def callback(k_restart: int, V, T, j) -> None:
        if k_restart % every:
            return
        save(directory, k_restart, {"V": V, "T": T},
             extra={"kind": "lanczos", "j": int(j)}, keep=keep)

    return callback


__all__ = ["save", "load", "load_latest", "latest_step", "lanczos_callback"]
