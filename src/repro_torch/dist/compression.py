"""Error-feedback int8 gradient compression (EF-SGD / 1-bit-Adam family).

Per leaf: carry ``c = g + e`` (gradient plus accumulated quantization
error), quantize to int8 with a per-leaf absmax scale, and fold the
residual back into the error state. The telescoping identity

    sum_t decompress(q_t) = sum_t g_t - e_final

means signals far below one quantization step still get transmitted
eventually. The wire format is an int8 tree plus one float32 scale per
leaf. Trees are nested dicts, lists and tuples of tensors, as
``repro.dist.compression`` takes them.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

_QMAX = 127.0


def _map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        out = [_map(fn, *parts) for parts in zip(*trees)]
        return out if isinstance(head, list) else type(head)(out)
    return fn(*trees)


def init_ef_state(grads: Any) -> Any:
    """Zero float32 error-feedback accumulator shaped like ``grads``."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def _one(g: torch.Tensor, e: torch.Tensor):
    c = g.to(torch.float32) + e
    scale = torch.clamp_min(torch.max(torch.abs(c)) / _QMAX,
                            torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(c / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale, c - q.to(torch.float32) * scale


def _unzip3(fn: Callable, grads: Any, ef: Any) -> Tuple[Any, Any, Any]:
    """``fn`` (returning a triple) over the leaves of two trees of one
    structure, as three trees."""
    if isinstance(grads, dict):
        parts = {k: _unzip3(fn, grads[k], ef[k]) for k in grads}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(3))
    if isinstance(grads, (list, tuple)):
        parts = [_unzip3(fn, g, e) for g, e in zip(grads, ef)]
        kind = list if isinstance(grads, list) else type(grads)
        return tuple(kind([p[i] for p in parts]) for i in range(3))
    return fn(grads, ef)


def compress_with_feedback(grads: Any, ef: Any) -> Tuple[Any, Any, Any]:
    """(int8 tree, per-leaf float32 scale tree, new error state).

    The quantization error per element is at most ``scale / 2``; all that
    the wire loses lands in the returned error state."""
    return _unzip3(_one, grads, ef)


def decompress(q: Any, scales: Any) -> Any:
    """Dequantize an int8 tree back to float32."""
    return _map(lambda qq, ss: qq.to(torch.float32) * ss, q, scales)


__all__ = ["init_ef_state", "compress_with_feedback", "decompress"]
