"""Dispatch accounting shared by the solver's host loops.

A :class:`DispatchCounter` counts host-side invocations of a stage
routine: ``counter(fn, *args)`` counts 1 and calls ``fn``. The kernel
wrappers keep their own ``launches`` counts (``repro_torch.kernels``);
this counter says how many times a stage was entered, which is what the
reference's ``dispatch_count()`` hooks pin.
"""
from __future__ import annotations


class DispatchCounter:
    """Callable counter: ``counter(fn, *args)`` counts 1 and calls ``fn``."""

    def __init__(self) -> None:
        self._count = 0

    def count(self) -> int:
        return self._count

    def reset(self) -> None:
        self._count = 0

    def __call__(self, fn, *args, **kwargs):
        self._count += 1
        return fn(*args, **kwargs)
