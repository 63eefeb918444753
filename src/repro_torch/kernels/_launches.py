"""Launch counters of the kernel wrappers, one per instance.

A wrapper counts its fp64 instance in ``fn.launches`` (the count's name is
the wrapper's) and, where it has fp32 and bf16 instances, those in
``fn.reduced`` (counted as ``<name>_fp32`` and ``<name>_bf16``), so that
a solve's ``info["kernel_launches"]`` shows which instance ran.
"""
from __future__ import annotations

import torch

#: the suffix of a reduced instance's count, by storage dtype
SUFFIX = {torch.float32: "fp32", torch.bfloat16: "bf16"}
#: the dtypes a kernel with reduced instances takes
DTYPES = (torch.float64, torch.float32, torch.bfloat16)


def instance(name: str, dtype: torch.dtype) -> str:
    """The count name of wrapper ``name``'s instance for ``dtype``."""
    return name if dtype == torch.float64 else f"{name}_{SUFFIX[dtype]}"


def with_reduced(fn):
    """Give wrapper ``fn`` fp32 and bf16 counts beside ``fn.launches``."""
    fn.launches = 0
    fn.reduced = {s: 0 for s in SUFFIX.values()}
    return fn


def count(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s instance for ``dtype``."""
    if dtype == torch.float64:
        fn.launches += 1
    else:
        fn.reduced[SUFFIX[dtype]] += 1


def read(wrappers: dict) -> dict:
    out: dict = {}
    for name, fn in wrappers.items():
        out[name] = fn.launches
        for s, v in getattr(fn, "reduced", {}).items():
            out[f"{name}_{s}"] = v
    return out


def reset(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0
        for s in getattr(fn, "reduced", {}):
            fn.reduced[s] = 0
