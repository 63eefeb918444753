"""Launch counters of the kernel wrappers, one per instance.

A wrapper counts its fp64 instance in ``fn.launches`` (the count's name is
the wrapper's) and, where it has fp32 and bf16 instances, those in
``fn.reduced`` (counted as ``<name>_fp32`` and ``<name>_bf16``), so that
a solve's ``info["kernel_launches"]`` shows which instance ran.

The reduced product and ``syr2k`` have two load paths, which
``load_path`` picks from the operands' alignment: ``wide``, 16-byte
loads (``csrc/symv.cu``'s ``symm_wide``, ``csrc/syr2k.cu``'s
``syr2k_pairs``), and ``narrow``, entry by entry (``symm_wide``'s other
instance, ``syr2k_tiles``). Each path counts apart in ``fn.paths``
(``<name>_<fp32|bf16>_<wide|narrow>``, read by ``read_paths``). The
reduced panel, chase and replay count their launches by kernel the same
way (``cluster``/``cooperative``, ``slab``/``sweep``: their plans'
paths).

A *recording* (``recording()``) is the device-blind view of the same
calls, for the audit (``analysis/static_audit``): while one is active,
each ops dispatch of the eight families notes the launches its kernel
path makes for the call (``note``), under the names of
``launch_counts()``, on the CPU branch as on the CUDA one. The counts
above are untouched by it: they count real CUDA launches, so on the card
a recording's calls equal their deltas instance by instance exactly when
no recorded call took the plain version. With no recording active a
note costs one test of an empty list.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, Iterator, Optional

import torch

#: the suffix of a reduced instance's count, by storage dtype
SUFFIX = {torch.float32: "fp32", torch.bfloat16: "bf16"}
#: the dtypes a kernel with reduced instances takes
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
#: the two load paths of the reduced product and ``syr2k``, and the
#: reduced C entries' path codes
WIDE, NARROW = "wide", "narrow"
PATH_CODE = {NARROW: 0, WIDE: 1}
#: bytes of one vector load on the wide path
ALIGN = 16


def load_path(esize: int, *views) -> str:
    """``WIDE`` when every (data_ptr, row stride in entries) pair of
    ``views`` starts on a 16-byte boundary and steps by a multiple of 16
    bytes from row to row, so that each 16-byte vector of a row (entries
    j..j + 16/esize - 1, j a multiple of 16/esize) is aligned; else
    ``NARROW``."""
    ok = all(ptr % ALIGN == 0 and (ld * esize) % ALIGN == 0
             for ptr, ld in views)
    return WIDE if ok else NARROW


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


def with_paths(fn, paths=(WIDE, NARROW)) -> None:
    """Give wrapper ``fn`` a count per path (by default the load paths) of
    its fp32 and bf16 instances."""
    fn.paths = {f"{sfx}_{p}": 0 for sfx in SUFFIX.values() for p in paths}


def count_path(fn, dtype: torch.dtype, path: str) -> None:
    """One launch of ``fn``'s ``dtype`` instance on ``path``."""
    fn.paths[f"{SUFFIX[dtype]}_{path}"] += 1


def read_paths(wrappers: dict) -> dict:
    return {f"{name}_{key}": v for name, fn in wrappers.items()
            for key, v in getattr(fn, "paths", {}).items()}


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
        for key in getattr(fn, "paths", {}):
            fn.paths[key] = 0


class Recording:
    """The kernel launches noted while it is active, by instance
    (``calls``); ``hook(instance, k)``, where given, sees each note as it
    comes (the audit splits a run into steps by it)."""

    def __init__(self, hook: Optional[Callable[[str, int], None]] = None):
        self.calls: Counter = Counter()
        self.hook = hook


_ACTIVE: list = []


@contextlib.contextmanager
def recording(hook: Optional[Callable[[str, int], None]] = None
              ) -> Iterator[Recording]:
    """A ``Recording`` of the notes made inside the ``with`` block."""
    rec = Recording(hook)
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def recording_active() -> bool:
    return bool(_ACTIVE)


def note(name: str, dtype: torch.dtype = torch.float64, k: int = 1) -> None:
    """``k`` launches of wrapper ``name``'s ``dtype`` instance, noted by an
    ops dispatch on either branch; nothing unless a recording is active."""
    if not _ACTIVE or not k:
        return
    inst = instance(name, dtype)
    for rec in _ACTIVE:
        rec.calls[inst] += k
        if rec.hook is not None:
            rec.hook(inst, k)
