"""ctypes launch wrappers for ``csrc/house_panel.cu`` (the TT1 panel QR).

``house_panel`` replaces ``house_panel_pallas``
(``repro/kernels/house_panel/kernel.py``); the source note in the ``.cu``
file says what bounds the kernels and what their design does about it.
``house_plan`` (pure Python, reached by the CPU tests) picks the path by
size: the active rows E[row_start:] in the distributed shared memory of
one thread-block cluster where they fit, else the cooperative kernel
(blocks across the card, a grid barrier twice a reflector). The wrapper
checks device, dtype, shape and strides, allocates V and T with torch
(the cooperative path's partials and barrier counter are cached per
device, width and stream; the counter is zeroed before each cooperative
launch), makes one launch on the current stream, raises if the launch
reports an error, and adds one to the count of the instance it launched
(``kernels/_launches.py``). E is read through its row stride: a column
slice of the TT1 window goes in as it is.

Below fp64 the wrapper takes the same plan, by dtype: a float32 panel is
factored in fp32, a bfloat16 panel in fp32 with V and T rounded to bf16
at the store. Both kernels have fp32 and bf16 instances. The cluster
kernel holds the rows in the compute type, 4 bytes an entry for fp32 and
for bf16 alike (``HOUSE_ENTRY``; the TPU kernel's bf16 path computes in
fp32, and the reduced chase shares fp32's layout the same way), so at 4
bytes a cluster holds panels twice as tall as at fp64; the cooperative
kernel takes what no cluster holds. The reduced launches also count by
path (``path_counts``: ``house_panel_fp32_cluster``,
``house_panel_bf16_cooperative``, ...). There is no fallback: a launch
or a capacity query that fails raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import current_stream
from repro_torch.kernels import _launches
from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGS = {
    "house_panel_fp64": ([_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "house_panel_fp32": ([_P, _L, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "house_panel_bf16": ([_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "house_panel_scratch_doubles": ([_I], _L),
}
#: the suffix of each instance's C entry points
_SFX = {torch.float64: "fp64", torch.float32: "fp32", torch.bfloat16: "bf16"}
for _sfx in _SFX.values():
    _SIGS[f"house_cluster_{_sfx}"] = (
        [_P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I)
    _SIGS[f"house_cluster_capacity_{_sfx}"] = ([_I, _I], _I)

#: the widest panel (the kernels' kMaxB), the cluster kernel's threads and
#: warps, its cluster sizes (16 is non-portable), and the largest dynamic
#: shared memory of a CTA on the card
MAX_B = 128
CLUSTER_THREADS = 512
CLUSTER_WARPS = CLUSTER_THREADS // 32
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMEM_MAX = 232448
#: bytes of an entry in the cluster kernel's shared memory, by storage
#: dtype: the compute type's (bf16 panels are held as fp32 values)
HOUSE_ENTRY = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 4}
#: the active rows a CTA should hold at most where a smaller cluster
#: allows, at every entry size: set for fp64 in the first cluster design,
#: and kept at 4 bytes, where 16 CTAs of 624 rows beat 8 and 4 at the
#: first MD panel (timed in turns, PERF.md)
ROWS_PER_CTA = 640
#: ``mode`` of ``house_launch``: the factorization, or a timing variant
#: (its barriers alone; no barrier, the cooperative kernel only; every
#: cross-block sum replaced by the block's own partial)
FULL, BARRIER_ONLY, NO_BARRIER, NO_SUMS = range(4)


class HousePlan(NamedTuple):
    path: str     # "cluster" (rows in distributed shared memory) or
    #               "cooperative" (blocks across the card, grid barriers)
    csize: int    # CTAs of the cluster (0 on the cooperative path)
    rpc: int      # active rows a CTA holds
    smem: int     # bytes of dynamic shared memory a CTA


#: the cooperative kernel's plan
COOPERATIVE = HousePlan("cooperative", 0, 0, 0)


def cluster_extra_entries(b: int) -> int:
    """Entries of the compute type in a cluster CTA's shared memory besides
    its rows (the kernel's ``cluster_extra_entries``): T, two slots of
    partials and of the pivot row, the block reduction, the sums, pivot
    row and projections."""
    cw = 1 << max(b - 1, 0).bit_length()
    return b * b + 4 * b + CLUSTER_WARPS * cw + 3 * b


def cluster_at(active: int, b: int, csize: int,
               dtype: torch.dtype = torch.float64) -> HousePlan:
    """The cluster plan of ``csize`` CTAs for ``active`` rows of width b
    of ``dtype``: rows a CTA, and its shared memory at ``HOUSE_ENTRY``
    bytes an entry (which may pass ``SMEM_MAX``: ``house_plan`` checks)."""
    rpc = max(1, -(-active // csize))
    return HousePlan("cluster", csize, rpc, HOUSE_ENTRY[dtype] * (
        rpc * b + cluster_extra_entries(b)))


@functools.cache
def house_plan(active: int, b: int, capacity=None,
               dtype: torch.dtype = torch.float64) -> HousePlan:
    """The cluster path for ``active`` = rows - row_start rows of width b
    of ``dtype`` where they fit 16 CTAs' shared memory: the fewest CTAs
    (1, 2, 4, 8, 16) that hold at most ``ROWS_PER_CTA`` rows each, or 16,
    among the sizes the card runs
    (``capacity(csize, dtype)``, the clusters of that size and instance
    with the most shared memory it holds at once; None counts every size);
    else the cooperative path."""
    for csize in CLUSTER_SIZES:
        plan = cluster_at(active, b, csize, dtype)
        if plan.rpc > ROWS_PER_CTA and csize < CLUSTER_SIZES[-1]:
            continue
        if plan.smem <= SMEM_MAX and (capacity is None
                                      or capacity(csize, dtype) > 0):
            return plan
    return COOPERATIVE


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("house_panel")
    for fn, (argtypes, restype) in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


@functools.cache
def cluster_capacity(csize: int, dtype: torch.dtype = torch.float64) -> int:
    """Clusters of ``csize`` CTAs of the ``dtype`` instance with the most
    shared memory that the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = f"house_cluster_capacity_{_SFX[dtype]}"
    got = getattr(_lib(), fn)(csize, SMEM_MAX)
    if got < 0:
        raise RuntimeError(f"{fn} failed with cudaError {-got}")
    return got


@functools.cache
def _scratch(device: torch.device, b: int, stream: int,
             dtype: torch.dtype):
    """The cooperative path's partials (in the compute dtype: fp32 for the
    reduced instances), grid-barrier counter and, for bf16, the fp32 T it
    works on; one set per device, width, stream and dtype: launches on one
    stream run in order, so they can share it; launches on two streams
    could race on one set."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    part = torch.empty((_lib().house_panel_scratch_doubles(b),), dtype=acc,
                       device=device)
    Tw = torch.empty((b, b), dtype=acc, device=device)
    return part, torch.zeros((1,), dtype=torch.int32, device=device), Tw


def _check(E: torch.Tensor) -> torch.Tensor:
    if E.device.type != "cuda":
        raise ValueError(f"E must be a CUDA tensor, got {E.device}")
    if E.dtype not in _launches.DTYPES:
        raise ValueError(f"E must be one of {_launches.DTYPES}, got "
                         f"{E.dtype}")
    if E.dim() != 2:
        raise ValueError(f"E must be (rows, b), got shape {tuple(E.shape)}")
    if not 1 <= E.shape[1] <= MAX_B:
        raise ValueError(f"the panel width must be in [1, {MAX_B}], got "
                         f"{E.shape[1]}")
    return E.contiguous() if E.shape[1] > 1 and E.stride(1) != 1 else E


def house_panel(E: torch.Tensor, row_start: int):
    """(V (rows, b), T (b, b)) of E[row_start:, :] in one launch of the
    path ``house_plan`` picks."""
    E = _check(E)
    rows, b = E.shape
    V = torch.empty((rows, b), dtype=E.dtype, device=E.device)
    T = torch.empty((b, b), dtype=E.dtype, device=E.device)
    if rows == 0:
        return V, T.zero_()
    plan = house_plan(max(rows - int(row_start), 0), b, cluster_capacity,
                      E.dtype)
    house_launch(E, int(row_start), V, T, plan, FULL)
    _launches.count(house_panel, E.dtype)
    if E.dtype != torch.float64:
        _launches.count_path(house_panel, E.dtype, plan.path)
    return V, T


def house_launch(E: torch.Tensor, row_start: int, V: torch.Tensor,
                 T: torch.Tensor, plan: HousePlan, mode: int) -> None:
    """One launch of the kernel of ``plan`` (``COOPERATIVE`` forces that
    path) in ``mode`` into V and T; raises on a CUDA error. Counts nothing:
    ``house_panel`` counts the main path's launches, and comparisons and
    timings call this directly."""
    rows, b = E.shape
    lde = E.stride(0) if rows > 1 else b
    stream = current_stream(E.device)
    lib = _lib()
    if plan.path == "cluster":
        fn = f"house_cluster_{_SFX[E.dtype]}"
        err = getattr(lib, fn)(E.data_ptr(), lde, V.data_ptr(), T.data_ptr(),
                               rows, b, row_start, plan.csize, plan.rpc,
                               plan.smem, mode, stream)
        if err != 0:
            raise RuntimeError(f"{fn} failed with cudaError {err}")
        return
    part, bar, Tw = _scratch(E.device, b, stream, E.dtype)
    bar.zero_()
    if E.dtype == torch.float64:
        err = lib.house_panel_fp64(E.data_ptr(), lde, V.data_ptr(),
                                   T.data_ptr(), part.data_ptr(),
                                   bar.data_ptr(), rows, b, row_start, mode,
                                   stream)
    elif mode != FULL:
        raise ValueError("the cooperative kernel's fp32 and bf16 instances "
                         "have its full factorization only")
    elif E.dtype == torch.float32:
        err = lib.house_panel_fp32(E.data_ptr(), lde, V.data_ptr(),
                                   T.data_ptr(), part.data_ptr(),
                                   bar.data_ptr(), rows, b, row_start, stream)
    else:
        err = lib.house_panel_bf16(E.data_ptr(), lde, V.data_ptr(),
                                   T.data_ptr(), Tw.data_ptr(),
                                   part.data_ptr(), bar.data_ptr(), rows, b,
                                   row_start, stream)
    if err != 0:
        raise RuntimeError(f"house_panel_{_SFX[E.dtype]} failed with "
                           f"cudaError {err}")


_launches.with_reduced(house_panel)
_launches.with_paths(house_panel, ("cluster", "cooperative"))

#: every kernel wrapper of this module, by name
WRAPPERS = {"house_panel": house_panel}


def reset_launches() -> None:
    _launches.reset(WRAPPERS)


def launch_counts() -> dict:
    return _launches.read(WRAPPERS)


def path_counts() -> dict:
    return _launches.read_paths(WRAPPERS)
