"""ctypes launch wrapper for ``csrc/band_mv.cu`` (the band product).

``band_mv`` replaces ``band_mv_pallas`` (``repro/kernels/band_mv/
kernel.py``); the source note in the ``.cu`` file says what bounds the
kernel and what its design does about it. The wrapper checks device,
dtype and shapes, allocates y with ``torch.empty``, launches on the
current stream, raises if ``cudaGetLastError`` is not 0, and adds one to
its ``launches`` count per launch. The band is read through both of its
strides, so the transposed view of the TT pipeline's lower band goes in
as it is; x is copied only if it is not contiguous (it is the small
operand).

The kernel is a few microseconds of device work at the main path's
shapes, so the call's cost is the host's: the library handle and its
``argtypes`` are set once (``_lib`` is cached), the stream is read as a
raw handle (``device.current_stream``), and ``band_mv_plan`` (pure
Python, reached by the CPU tests) is cached per shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import current_stream
from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGS = {"band_mv_fp64": [_P, _L, _L, _P, _P, _I, _I, _I, _I, _P],
         "band_mv_empty": [_I, _I, _P]}

#: the staged kernel's most shared memory a block (``kStagedSmemMax``);
#: a larger window takes the direct kernel
STAGED_SMEM_MAX = 48 * 1024


@functools.cache
def band_mv_plan(n: int, w: int, bm: int) -> int:
    """Bytes of shared memory a block of ``bm`` rows stages, or 0 where
    that exceeds ``STAGED_SMEM_MAX`` and the direct kernel runs: the band
    rows [r0 - w, r0 + bm) as the larger of their two layouts (the
    contiguous run of w + 1 columns a row and two words of alignment; or
    diagonal-major, the diagonals d < n, rows padded to odd) and
    x[r0 - w, r0 + bm + w)."""
    wd = min(w, n - 1)
    rows = min(n, bm + wd)
    band = max(rows * (w + 1) + 2, (wd + 1) * (rows | 1))
    smem = 8 * (band + min(n, bm + 2 * wd))
    return smem if smem <= STAGED_SMEM_MAX else 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("band_mv")
    for fn, argtypes in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _enqueue(band: torch.Tensor, x: torch.Tensor, w: int, bm: int,
             smem: int) -> tuple:
    y = torch.empty_like(x)
    s0, s1 = band.stride()
    err = _lib().band_mv_fp64(band.data_ptr(), s0, s1, x.data_ptr(),
                              y.data_ptr(), band.shape[0], w, bm, smem,
                              current_stream(band.device))
    return y, err


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError {err}")


def band_mv_launch(band: torch.Tensor, x: torch.Tensor, w: int, bm: int,
                   smem: int) -> torch.Tensor:
    """One launch of the staged kernel with ``smem`` bytes a block, or of
    the direct kernel where ``smem`` is 0, on checked inputs (n >= 1, x
    contiguous). Counts nothing: ``band_mv`` counts the launches, and
    comparisons and timings call this directly."""
    y, err = _enqueue(band, x, w, bm, smem)
    _raise_on(err, "band_mv_fp64")
    return y


def empty_launch(device: torch.device, n: int, bm: int = 128) -> None:
    """An empty kernel on ``band_mv``'s grid for n rows: the floor one
    launch cannot beat (timings only)."""
    _raise_on(_lib().band_mv_empty(n, bm, current_stream(device)),
              "band_mv_empty")


def band_mv(band: torch.Tensor, x: torch.Tensor, w: int,
            bm: int = 128) -> torch.Tensor:
    """y (n,) = A x for symmetric A in (n, w+1) band storage; ``bm`` rows
    per block (1..1024)."""
    # the checks read plain attributes: this call's cost is the host's
    if not band.is_cuda:
        raise ValueError(f"band must be a CUDA tensor, got {band.device}")
    for name, t in (("band", band), ("x", x)):
        if t.dtype != torch.float64:
            raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if x.get_device() != band.get_device():
        raise ValueError(f"x must be on {band.device}, got {x.device}")
    n = band.shape[0]
    if band.dim() != 2 or band.shape[1] != w + 1:
        raise ValueError(f"band must be (n, w+1) = (n, {w + 1}), got "
                         f"{tuple(band.shape)}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"x must be ({n},), got {tuple(x.shape)}")
    if not 1 <= bm <= 1024:
        raise ValueError(f"bm must be 1..1024 rows per block, got {bm}")
    if n == 0:
        return torch.empty_like(x)
    y, err = _enqueue(band, x.contiguous(), w, bm, band_mv_plan(n, w, bm))
    band_mv.launches += 1
    _raise_on(err, "band_mv_fp64")
    return y


band_mv.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"band_mv": band_mv}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
