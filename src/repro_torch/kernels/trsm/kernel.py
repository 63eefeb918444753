"""ctypes launch wrapper for ``csrc/trsm.cu`` (the diagonal-tile solve).

``trsm_tile`` replaces the reference's ``trsm_tile``
(``repro/kernels/trsm/kernel.py``); the source note in the ``.cu`` file
says what bounds the kernel and what its design does about it (a warp a
column; ``warps`` picks the columns of a block). The
wrapper checks device, dtype, shapes and strides, solves in place on X,
launches on the current stream, raises if ``cudaGetLastError`` is not 0,
and adds one to its ``launches`` count per launch. U and X are read
through their row strides (a diagonal tile of a larger U and a block row
of a larger X go in as they are); another layout raises.
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
_SIG = ([_P, _L, _P, _L, _I, _I, _I, _I, _P], _I)

#: the largest tile the kernel holds in shared memory
MAX_B = 128
#: the most columns (warps) of one block
MAX_WARPS = 32
#: SMs of an H100
SMS = 132


def warps(s: int) -> int:
    """The RHS columns of one block (a warp each). The columns of one SM
    share its fp64 pipe, so fewer a block run faster, but each block
    loads the tile again: at least 4, and enough that the s columns fill
    two waves of two blocks an SM (two blocks of up to 23 warps fit one
    at the kernel's 44 registers a thread); at most ``MAX_WARPS``. s = 100
    gives 4 (25 blocks), s = 9997 gives 19 (527 blocks)."""
    return max(4, min(MAX_WARPS, -(-s // (4 * SMS))))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("trsm")
    lib.trsm_tile_fp64.argtypes, lib.trsm_tile_fp64.restype = _SIG
    return lib


def _row_major(name: str, t: torch.Tensor, device, shape: tuple) -> int:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    rows, cols = shape
    sr, sc = t.stride()
    if rows > 1 and cols > 1 and (sc != 1 or sr < cols):
        raise ValueError(f"{name} must be row-major with unit column "
                         f"stride, got strides {(sr, sc)}")
    # one column: element (r, 0) lies at r * stride(0)
    return sr if rows > 1 else cols


def trsm_tile(U: torch.Tensor, X: torch.Tensor,
              trans: bool = False) -> torch.Tensor:
    """X (b, s) <- U^{-1} X, or U^{-T} X with ``trans``, in place; U a
    (b, b) upper-triangular tile, b <= ``MAX_B``. Returns X."""
    if U.device.type != "cuda":
        raise ValueError(f"U must be a CUDA tensor, got {U.device}")
    if U.dim() != 2 or X.dim() != 2:
        raise ValueError(f"U and X must be 2-D, got shapes "
                         f"{tuple(U.shape)} and {tuple(X.shape)}")
    b, s = X.shape
    if not 1 <= b <= MAX_B:
        raise ValueError(f"the tile must have 1 to {MAX_B} rows, got {b}")
    dev = U.device
    ldu = _row_major("U", U, dev, (b, b))
    ldx = _row_major("X", X, dev, (b, s))
    if s == 0:
        return X
    err = _lib().trsm_tile_fp64(U.data_ptr(), ldu, X.data_ptr(), ldx, b, s,
                                int(bool(trans)), warps(s),
                                current_stream(dev))
    trsm_tile.launches += 1
    if err != 0:
        raise RuntimeError(f"trsm_tile_fp64 failed with cudaError {err}")
    return X


trsm_tile.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"trsm_tile": trsm_tile}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
