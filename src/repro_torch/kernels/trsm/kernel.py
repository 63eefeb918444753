"""ctypes launch wrapper for ``csrc/trsm.cu`` (the diagonal-tile solve).

``trsm_tile`` replaces the reference's ``trsm_tile``
(``repro/kernels/trsm/kernel.py``); the source note in the ``.cu`` file
says what bounds the kernel and what its design does about it. The
wrapper checks device, dtype, shapes and strides, solves in place on X,
launches on the current stream, raises if ``cudaGetLastError`` is not 0,
and adds one to its ``launches`` count per launch. U and X are read
through their row strides (a diagonal tile of a larger U and a block row
of a larger X go in as they are); another layout raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIG = ([_P, _L, _P, _L, _I, _I, _I, _P], _I)

#: the largest tile the kernel holds in shared memory
MAX_B = 128


def _lib() -> ctypes.CDLL:
    lib = load("trsm")
    lib.trsm_tile_fp64.argtypes, lib.trsm_tile_fp64.restype = _SIG
    return lib


def _row_major(name: str, t: torch.Tensor, device, shape: tuple) -> int:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    rows, cols = shape
    if rows > 1 and cols > 1 and (t.stride(1) != 1 or t.stride(0) < cols):
        raise ValueError(f"{name} must be row-major with unit column "
                         f"stride, got strides {t.stride()}")
    if cols == 1 and rows > 1:
        # one column: element (r, 0) lies at r * stride(0)
        return t.stride(0)
    return t.stride(0) if rows > 1 else cols


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
    ldu = _row_major("U", U, U.device, (b, b))
    ldx = _row_major("X", X, U.device, (b, s))
    if s == 0:
        return X
    err = _lib().trsm_tile_fp64(U.data_ptr(), ldu, X.data_ptr(), ldx, b, s,
                                int(bool(trans)),
                                torch.cuda.current_stream(U.device).cuda_stream)
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
