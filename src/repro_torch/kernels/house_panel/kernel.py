"""ctypes launch wrapper for ``csrc/house_panel.cu`` (the TT1 panel QR).

``house_panel`` replaces ``house_panel_pallas``
(``repro/kernels/house_panel/kernel.py``); the source note in the ``.cu``
file says what bounds the kernel and what its design does about it. The
wrapper checks device, dtype, shape and strides, allocates V, T, the
blocks' partial sums and the zeroed grid-barrier counter with torch, makes
one cooperative launch on the current stream, raises if the launch
reports an error, and adds one to its ``launches`` count per launch. E is
read through its row stride: a column slice of the TT1 window goes in as
it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGS = {
    "house_panel_fp64": ([_P, _L, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "house_panel_scratch_doubles": ([_I, _I], _L),
    "house_panel_max_b": ([], _I),
}


def _lib() -> ctypes.CDLL:
    lib = load("house_panel")
    for fn, (argtypes, restype) in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def house_panel(E: torch.Tensor, row_start: int):
    """(V (rows, b), T (b, b)) of E[row_start:, :] in one launch."""
    if E.device.type != "cuda":
        raise ValueError(f"E must be a CUDA tensor, got {E.device}")
    if E.dtype != torch.float64:
        raise ValueError(f"E must be torch.float64, got {E.dtype}")
    if E.dim() != 2:
        raise ValueError(f"E must be (rows, b), got shape {tuple(E.shape)}")
    rows, b = E.shape
    lib = _lib()
    if not 1 <= b <= lib.house_panel_max_b():
        raise ValueError(f"the panel width must be in [1, "
                         f"{lib.house_panel_max_b()}], got {b}")
    if b > 1 and E.stride(1) != 1:
        E = E.contiguous()
    V = torch.empty((rows, b), dtype=torch.float64, device=E.device)
    T = torch.empty((b, b), dtype=torch.float64, device=E.device)
    if rows == 0:
        return V, T.zero_()
    part = torch.empty((lib.house_panel_scratch_doubles(rows, b),),
                       dtype=torch.float64, device=E.device)
    bar = torch.zeros((1,), dtype=torch.int32, device=E.device)
    err = lib.house_panel_fp64(
        E.data_ptr(), E.stride(0) if rows > 1 else b, V.data_ptr(),
        T.data_ptr(), part.data_ptr(), bar.data_ptr(), rows, b,
        int(row_start), torch.cuda.current_stream(E.device).cuda_stream)
    house_panel.launches += 1
    if err != 0:
        raise RuntimeError(f"house_panel_fp64 failed with cudaError {err}")
    return V, T


house_panel.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"house_panel": house_panel}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
