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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIG = ([_P, _L, _L, _P, _P, _I, _I, _I, _P], _I)


def _lib() -> ctypes.CDLL:
    lib = load("band_mv")
    lib.band_mv_fp64.argtypes, lib.band_mv_fp64.restype = _SIG
    return lib


def band_mv(band: torch.Tensor, x: torch.Tensor, w: int,
            bm: int = 128) -> torch.Tensor:
    """y (n,) = A x for symmetric A in (n, w+1) band storage; ``bm`` rows
    per block (1..1024)."""
    if band.device.type != "cuda":
        raise ValueError(f"band must be a CUDA tensor, got {band.device}")
    for name, t in (("band", band), ("x", x)):
        if t.dtype != torch.float64:
            raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if x.device != band.device:
        raise ValueError(f"x must be on {band.device}, got {x.device}")
    n = band.shape[0]
    if band.dim() != 2 or band.shape[1] != w + 1:
        raise ValueError(f"band must be (n, w+1) = (n, {w + 1}), got "
                         f"{tuple(band.shape)}")
    if tuple(x.shape) != (n,):
        raise ValueError(f"x must be ({n},), got {tuple(x.shape)}")
    if not 1 <= bm <= 1024:
        raise ValueError(f"bm must be 1..1024 rows per block, got {bm}")
    y = torch.empty((n,), dtype=torch.float64, device=band.device)
    if n == 0:
        return y
    x = x.contiguous()
    err = _lib().band_mv_fp64(band.data_ptr(), band.stride(0), band.stride(1),
                              x.data_ptr(), y.data_ptr(), n, w, bm,
                              torch.cuda.current_stream(band.device).cuda_stream)
    band_mv.launches += 1
    if err != 0:
        raise RuntimeError(f"band_mv_fp64 failed with cudaError {err}")
    return y


band_mv.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"band_mv": band_mv}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
