"""ctypes launch wrapper for ``csrc/syr2k.cu`` (the TT1 trailing update).

``syr2k`` replaces ``syr2k_pallas`` (``repro/kernels/syr2k/kernel.py``);
the source note in the ``.cu`` file says what bounds the kernel and what
its design does about it. The wrapper checks device, dtype, shapes and
strides, allocates the output with ``torch.empty`` unless ``out`` is
given (``out=C`` updates C in place), launches on the current stream,
raises if ``cudaGetLastError`` is not 0, and adds one to its ``launches``
count per launch. C, out, V and W are read through their row strides, so
a window view of a larger matrix goes in as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
_SIG = ([_P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _D, _I, _P], _I)


def _lib() -> ctypes.CDLL:
    lib = load("syr2k")
    lib.syr2k_fp64.argtypes, lib.syr2k_fp64.restype = _SIG
    return lib


def _row_major(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if shape[0] > 1 and shape[1] > 1 and (t.stride(1) != 1
                                          or t.stride(0) < shape[1]):
        raise ValueError(f"{name} must be row-major with unit column "
                         f"stride, got strides {t.stride()}")


def _ld(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def syr2k(C: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
          alpha: float = -1.0, symmetrize: bool = False,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """[sym](C + alpha (V W^T + W V^T)) in one launch; C (n, n), V and W
    (n, k); ``symmetrize`` returns (R + R^T)/2 of that R."""
    if C.device.type != "cuda":
        raise ValueError(f"C must be a CUDA tensor, got {C.device}")
    n = C.shape[0]
    k = V.shape[-1]
    _row_major("C", C, C.device, (n, n))
    # the panels are the small operands: another layout is copied
    V = V if V.stride(-1) == 1 else V.contiguous()
    W = W if W.stride(-1) == 1 else W.contiguous()
    _row_major("V", V, C.device, (n, k))
    _row_major("W", W, C.device, (n, k))
    if out is None:
        out = torch.empty((n, n), dtype=torch.float64, device=C.device)
    _row_major("out", out, C.device, (n, n))
    if n == 0:
        return out
    err = _lib().syr2k_fp64(
        C.data_ptr(), _ld(C), V.data_ptr(), _ld(V), W.data_ptr(), _ld(W),
        out.data_ptr(), _ld(out), n, k, float(alpha), int(bool(symmetrize)),
        torch.cuda.current_stream(C.device).cuda_stream)
    syr2k.launches += 1
    if err != 0:
        raise RuntimeError(f"syr2k_fp64 failed with cudaError {err}")
    return out


syr2k.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"syr2k": syr2k}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
