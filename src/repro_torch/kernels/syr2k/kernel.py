"""ctypes launch wrapper for ``csrc/syr2k.cu`` (the TT1 trailing update).

``syr2k`` replaces ``syr2k_pallas`` (``repro/kernels/syr2k/kernel.py``);
the source note in the ``.cu`` file says what bounds the kernel and what
its design does about it. The wrapper checks device, dtype (float64, or
the float32 and bfloat16 instances), shapes and strides, allocates the
output with ``torch.empty`` unless ``out`` is given (``out=C`` updates C
in place), launches on the current stream, raises if ``cudaGetLastError``
is not 0, and adds one to the count of the instance it launched
(``kernels/_launches.py``). C, out, V and W are read through their row
strides, so a window view of a larger matrix goes in as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launches
from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
_SIG = ([_P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _D, _I, _P], _I)
#: the C entry point of each instance
ENTRY = {torch.float64: "syr2k_fp64", torch.float32: "syr2k_fp32",
         torch.bfloat16: "syr2k_bf16"}


def _lib() -> ctypes.CDLL:
    lib = load("syr2k")
    for fn in ENTRY.values():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = _SIG
    return lib


def _row_major(name: str, t: torch.Tensor, device, shape: tuple,
               dtype=torch.float64) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
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
    if C.dtype not in ENTRY:
        raise ValueError(f"C must be one of {tuple(ENTRY)}, got {C.dtype}")
    n = C.shape[0]
    k = V.shape[-1]
    dt = C.dtype
    _row_major("C", C, C.device, (n, n), dt)
    # the panels are the small operands: another layout is copied
    V = V if V.stride(-1) == 1 else V.contiguous()
    W = W if W.stride(-1) == 1 else W.contiguous()
    _row_major("V", V, C.device, (n, k), dt)
    _row_major("W", W, C.device, (n, k), dt)
    if out is None:
        out = torch.empty((n, n), dtype=dt, device=C.device)
    _row_major("out", out, C.device, (n, n), dt)
    if n == 0:
        return out
    err = getattr(_lib(), ENTRY[dt])(
        C.data_ptr(), _ld(C), V.data_ptr(), _ld(V), W.data_ptr(), _ld(W),
        out.data_ptr(), _ld(out), n, k, float(alpha), int(bool(symmetrize)),
        torch.cuda.current_stream(C.device).cuda_stream)
    _launches.count(syr2k, dt)
    if err != 0:
        raise RuntimeError(f"{ENTRY[dt]} failed with cudaError {err}")
    return out


_launches.with_reduced(syr2k)

#: every kernel wrapper of this module, by name
WRAPPERS = {"syr2k": syr2k}


def reset_launches() -> None:
    _launches.reset(WRAPPERS)


def launch_counts() -> dict:
    return _launches.read(WRAPPERS)
