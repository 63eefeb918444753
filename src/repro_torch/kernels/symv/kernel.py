"""ctypes launch wrappers for ``csrc/symv.cu`` (the KE1 matvec on Hopper).

``symv`` replaces ``symv_pallas`` and ``symm_block`` replaces
``symm_block_pallas`` (``repro/kernels/symv/kernel.py``); the source note
in the ``.cu`` file says what bounds the kernel and what its design does
about it. Each wrapper checks device, dtype, shape and strides, allocates
the output and the (nb, n, p) slot scratch with ``torch.empty``, launches
on the current stream, raises if ``cudaGetLastError`` is not 0, and adds
one to its ``launches`` count for every product it launches (a tile pass
and its slot sum).

A is read in place through its row stride: it is never copied or padded.
X may be a column slice of a wider row-major array (the Lanczos basis);
only an X of another layout is copied, and it is the small operand.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGS = {
    "symv_upper": ([_P, _L, _P, _P, _P, _I, _P], _I),
    "symm_block_upper": ([_P, _L, _P, _L, _P, _P, _I, _I, _P], _I),
    "symv_tile": ([], _I),
}


def _lib() -> ctypes.CDLL:
    lib = load("symv")
    for fn, (argtypes, restype) in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def _check_matrix(A: torch.Tensor) -> int:
    if A.device.type != "cuda":
        raise ValueError(f"A must be a CUDA tensor, got {A.device}")
    if A.dtype != torch.float64:
        raise ValueError(f"A must be torch.float64, got {A.dtype}")
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got shape {tuple(A.shape)}")
    n = A.shape[0]
    if n > 1 and (A.stride(1) != 1 or A.stride(0) < n):
        raise ValueError(f"A must be row-major with unit column stride, got "
                         f"strides {A.stride()}")
    return n


def _check_rhs(X: torch.Tensor, A: torch.Tensor, shape: tuple) -> None:
    if X.device != A.device:
        raise ValueError(f"the right-hand side must be on {A.device}, got "
                         f"{X.device}")
    if X.dtype != torch.float64:
        raise ValueError(f"the right-hand side must be torch.float64, got "
                         f"{X.dtype}")
    if tuple(X.shape) != shape:
        raise ValueError(f"the right-hand side must have shape {shape}, got "
                         f"{tuple(X.shape)}")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError {err}")


def _scratch(lib, n: int, p: int, like: torch.Tensor) -> torch.Tensor:
    nb = -(-n // lib.symv_tile())
    return torch.empty((nb, n, p), dtype=torch.float64, device=like.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def symv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (n,) = A x from the upper triangle of A (n, n)."""
    n = _check_matrix(A)
    _check_rhs(x, A, (n,))
    y = torch.empty((n,), dtype=torch.float64, device=A.device)
    if n == 0:
        return y
    if x.stride(0) != 1:
        x = x.contiguous()
    lib = _lib()
    P = _scratch(lib, n, 1, A)
    err = lib.symv_upper(A.data_ptr(), A.stride(0), x.data_ptr(),
                         P.data_ptr(), y.data_ptr(), n, _stream(A))
    symv.launches += 1
    _raise_on(err, "symv_upper")
    return y


symv.launches = 0


def symm_block(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y (n, p) = A X from the upper triangle of A (n, n); X (n, p)."""
    n = _check_matrix(A)
    if X.dim() != 2:
        raise ValueError(f"X must be (n, p), got shape {tuple(X.shape)}")
    p = X.shape[1]
    _check_rhs(X, A, (n, p))
    Y = torch.empty((n, p), dtype=torch.float64, device=A.device)
    if n == 0 or p == 0:
        return Y
    if n > 1 and ((p > 1 and X.stride(1) != 1) or X.stride(0) < p):
        X = X.contiguous()
    ldx = X.stride(0) if n > 1 else p
    lib = _lib()
    P = _scratch(lib, n, p, A)
    err = lib.symm_block_upper(A.data_ptr(), A.stride(0) if n > 1 else 1,
                               X.data_ptr(), ldx, P.data_ptr(), Y.data_ptr(),
                               n, p, _stream(A))
    symm_block.launches += 1
    _raise_on(err, "symm_block_upper")
    return Y


symm_block.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"symv": symv, "symm_block": symm_block}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
