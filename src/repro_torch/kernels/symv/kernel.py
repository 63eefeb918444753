"""ctypes launch wrappers for ``csrc/symv.cu`` (the KE1 matvec on Hopper)
and their plan.

``symv`` replaces ``symv_pallas`` and ``symm_block`` replaces
``symm_block_pallas`` (``repro/kernels/symv/kernel.py``); the source note
in the ``.cu`` file says what bounds the kernel and what its design does
about it. Each wrapper checks device, dtype, shape and strides, allocates
the output and the (nb + 1, n, p) slot scratch with ``torch.empty``,
launches on the current stream, raises if ``cudaGetLastError`` is not 0,
and adds one to the count of the instance it launched for every product
(a tile pass and its slot sum; ``kernels/_launches.py``).

A and X may be float64, or float32 or bfloat16 (the kernel's reduced
instances: the scratch and every sum in fp32, Y in the storage dtype).

``plan`` is pure Python, so the CPU tests reach it: the upper tiles (one
warp each), the columns of X a pass (the kernel's compiled width) and the
scratch. ``tile_of`` is the Python twin of the kernel's triangle grid:
warp t takes the tile at position t of the reference's
``triangle_indices`` order.

A is read in place through its row stride: it is never copied or padded.
X may be a column slice of a wider row-major array (the Lanczos basis);
only an X of another layout is copied, and it is the small operand.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.device import current_stream
from repro_torch.kernels import _launches
from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SYMM = ([_P, _L, _P, _L, _P, _P, _I, _I, _I, _P], _I)
_SIGS = {
    "symm_block_upper": _SYMM,
    "symm_block_upper_fp32": _SYMM,
    "symm_block_upper_bf16": _SYMM,
    "symv_tile": ([], _I),
}
#: the product's C entry point of each instance
ENTRY = {torch.float64: "symm_block_upper",
         torch.float32: "symm_block_upper_fp32",
         torch.bfloat16: "symm_block_upper_bf16"}

#: tile edge (``kT`` in symv.cu)
TILE = 64


class Plan(NamedTuple):
    """One product's launch: ``nb`` row blocks of ``TILE``, the
    ``ntiles`` upper tiles (one warp each), the compiled width ``kc``
    (columns of X a pass) and the slot scratch's shape (``nb + 1`` slots
    of (n, p))."""
    nb: int
    ntiles: int
    kc: int
    scratch: tuple


@functools.cache
def plan(n: int, p: int) -> Plan:
    """The launch of an (n, n)(n, p) product. Width: p itself up to 2,
    else 4 (wider p take passes of 4), the widths symv.cu is compiled
    for."""
    nb = -(-n // TILE)
    return Plan(nb, nb * (nb + 1) // 2, p if p <= 2 else 4, (nb + 1, n, p))


def tile_of(t: int, nb: int) -> tuple:
    """The tile (i, j >= i) at position t of the row-major upper triangle
    of nb x nb tiles, as ``tile_of`` in symv.cu computes it: row i starts
    at s(i) = i nb - i (i - 1) / 2, so i is the floor of the root of
    s(i) = t, stepped to the exact row against rounding."""
    b = 2.0 * nb + 1.0
    i = int(0.5 * (b - math.sqrt(b * b - 8.0 * t)))
    while i > 0 and i * nb - i * (i - 1) // 2 > t:
        i -= 1
    while (i + 1) * nb - (i + 1) * i // 2 <= t:
        i += 1
    return i, i + t - (i * nb - i * (i - 1) // 2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("symv")
    for fn, (argtypes, restype) in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    if lib.symv_tile() != TILE:
        raise RuntimeError(f"symv.cu tiles by {lib.symv_tile()}, the plan by "
                           f"{TILE}")
    return lib


def _check_matrix(A: torch.Tensor) -> int:
    if A.device.type != "cuda":
        raise ValueError(f"A must be a CUDA tensor, got {A.device}")
    if A.dtype not in ENTRY:
        raise ValueError(f"A must be one of {tuple(ENTRY)}, got {A.dtype}")
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
    if X.dtype != A.dtype:
        raise ValueError(f"the right-hand side must be {A.dtype}, got "
                         f"{X.dtype}")
    if tuple(X.shape) != shape:
        raise ValueError(f"the right-hand side must have shape {shape}, got "
                         f"{tuple(X.shape)}")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError {err}")


def _scratch(pl: Plan, A: torch.Tensor) -> torch.Tensor:
    acc = torch.float64 if A.dtype == torch.float64 else torch.float32
    return torch.empty(pl.scratch, dtype=acc, device=A.device)


def symv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (n,) = A x from the upper triangle of A (n, n)."""
    n = _check_matrix(A)
    _check_rhs(x, A, (n,))
    y = torch.empty((n,), dtype=A.dtype, device=A.device)
    if n == 0:
        return y
    if x.stride(0) != 1:
        x = x.contiguous()
    pl = plan(n, 1)
    P = _scratch(pl, A)
    fn = ENTRY[A.dtype]     # the product's instance at p = 1, kc = 1
    err = getattr(_lib(), fn)(A.data_ptr(), A.stride(0), x.data_ptr(), 1,
                              P.data_ptr(), y.data_ptr(), n, 1, 1,
                              current_stream(A.device))
    _launches.count(symv, A.dtype)
    _raise_on(err, fn)
    return y


_launches.with_reduced(symv)


def symm_block(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y (n, p) = A X from the upper triangle of A (n, n); X (n, p)."""
    n = _check_matrix(A)
    if X.dim() != 2:
        raise ValueError(f"X must be (n, p), got shape {tuple(X.shape)}")
    p = X.shape[1]
    _check_rhs(X, A, (n, p))
    Y = torch.empty((n, p), dtype=A.dtype, device=A.device)
    if n == 0 or p == 0:
        return Y
    if n > 1 and ((p > 1 and X.stride(1) != 1) or X.stride(0) < p):
        X = X.contiguous()
    ldx = X.stride(0) if n > 1 else p
    pl = plan(n, p)
    P = _scratch(pl, A)
    fn = ENTRY[A.dtype]
    err = getattr(_lib(), fn)(A.data_ptr(), A.stride(0) if n > 1 else 1,
                              X.data_ptr(), ldx, P.data_ptr(), Y.data_ptr(),
                              n, p, pl.kc, current_stream(A.device))
    _launches.count(symm_block, A.dtype)
    _raise_on(err, fn)
    return Y


_launches.with_reduced(symm_block)

#: every kernel wrapper of this module, by name
WRAPPERS = {"symv": symv, "symm_block": symm_block}


def reset_launches() -> None:
    _launches.reset(WRAPPERS)


def launch_counts() -> dict:
    return _launches.read(WRAPPERS)
