"""ctypes launch wrapper for ``csrc/gemm.cu`` (the tiled fp64 product).

``gemm`` replaces ``gemm_pallas`` (``repro/kernels/gemm/kernel.py``); the
source note in the ``.cu`` file says what bounds the kernel and what its
design does about it. The wrapper checks device, dtype, shapes and
strides, allocates the output with ``torch.empty`` unless ``out`` is
given, launches on the current stream, raises if ``cudaGetLastError`` is
not 0, and adds one to its ``launches`` count per launch.

Layouts: A may be row-major or the transpose of a row-major array (a
``.mT`` view, such as the trsm update's ``U[:k0, k0:k1].mT``): the kernel
reads it through its leading dimension and a transpose flag, never as if
it were contiguous. B and ``out`` must be row-major with unit column
stride (a slice of a wider matrix is fine); any other layout raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
_SIG = ([_P, _L, _I, _P, _L, _P, _L, _I, _I, _I, _I, _I, _I, _D, _I, _P],
        _I)

#: output tile edges the kernel is compiled for
TILES = (16, 32, 64, 128)
#: the deepest K slice a block stages per step (a multiple of 8)
MAX_BK = 32


def _lib() -> ctypes.CDLL:
    lib = load("gemm")
    lib.gemm_fp64.argtypes, lib.gemm_fp64.restype = _SIG
    return lib


def layout(t: torch.Tensor):
    """(transposed, leading dimension) of a 2-D tensor the kernel can read
    in place: row-major with unit column stride, or the transpose of such
    an array; ``None`` for any other layout."""
    rows, cols = t.shape
    if cols == 1 or t.stride(1) == 1:
        ld = t.stride(0) if rows > 1 else cols
        return (False, ld) if ld >= cols else None
    if rows == 1 or t.stride(0) == 1:
        ld = t.stride(1) if cols > 1 else rows
        return (True, ld) if ld >= rows else None
    return None


def tile(b: int, dim: int) -> int:
    """The compiled tile edge for the knob ``b`` on a dimension of ``dim``:
    ``b`` rounded up to a compiled edge (16..128), then halved while the
    half still covers ``dim``."""
    t = next((e for e in TILES if e >= b), TILES[-1])
    while t > TILES[0] and t // 2 >= dim:
        t //= 2
    return t


def depth(bk: int, k: int) -> int:
    """The K slice staged per step for the knob ``bk``: a multiple of 8,
    no deeper than K rounded up to 8 and than ``MAX_BK``."""
    bk = min(bk, -(-max(k, 1) // 8) * 8, MAX_BK)
    return max(8, bk // 8 * 8)


def _check(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def gemm(A: torch.Tensor, B: torch.Tensor, out: torch.Tensor | None = None,
         alpha: float = 1.0, accumulate: bool = False, bm: int = 128,
         bn: int = 128, bk: int = 128) -> torch.Tensor:
    """``out = alpha A B`` or, with ``accumulate``, ``out += alpha A B`` in
    place, in one launch; A (m, k), B (k, n), out (m, n). ``bm``/``bn``
    pick the output tile of a block (``tile``), ``bk`` the K slice staged
    per step (``depth``)."""
    if A.device.type != "cuda":
        raise ValueError(f"A must be a CUDA tensor, got {A.device}")
    if A.dim() != 2 or B.dim() != 2:
        raise ValueError(f"A and B must be 2-D, got shapes {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    m, k = A.shape
    n = B.shape[1]
    _check("A", A, A.device, (m, k))
    _check("B", B, A.device, (k, n))
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs the out tensor it adds to")
        out = torch.empty((m, n), dtype=torch.float64, device=A.device)
    _check("out", out, A.device, (m, n))
    la, lb, lc = layout(A), layout(B), layout(out)
    if la is None:
        raise ValueError(f"A must be row-major or a transposed row-major "
                         f"array, got strides {A.stride()}")
    for name, t, lt in (("B", B, lb), ("out", out, lc)):
        if lt is None or lt[0]:
            raise ValueError(f"{name} must be row-major with unit column "
                             f"stride, got strides {t.stride()}")
    if m == 0 or n == 0:
        return out
    err = _lib().gemm_fp64(
        A.data_ptr(), la[1], int(la[0]), B.data_ptr(), lb[1], out.data_ptr(),
        lc[1], m, n, k, tile(bm, m), tile(bn, n), depth(bk, k), float(alpha),
        int(bool(accumulate)), torch.cuda.current_stream(A.device).cuda_stream)
    gemm.launches += 1
    if err != 0:
        raise RuntimeError(f"gemm_fp64 failed with cudaError {err}")
    return out


gemm.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"gemm": gemm}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
