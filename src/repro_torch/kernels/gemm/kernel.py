"""ctypes launch wrapper for ``csrc/gemm.cu`` (the tiled fp64 product on
the fp64 tensor cores) and its planner.

``gemm`` replaces ``gemm_pallas`` (``repro/kernels/gemm/kernel.py``); the
source note in the ``.cu`` file says what bounds the kernel and what its
design does about it. The wrapper checks device, dtype, shapes and
strides, allocates the output (unless ``out`` is given) and the split-K
scratch with ``torch.empty``, launches on the current stream, raises if
``cudaGetLastError`` is not 0, and adds one to its ``launches`` count per
launch: one for the product, one more for the split-K reduce pass (both
launched by the one C call).

``plan`` is pure Python, so the CPU tests reach it: it picks the output
tile from the compiled menu (128 x 128 or 64 x 64) and the K span of a
block (the split), from the shapes and the knobs.

Layouts: A may be row-major or the transpose of a row-major array (a
``.mT`` view, such as the trsm update's ``U[:k0, k0:k1].mT``): the kernel
reads it through its leading dimension and a transpose flag, never as if
it were contiguous. B and ``out`` must be row-major with unit column
stride (a slice of a wider matrix is fine); any other layout raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import current_stream
from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_D = ctypes.c_double
_SIG = ([_P, _L, _I, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _D, _I, _P],
        _I)

#: the square output tiles a block is compiled for
TILES = (128, 64)
#: a split's K span is a multiple of this (the deepest stage of the ring)
SPLIT_K = 32
#: the most K splits of one product
MAX_SPLITS = 64
#: SMs of an H100: the planner aims at two blocks on each
SMS = 132
#: the least K a split covers, so the partials stay few
MIN_SPLIT_K = 128
#: the least K for the 128 x 128 tile: below it the shorter K loop of
#: more, smaller blocks wins (the GS1 SYRK update, K = 256)
BIG_TILE_K = 1024
#: a block's fixed cost (prologue, epilogue, its share of the reduce)
#: in units of K, for the 128 x 128 tile's split
BLOCK_COST_K = 256


class Plan(NamedTuple):
    """One product's launch: the block's square output tile, the K each
    block covers, the number of K splits, and the kernel launches (2 with
    a split: the product and the reduce pass)."""
    tile: int
    kspan: int
    splits: int

    @property
    def launches(self) -> int:
        return 1 + (self.splits > 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def plan(m: int, n: int, k: int, bm: int | None = None,
         bn: int | None = None, bk: int | None = None) -> Plan:
    """The tile and split of an (m, k)(k, n) product.

    Tile: 128 x 128 where K is at least ``BIG_TILE_K`` and the output
    holds such blocks for at least half the SMs (one fits an SM; a split
    fills the rest), else 64 x 64. The knobs override it: 128 where
    ``max(bm, bn) >= 128`` and m, n exceed 64, else 64.

    Split: none while the output tiles fill the SMs; else K is cut into
    spans of at least ``MIN_SPLIT_K``, at most ``MAX_SPLITS`` of them:
    ``ceil(2 SMS / tiles)`` for the 64 x 64 tile (up to four of its
    blocks share an SM), and for the 128 x 128 tile the count that
    minimises waves x (span + ``BLOCK_COST_K``), so that the blocks fill
    whole waves. The knob ``bk`` overrides it: the K a block covers,
    rounded up to ``SPLIT_K`` (and deep enough for ``MAX_SPLITS``).
    """
    if bm is None and bn is None:
        big = k >= BIG_TILE_K and _cdiv(m, 128) * _cdiv(n, 128) >= SMS // 2
    else:
        big = max(bm or 0, bn or 0) >= 128 and m > 64 and n > 64
    t = 128 if big else 64
    tiles = _cdiv(m, t) * _cdiv(n, t)
    ku = _cdiv(max(k, 1), SPLIT_K)
    if bk is None:
        most = max(1, min(ku * SPLIT_K // MIN_SPLIT_K, MAX_SPLITS))
        if tiles >= SMS:
            splits = 1
        elif t == 128:
            # one such block an SM: the time is the waves of blocks times
            # a block's K plus its fixed cost, so whole waves matter
            splits = min(range(1, most + 1), key=lambda s: _cdiv(
                tiles * s, SMS) * (_cdiv(ku, s) * SPLIT_K + BLOCK_COST_K))
        else:
            splits = min(_cdiv(2 * SMS, tiles), most)
        span = _cdiv(ku, splits)
    else:
        span = max(_cdiv(max(bk, 1), SPLIT_K), _cdiv(ku, MAX_SPLITS))
    return Plan(t, span * SPLIT_K, _cdiv(ku, span))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("gemm")
    lib.gemm_fp64.argtypes, lib.gemm_fp64.restype = _SIG
    return lib


def layout(t: torch.Tensor):
    """(transposed, leading dimension) of a 2-D tensor the kernel can read
    in place: row-major with unit column stride, or the transpose of such
    an array; ``None`` for any other layout."""
    rows, cols = t.shape
    sr, sc = t.stride()
    if cols == 1 or sc == 1:
        ld = sr if rows > 1 else cols
        return (False, ld) if ld >= cols else None
    if rows == 1 or sr == 1:
        ld = sc if cols > 1 else rows
        return (True, ld) if ld >= rows else None
    return None


def _check(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float64:
        raise ValueError(f"{name} must be torch.float64, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def gemm(A: torch.Tensor, B: torch.Tensor, out: torch.Tensor | None = None,
         alpha: float = 1.0, accumulate: bool = False, bm: int | None = None,
         bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """``out = alpha A B`` or, with ``accumulate``, ``out += alpha A B`` in
    place; A (m, k), B (k, n), out (m, n). One launch, or two with a K
    split (``plan``; ``bm``/``bn``/``bk`` override its tile and split)."""
    if A.device.type != "cuda":
        raise ValueError(f"A must be a CUDA tensor, got {A.device}")
    if A.dim() != 2 or B.dim() != 2:
        raise ValueError(f"A and B must be 2-D, got shapes {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    dev = A.device
    m, k = A.shape
    n = B.shape[1]
    _check("A", A, dev, (m, k))
    _check("B", B, dev, (k, n))
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs the out tensor it adds to")
        out = torch.empty((m, n), dtype=torch.float64, device=dev)
    _check("out", out, dev, (m, n))
    la, lb, lc = layout(A), layout(B), layout(out)
    if la is None:
        raise ValueError(f"A must be row-major or a transposed row-major "
                         f"array, got strides {A.stride()}")
    if lb is None or lb[0]:
        raise ValueError(f"B must be row-major with unit column stride, got "
                         f"strides {B.stride()}")
    if lc is None or lc[0]:
        raise ValueError(f"out must be row-major with unit column stride, "
                         f"got strides {out.stride()}")
    if m == 0 or n == 0:
        return out
    p = plan(m, n, k, bm, bn, bk)
    part = (torch.empty((p.splits, m, n), dtype=torch.float64, device=dev)
            if p.splits > 1 else None)
    err = _lib().gemm_fp64(
        A.data_ptr(), la[1], la[0], B.data_ptr(), lb[1], out.data_ptr(),
        lc[1], None if part is None else part.data_ptr(), m, n, k, p.tile,
        p.kspan, float(alpha), int(bool(accumulate)), current_stream(dev))
    # the product, and the reduce pass of a split, in the one call
    gemm.launches += p.launches
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
