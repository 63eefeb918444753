"""ctypes launch wrappers for ``csrc/tridiag_eig.cu`` (TD2 on Hopper).

``bisect_sturm`` replaces ``bisect_sturm_pallas`` and ``invit`` replaces
``invit_pallas`` (``repro/kernels/tridiag_eig/kernel.py``); the source
notes in the ``.cu`` file say what bounds each on the card and what the
design does about it. Each wrapper checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream, raises if ``cudaGetLastError`` is not 0, and adds one
to its ``launches`` count for every kernel it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "tridiag_bisect_sturm": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tridiag_invit_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "tridiag_invit_orth": [_P, _P, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = load("tridiag_eig")
    for fn, argtypes in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bisect_sturm(d: torch.Tensor, e2: torch.Tensor, ks: torch.Tensor,
                 scal: torch.Tensor, max_iters: int = 80) -> torch.Tensor:
    """lam (s,) at indices ``ks`` (int64) of tridiag(d, e), from
    ``e2 = [0, e*e]`` and ``scal = [lo0, hi0, pivmin]`` — one launch."""
    n, s = d.shape[0], ks.shape[0]
    f64 = torch.float64
    _check("d", d, f64, (n,))
    _check("e2", e2, f64, (n,))
    _check("ks", ks, torch.int64, (s,))
    _check("scal", scal, f64, (3,))
    lam = torch.empty((s,), dtype=f64, device=d.device)
    if s == 0:
        return lam
    lib = _lib()
    err = lib.tridiag_bisect_sturm(d.data_ptr(), e2.data_ptr(), ks.data_ptr(),
                                   scal.data_ptr(), lam.data_ptr(), n, s,
                                   max_iters, _stream(d))
    bisect_sturm.launches += 1
    _raise_on(err, "tridiag_bisect_sturm")
    return lam


bisect_sturm.launches = 0


def invit(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
          cid: torch.Tensor, pivmin: torch.Tensor, X0: torch.Tensor,
          iters: int = 3) -> torch.Tensor:
    """Z (n, s) for SORTED shifts ``lam`` from the column-normalized start
    block ``X0``; ``cid`` int32 cluster ids, ``pivmin`` a 0-d tensor.
    Two launches per round (solve, then norms + cluster Gram-Schmidt)."""
    n, s = X0.shape
    f64 = torch.float64
    _check("d", d, f64, (n,))
    if n > 1:
        _check("e", e, f64, (n - 1,))
    _check("lam", lam, f64, (s,))
    _check("cid", cid, torch.int32, (s,))
    _check("pivmin", pivmin, f64, ())
    _check("X0", X0, f64, (n, s))
    Z = X0.clone()
    if s == 0 or n == 0:
        return Z
    # e is read only when n > 1; a 1-element stand-in keeps the pointer valid
    e_ptr = e if n > 1 else torch.zeros((1,), dtype=f64, device=d.device)
    D, DU, DU2, Y = (torch.empty((n, s), dtype=f64, device=d.device)
                     for _ in range(4))
    lib = _lib()
    stream = _stream(d)
    for _ in range(iters):
        err = lib.tridiag_invit_solve(
            d.data_ptr(), e_ptr.data_ptr(), lam.data_ptr(), pivmin.data_ptr(),
            Z.data_ptr(), D.data_ptr(), DU.data_ptr(), DU2.data_ptr(),
            Y.data_ptr(), n, s, stream)
        invit.launches += 1
        _raise_on(err, "tridiag_invit_solve")
        err = lib.tridiag_invit_orth(Z.data_ptr(), cid.data_ptr(), n, s, stream)
        invit.launches += 1
        _raise_on(err, "tridiag_invit_orth")
    return Z


invit.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"bisect_sturm": bisect_sturm, "invit": invit}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
