"""ctypes launch wrappers for ``csrc/tridiag_eig.cu`` (TD2 on Hopper).

``bisect_sturm`` replaces ``bisect_sturm_pallas`` and ``invit`` replaces
``invit_pallas`` (``repro/kernels/tridiag_eig/kernel.py``); the source
notes in the ``.cu`` file say what bounds each on the card and what the
design does about it. Each wrapper checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream, raises if ``cudaGetLastError`` is not 0, and adds one
to its ``launches`` count for every kernel it launches.

``bisect_sturm`` is exact multisection: a team of 2^levels threads an
index does ``levels`` bisection levels a Sturm sweep, with the levels and
the teams a block from ``bisect_plan`` (pure Python, reached by the CPU
tests); ``schedule.bisect_multisection`` is its plain twin.
``bisect_launch`` runs any levels, with or without the stop, counting
nothing.
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
_L = ctypes.c_longlong
_SIGS = {
    "tridiag_bisect_sturm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P],
    "tridiag_invit_solve": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "tridiag_invit_orth": [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P],
}

#: columns of a Gram-Schmidt panel (``kPanel`` in the source); the
#: largest dynamic shared memory of a block on the card
PANEL = 32
SMEM_MAX = 232448
#: launches of ``invit`` a round: the solve, then the Gram-Schmidt
LAUNCHES_PER_ROUND = 2

#: the bisection's most levels a sweep (a team of 2^10 threads fills a
#: block), and its threads a block
MAX_LEVELS = 10
MAX_THREADS = 1 << MAX_LEVELS
#: ``flags`` of ``bisect_launch``: end a block once all its indices are at
#: their fixed point
STOP = 1
#: the threads an SM runs at which the Sturm step still holds the one
#: lane's time (~82 ns: its chain of dependent divisions); above it the
#: fp64 pipe is full and the step slows (1.23x at 512, 2.12x at 1024).
#: From chip_smoke.py's ``bisect by levels`` lines at MD and DFT on an
#: H100 80GB HBM3 at 700 W (PERF.md §6).
FLAT_THREADS = 256


class BisectPlan(NamedTuple):
    levels: int     # bisection levels a Sturm sweep (m)
    lanes: int      # threads a wanted index: 2^m (2^m - 1 midpoints)
    per_block: int  # wanted indices a block
    blocks: int


def bisect_plan(n: int, s: int, sms: int, max_iters: int = 80,
                levels: int | None = None) -> BisectPlan:
    """The multisection launch for s wanted indices of an n-row tridiagonal
    on a card of ``sms`` SMs. The indices spread evenly over the SMs, a
    block of ``per_block`` teams on each; m is the most levels (at most
    ``max_iters``) whose teams of 2^m keep an SM within ``FLAT_THREADS``,
    so each sweep costs about the one-lane time, else 1. ``levels`` forces
    m (timings and tests). n does not move the plan: every sweep is n
    steps at any m."""
    if n < 0 or s < 1 or sms < 1:
        raise ValueError(f"bisect_plan takes n >= 0, s >= 1 and sms >= 1, "
                         f"got n={n}, s={s}, sms={sms}")
    if levels is not None and not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be 1..{MAX_LEVELS}, got {levels}")
    teams = -(-s // sms)                  # teams an SM runs
    m = levels
    if m is None:
        top = min(MAX_LEVELS, max(max_iters, 1))
        m = max([lv for lv in range(1, top + 1)
                 if teams << lv <= FLAT_THREADS], default=1)
    per_block = min(teams, MAX_THREADS >> m)
    return BisectPlan(m, 1 << m, per_block, -(-s // per_block))


class OrthPlan(NamedTuple):
    blocks: int    # one cooperative launch of this many blocks
    rows: int      # rows of Z a block owns
    smem: int      # bytes of dynamic shared memory a block (its panel rows)
    scratch: int   # doubles of global scratch


def orth_plan(n: int, s: int, sms: int) -> OrthPlan:
    """The Gram-Schmidt launch for Z (n, s) on a card of ``sms`` SMs: a
    block per SM (fewer for small n, at least 32 rows a block), each
    owning a contiguous range of rows and holding its rows of a panel in
    shared memory. The scratch size is ``tridiag_invit_orth_scratch``."""
    blocks = max(1, min(sms, -(-n // 32)))
    rows = -(-n // blocks)
    smem = rows * PANEL * 8
    if smem > SMEM_MAX:
        raise ValueError(f"invit takes n up to {SMEM_MAX // (PANEL * 8) * sms} "
                         f"on this card ({rows} rows a block need {smem} "
                         f"bytes of shared memory), got n={n}")
    scratch = blocks * s * (1 + PANEL) + s * (2 + PANEL) + blocks * (PANEL + 2)
    return OrthPlan(blocks, rows, smem, scratch)


@functools.cache
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


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bisect_args(d, e2, ks, scal) -> tuple:
    n, s = d.shape[0], ks.shape[0]
    f64 = torch.float64
    _check("d", d, f64, (n,))
    _check("e2", e2, f64, (n,))
    _check("ks", ks, torch.int64, (s,))
    _check("scal", scal, f64, (3,))
    return n, s


def bisect_launch(d: torch.Tensor, e2: torch.Tensor, ks: torch.Tensor,
                  scal: torch.Tensor, max_iters: int, levels: int,
                  per_block: int, flags: int = STOP) -> tuple:
    """(lam, sweeps): one launch of the bisection at ``levels`` levels a
    sweep, ``per_block`` indices a block, ``flags`` (``STOP`` or 0);
    sweeps (s,) int32 is the sweep each index stopped at. Raises on a CUDA
    error. Counts nothing: ``bisect_sturm`` counts the main path's
    launches, and tests and timings call this directly."""
    n, s = _bisect_args(d, e2, ks, scal)
    lam = torch.empty((s,), dtype=torch.float64, device=d.device)
    sweeps = torch.empty((s,), dtype=torch.int32, device=d.device)
    if s:
        err = _lib().tridiag_bisect_sturm(
            d.data_ptr(), e2.data_ptr(), ks.data_ptr(), scal.data_ptr(),
            lam.data_ptr(), sweeps.data_ptr(), n, s, max_iters, levels,
            per_block, flags, current_stream(d.device))
        _raise_on(err, "tridiag_bisect_sturm")
    return lam, sweeps


def bisect_sturm(d: torch.Tensor, e2: torch.Tensor, ks: torch.Tensor,
                 scal: torch.Tensor, max_iters: int = 80) -> torch.Tensor:
    """lam (s,) at indices ``ks`` (int64) of tridiag(d, e), from
    ``e2 = [0, e*e]`` and ``scal = [lo0, hi0, pivmin]`` — one launch, at
    ``bisect_plan``'s levels, with the early stop."""
    n, s = _bisect_args(d, e2, ks, scal)
    lam = torch.empty((s,), dtype=torch.float64, device=d.device)
    if s == 0:
        return lam
    plan = bisect_plan(n, s, sm_count(d.device.index), max_iters)
    err = _lib().tridiag_bisect_sturm(
        d.data_ptr(), e2.data_ptr(), ks.data_ptr(), scal.data_ptr(),
        lam.data_ptr(), None, n, s, max_iters, plan.levels, plan.per_block,
        STOP, current_stream(d.device))
    bisect_sturm.launches += 1
    _raise_on(err, "tridiag_bisect_sturm")
    return lam


bisect_sturm.launches = 0


def invit_solve(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                pivmin: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """One round's solve launch, in place on Z (n, s): column j becomes
    (T - lam_j I)^{-1} Z[:, j] (the pivoted LU fused with the forward
    substitution, then the back substitution). Counts under ``invit``."""
    n, s = Z.shape
    f64 = torch.float64
    _check("d", d, f64, (n,))
    if n > 1:
        _check("e", e, f64, (n - 1,))
    _check("lam", lam, f64, (s,))
    _check("pivmin", pivmin, f64, ())
    _check("Z", Z, f64, (n, s))
    if s == 0 or n == 0:
        return Z
    # e is read only when n > 1; a 1-element stand-in keeps the pointer valid
    e_ptr = e if n > 1 else torch.zeros((1,), dtype=f64, device=d.device)
    W = torch.empty((n, s, 4), dtype=f64, device=d.device)
    err = _lib().tridiag_invit_solve(
        d.data_ptr(), e_ptr.data_ptr(), lam.data_ptr(), pivmin.data_ptr(),
        Z.data_ptr(), W.data_ptr(), n, s, current_stream(d.device))
    invit.launches += 1
    _raise_on(err, "tridiag_invit_solve")
    return Z


def invit_orth(Z: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """One round's Gram-Schmidt launch, in place on Z (n, s): the max-abs-
    rescaled column norms, then Gram-Schmidt within the clusters ``cid``
    (int32), as one cooperative launch across the card (``orth_plan``).
    Counts under ``invit``."""
    n, s = Z.shape
    _check("Z", Z, torch.float64, (n, s))
    _check("cid", cid, torch.int32, (s,))
    if s == 0 or n == 0:
        return Z
    plan = orth_plan(n, s, sm_count(Z.device.index))
    scr = torch.empty((plan.scratch,), dtype=torch.float64, device=Z.device)
    bar = torch.zeros((1,), dtype=torch.int32, device=Z.device)
    err = _lib().tridiag_invit_orth(
        Z.data_ptr(), cid.data_ptr(), scr.data_ptr(), plan.scratch,
        bar.data_ptr(), n, s, plan.blocks, plan.rows,
        current_stream(Z.device))
    invit.launches += 1
    _raise_on(err, "tridiag_invit_orth")
    return Z


def invit(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
          cid: torch.Tensor, pivmin: torch.Tensor, X0: torch.Tensor,
          iters: int = 3) -> torch.Tensor:
    """Z (n, s) for SORTED shifts ``lam`` from the column-normalized start
    block ``X0``; ``cid`` int32 cluster ids, ``pivmin`` a 0-d tensor.
    Two launches per round: the solve (``invit_solve``), then the norms
    and the cluster Gram-Schmidt as one cooperative launch across the card
    (``invit_orth``)."""
    n, s = X0.shape
    _check("X0", X0, torch.float64, (n, s))
    Z = X0.clone()
    for _ in range(iters):
        invit_solve(d, e, lam, pivmin, Z)
        invit_orth(Z, cid)
    return Z


invit.launches = 0

#: every kernel wrapper of this module, by name
WRAPPERS = {"bisect_sturm": bisect_sturm, "invit": invit}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
