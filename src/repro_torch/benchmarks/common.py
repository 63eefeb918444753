"""What the table drivers share: the problem sizes, the problems on the
target device, a timer that waits for the device, and a solve cache (the
port's copy of ``benchmarks/common.py``, which imports JAX).

The default sizes are the reference's CI-scale stand-ins for the paper's
two experiments (the same spectrum shapes and wanted fractions); ``--full``
gives the paper's n=9,997 and n=17,243. ``parser`` builds the drivers'
shared command line: ``--device`` (``cuda`` by default, ``cpu`` for the
host), ``--full``, and the sizes, which the tests shrink.
"""
from __future__ import annotations

import argparse
import time
from functools import lru_cache

import torch

from repro_torch.data.problems import dft_like, md_like
from repro_torch.device import resolve_device, synchronize

MD_N, MD_S = 384, 4          # ~1% of the spectrum, as in the paper's MD
DFT_N, DFT_S = 512, 13       # ~2.6%, as in the paper's DFT
FULL_MD_N, FULL_MD_S = 9_997, 100
FULL_DFT_N, FULL_DFT_S = 17_243, 448
BAND_W = 8                   # TT bandwidth at CI scale (as the reference's)
DFT_M, FULL_DFT_M = 96, 896  # the Krylov subspace on the clustered DFT end


def parser(description: str, precision: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes: MD n=9997, s=100; DFT "
                         "n=17243, s=448")
    ap.add_argument("--md-n", type=int, default=None)
    ap.add_argument("--md-s", type=int, default=None)
    ap.add_argument("--dft-n", type=int, default=None)
    ap.add_argument("--dft-s", type=int, default=None)
    if precision:
        ap.add_argument("--precision", choices=["fp64", "mixed", "fast"],
                        default="fp64", help="passed through to solve")
    return ap


def sizes(args) -> dict:
    """(n, s) of the two experiments, and the DFT Krylov subspace m (the
    reference's; None where n is too small to hold it)."""
    md = (FULL_MD_N, FULL_MD_S) if args.full else (MD_N, MD_S)
    dft = (FULL_DFT_N, FULL_DFT_S) if args.full else (DFT_N, DFT_S)
    md_n, md_s = args.md_n or md[0], args.md_s or md[1]
    dft_n, dft_s = args.dft_n or dft[0], args.dft_s or dft[1]
    m = FULL_DFT_M if args.full else DFT_M
    return {"md": (md_n, md_s), "dft": (dft_n, dft_s),
            "dft_m": m if m + 1 <= dft_n else None}


@lru_cache(maxsize=None)
def md_problem(n: int, device: str):
    return md_like(n, device=resolve_device(device))


@lru_cache(maxsize=None)
def dft_problem(n: int, device: str):
    return dft_like(n, device=resolve_device(device))


def time_call(fn, *args, device: torch.device, warmup: int = 1,
              iters: int = 3, **kwargs):
    """(median seconds, last result) of a call, each waited for on
    ``device``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    synchronize(device)
    ts = []
    out = None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], out


# ---- cross-table solve cache (table2 + table3 share one run per variant) --
_SOLVE_CACHE: dict = {}


def solve_cached(tag: str, prob, s: int, variant: str, **kw):
    """Memoized ``solve`` keyed by (tag, variant, s, knobs): table3 reuses
    table2's runs."""
    from repro_torch.core import solve
    key = (tag, variant, s, tuple(sorted(kw.items())))
    if key not in _SOLVE_CACHE:
        _SOLVE_CACHE[key] = solve(prob.A, prob.B, s, variant=variant, **kw)
    return _SOLVE_CACHE[key]
