"""The order of the CUDA bisection, in plain PyTorch: exact multisection.

``bisect_multisection`` does what ``csrc/tridiag_eig.cu``'s
``bisect_sturm_kernel`` does, round by round: the 2^L - 1 midpoints of the
next L bisection levels of every index (heap order, each derived from the
round's (lo, hi) by the sequential loop's ``0.5 * (lo + hi)``), one Sturm
sweep over all of them, then the walk down the levels with
``right = cnt <= k``; an index whose (lo, hi) a level leaves unchanged,
bit for bit, is at a fixed point of the map and done. It is bitwise equal
to ``ref.bisect_sturm_ref`` at every ``levels`` and with the stop on or
off, which the CPU tests check; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core.tridiag_eig import sturm_counts


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64)


def bisect_multisection(d: torch.Tensor, e2: torch.Tensor, ks: torch.Tensor,
                        scal: torch.Tensor, levels: int, max_iters: int = 80,
                        stop: bool = True) -> tuple:
    """(lam, sweeps) at indices ``ks`` of tridiag(d, e), from ``e2 = [0,
    e*e]`` and ``scal = [lo0, hi0, pivmin]``, ``levels`` bisection levels a
    Sturm sweep. ``sweeps`` (int32) is the sweep whose walk found each
    index's fixed point (1-based), or the sweeps run if none did; with
    ``stop`` the rounds end once every index is fixed."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    lo0, hi0, piv = scal.tolist()
    s = ks.shape[0]
    lo = torch.full((s,), lo0, dtype=d.dtype, device=d.device)
    hi = torch.full((s,), hi0, dtype=d.dtype, device=d.device)
    fixed = torch.zeros((s,), dtype=torch.bool, device=d.device)
    first = torch.zeros((s,), dtype=torch.int32, device=d.device)
    rows = torch.arange(s, device=d.device)
    rounds = done = 0
    while done < max_iters and not (stop and bool(fixed.all())):
        L = min(levels, max_iters - done)
        # (lo, hi) of heap nodes 1 .. 2^L - 1; node j's children 2j, 2j+1
        nlo = lo.new_empty((s, 1 << L))
        nhi = hi.new_empty((s, 1 << L))
        nlo[:, 1], nhi[:, 1] = lo, hi
        for j in range(1, 1 << (L - 1)):
            m = 0.5 * (nlo[:, j] + nhi[:, j])
            nlo[:, 2 * j], nhi[:, 2 * j] = nlo[:, j], m
            nlo[:, 2 * j + 1], nhi[:, 2 * j + 1] = m, nhi[:, j]
        mids = 0.5 * (nlo[:, 1:] + nhi[:, 1:])
        cnt = sturm_counts(d, e2, mids.reshape(-1), piv).reshape(s, -1)
        rounds += 1
        at = torch.ones((s,), dtype=torch.int64, device=d.device)
        for _ in range(L):
            right = cnt[rows, at - 1] <= ks
            m = 0.5 * (lo + hi)
            tlo = torch.where(right, m, lo)
            thi = torch.where(right, hi, m)
            now = ~fixed & (_bits(tlo) == _bits(lo)) & (_bits(thi) == _bits(hi))
            first = torch.where(now, rounds, first)
            lo = torch.where(fixed, lo, tlo)
            hi = torch.where(fixed, hi, thi)
            fixed = fixed | now
            at = 2 * at + right.long()
        done += L
    sweeps = torch.where(first > 0, first, rounds).to(torch.int32)
    return 0.5 * (lo + hi), sweeps


__all__ = ["bisect_multisection"]
