"""Seeded fault injection for the chaos drills (``repro.resilience.faults``
in torch).

Faults are armed with the ``inject`` context manager and consulted by the
solver's seams (``core.gsyeig._solve_once``): with no fault armed a seam
costs one dict lookup and launches nothing. Everything is deterministic:
NaN positions come from a seeded ``np.random.Generator`` (the reference's
draw, so a poisoned stage input has the same NaN positions in both
packages), nonconvergence is forced by clamping the tolerance, and
``SimulatedPreemption`` is the preemption drill's error (raised by the
distributed driver, which is not ported yet).

This module imports nothing of ``repro_torch.core`` (it imports this),
and its pencil builders return numpy arrays, bit for bit the reference's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["inject", "active", "poison_stage", "force_nonconverge",
           "NanPoison", "ForceNonconverge", "SimulatedPreemption",
           "nonspd_pencil", "near_breakdown_pencil", "slow_then_lost_trace"]

# the armed faults, keyed by kind ("nan" | "nonconverge")
_ACTIVE: Dict[str, object] = {}


class NanPoison:
    """Poison ``frac`` of the named stage's input with NaN, seeded.

    ``once=True`` disarms after the first hit — the *transient* fault the
    ladder's retry rung is for; ``once=False`` models a persistent
    corruption that must end in a diagnosed ``SolverError``.
    """

    kind = "nan"

    def __init__(self, stage: str, frac: float = 0.01, seed: int = 0,
                 once: bool = False):
        self.stage = stage
        self.frac = frac
        self.seed = seed
        self.once = once
        self.hits = 0

    def positions(self, size: int) -> np.ndarray:
        """The flat indices poisoned in an input of ``size`` entries."""
        rng = np.random.default_rng(self.seed)
        k = max(1, int(self.frac * size))
        return rng.choice(size, size=k, replace=False)

    def apply(self, stage: str, x: torch.Tensor) -> torch.Tensor:
        """A poisoned clone of ``x`` (same device and dtype) if this fault
        targets ``stage`` and is armed; else ``x`` itself."""
        if stage != self.stage or (self.once and self.hits > 0):
            return x
        self.hits += 1
        out = x.clone()
        idx = torch.from_numpy(self.positions(x.numel())).to(x.device)
        out.view(-1)[idx] = float("nan")
        return out


class ForceNonconverge:
    """Make the Krylov path fail its restart budget, fast: the residual
    tolerance is clamped to an unreachable value and ``max_restarts``
    capped. Direct (TD/TT) solves are untouched, so the ladder's TT
    fallback succeeds while the fault is still armed."""

    kind = "nonconverge"

    def __init__(self, max_restarts_cap: int = 3):
        self.max_restarts_cap = max_restarts_cap
        self.hits = 0

    def apply_knobs(self, tol: float, max_restarts: int
                    ) -> Tuple[float, int]:
        self.hits += 1
        return 1e-300, min(max_restarts, self.max_restarts_cap)


class SimulatedPreemption(RuntimeError):
    """The preemption drill's error (raised by the distributed driver)."""

    def __init__(self, at_restart: int):
        super().__init__(f"simulated host preemption at restart "
                         f"{at_restart}")
        self.at_restart = at_restart


@contextlib.contextmanager
def inject(*faults) -> Iterator[None]:
    """Arm faults for the duration of the block (not thread-safe)."""
    prev = dict(_ACTIVE)
    try:
        for f in faults:
            _ACTIVE[f.kind] = f
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(prev)


def active(kind: str):
    return _ACTIVE.get(kind)


def poison_stage(stage: str, x: torch.Tensor) -> torch.Tensor:
    """Solver seam: pass a stage input through the armed NaN fault."""
    f = _ACTIVE.get("nan")
    return x if f is None else f.apply(stage, x)


def force_nonconverge(tol: float, max_restarts: int) -> Tuple[float, int]:
    """Solver seam: let the armed nonconvergence fault clamp the knobs."""
    f = _ACTIVE.get("nonconverge")
    return (tol, max_restarts) if f is None else f.apply_knobs(
        tol, max_restarts)


def nonspd_pencil(n: int, seed: int = 0, min_eig: float = -0.1):
    """A pencil whose B is symmetric but indefinite (min eig ~ min_eig),
    too far from SPD for the diagonal-shift rungs."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    A = 0.5 * (M + M.T)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.linspace(1.0, 2.0, n)
    evals[0] = min_eig
    B = (Q * evals) @ Q.T
    B = 0.5 * (B + B.T)
    return A, B


def near_breakdown_pencil(n: int, cond: float = 1e10, seed: int = 1):
    """SPD pencil with cond(B) ~ ``cond`` — the shift rung's territory."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    A = 0.5 * (M + M.T)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.geomspace(1.0 / cond, 1.0, n)
    B = (Q * evals) @ Q.T
    B = 0.5 * (B + B.T)
    return A, B


def slow_then_lost_trace(n_hosts: int = 4, slow_host: int = 2,
                         n_steps: int = 16, slowdown: float = 3.0
                         ) -> List[dict]:
    """Per-step host timing trace: one host degrades, then disappears.
    Each entry is ``{"times": [s per host], "lost": [host ids]}``; the
    slow host takes ``slowdown`` x the base step time for the first half,
    then drops out."""
    base = 0.1
    trace: List[dict] = []
    for step in range(n_steps):
        times = [base] * n_hosts
        lost: List[int] = []
        if step < n_steps // 2:
            times[slow_host] = base * slowdown
        else:
            lost = [slow_host]
            times[slow_host] = float("nan")
        trace.append({"times": times, "lost": lost})
    return trace
