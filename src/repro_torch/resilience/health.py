"""Stage-boundary health sentinels (``repro.resilience.health`` in torch).

``array_finite`` and ``chol_health`` are reductions that stay on the
device; the caller fetches the verdict where the reference fetched it.
``host_finite`` reads tensors on the host, so on a CUDA tensor it waits
for the card: it runs only where the reference fetched anyway (the TD1
tridiagonal and the final output). The per-stage booleans fold into a
``HealthVerdict`` carried in ``info["health"]``, JSON-clean through
``as_json_dict``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

__all__ = ["HealthVerdict", "array_finite", "chol_health", "host_finite",
           "verdict_from_stages"]


@dataclass
class HealthVerdict:
    """Per-stage finite/converged verdict for one solve."""

    healthy: bool = True
    stages: Dict[str, bool] = field(default_factory=dict)
    first_unhealthy_stage: Optional[str] = None
    detail: str = ""

    def record(self, stage: str, ok) -> bool:
        ok = bool(ok)
        self.stages[stage] = ok
        if not ok and self.healthy:
            self.healthy = False
            self.first_unhealthy_stage = stage
        return ok

    def as_json_dict(self) -> dict:
        return {
            "healthy": bool(self.healthy),
            "stages": {k: bool(v) for k, v in self.stages.items()},
            "first_unhealthy_stage": self.first_unhealthy_stage,
            "detail": self.detail,
        }


def array_finite(*arrays: torch.Tensor) -> torch.Tensor:
    """All-finite reduction over one or more tensors (a 0-d bool tensor on
    their device)."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok


def chol_health(U: torch.Tensor):
    """GS1 sentinel: finite factor with a positive diagonal, and the
    smallest finite diagonal entry. ``core.cholesky.cholesky_upper`` turns
    a breakdown that ``cholesky_ex`` reports in ``info`` into an all-NaN
    factor, so finiteness catches a B that is not SPD."""
    d = torch.diagonal(U)
    ok = torch.isfinite(U).all() & (d > 0).all()
    return ok, torch.min(torch.where(torch.isfinite(d), d, 0.0))


def host_finite(*arrays: torch.Tensor) -> bool:
    """All-finite check read on the host (waits for a CUDA tensor)."""
    return all(bool(torch.isfinite(a).all()) for a in arrays)


def verdict_from_stages(stages: Dict[str, bool], detail: str = "",
                        ) -> HealthVerdict:
    v = HealthVerdict(detail=detail)
    for name, ok in stages.items():
        v.record(name, ok)
    return v
