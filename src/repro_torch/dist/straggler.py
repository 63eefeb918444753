"""Per-host step-time monitoring and microbatch rebalancing.

``StragglerMonitor`` keeps a sliding window of per-host step durations.
A host is a straggler when its windowed mean exceeds ``threshold`` times
the across-host median. ``rebalance_plan`` turns observed speeds (1 /
mean step time) into an integer microbatch allocation with the same total
work, by largest-remainder rounding: slow hosts shed load, fast hosts
absorb it. The port's own copy of ``repro.dist.straggler``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List


class StragglerMonitor:
    def __init__(self, n_hosts: int, window: int = 64,
                 threshold: float = 1.5):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = n_hosts
        self.threshold = threshold
        self._times = [deque(maxlen=window) for _ in range(n_hosts)]

    def record(self, host: int, seconds: float) -> None:
        self._times[host].append(float(seconds))

    def _means(self) -> List[float]:
        """Per-host windowed mean; hosts with no samples take the median
        of the observed hosts (they cannot be classified either way)."""
        raw = [sum(t) / len(t) if t else None for t in self._times]
        seen = sorted(m for m in raw if m is not None)
        fallback = seen[len(seen) // 2] if seen else 1.0
        return [fallback if m is None else m for m in raw]

    def stragglers(self) -> List[int]:
        """Hosts whose mean step time exceeds threshold x median."""
        means = self._means()
        med = sorted(means)[len(means) // 2]
        return [h for h, m in enumerate(means) if m > self.threshold * med]

    def rebalance_plan(self, microbatches_per_host: int) -> Dict[int, int]:
        """host -> microbatch count, preserving the global total; shares
        proportional to speed, largest remainders first (host id breaks
        ties)."""
        total = self.n_hosts * microbatches_per_host
        speeds = [1.0 / max(m, 1e-9) for m in self._means()]
        ssum = sum(speeds)
        raw = [total * sp / ssum for sp in speeds]
        plan = {h: int(r) for h, r in enumerate(raw)}
        short = total - sum(plan.values())
        order = sorted(range(self.n_hosts),
                       key=lambda h: (-(raw[h] - plan[h]), h))
        for h in order[:short]:
            plan[h] += 1
        return plan


__all__ = ["StragglerMonitor"]
