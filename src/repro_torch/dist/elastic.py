"""Elastic remeshing: recompute the device mesh after churn.

When hosts join or leave mid-run, the model-parallel degree is held fixed;
only the data axis (and optionally a leading pod axis) flexes.
``plan_remesh`` keeps ``model_parallel`` intact, divides the surviving
devices into ``pods x data x model`` (or ``data x model`` for one pod),
and drops a ragged remainder rather than failing the job. Raises
``ValueError`` when not even one data slice fits. The port's own copy of
``repro.dist.elastic``; its shapes feed ``dist.make_mesh``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class RemeshPlan(NamedTuple):
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_used: int
    n_dropped: int
    note: str


def plan_remesh(n_devices: int, model_parallel: int,
                pods: int = 1) -> RemeshPlan:
    """Mesh plan for ``n_devices`` survivors at fixed ``model_parallel``:
    shape ``(pods, data, model_parallel)`` when ``pods > 1``, else
    ``(data, model_parallel)``. A remainder that fills no whole data row
    is dropped (the plan's ``note`` says how many devices idle)."""
    if model_parallel < 1 or pods < 1:
        raise ValueError(f"bad plan inputs: mp={model_parallel} pods={pods}")
    data = (n_devices // pods) // model_parallel
    if data < 1:
        raise ValueError(
            f"{n_devices} devices across {pods} pod(s) cannot sustain "
            f"model_parallel={model_parallel}")
    n_used = pods * data * model_parallel
    n_dropped = n_devices - n_used
    note = (f"dropping {n_dropped} ragged device(s) to keep "
            f"model_parallel={model_parallel}" if n_dropped else
            f"exact fit at model_parallel={model_parallel}")
    if pods > 1:
        return RemeshPlan((pods, data, model_parallel),
                          ("pod", "data", "model"), n_used, n_dropped, note)
    return RemeshPlan((data, model_parallel), ("data", "model"), n_used,
                      n_dropped, note)


__all__ = ["RemeshPlan", "plan_remesh"]
