"""The degradation ladder (``repro.resilience.recovery``):

* Cholesky breakdown (GS1 NaN / nonpositive pivot): retry with a
  relative diagonal shift ``tau * max|diag B|`` for each rung in
  ``cholesky_shift_taus()``. Exhausted -> diagnosed ``SolverError``.
* Non-finite stage or output: a transient retry with a fresh start block
  under ``on_failure="recover"``, else raise ``SolverError`` naming the
  failing stage.
* An unconverged KE/KI: ``escalate_krylov``, then ``fallback_variant``
  (TT); a demoted solve whose refinement stalls above tolerance:
  ``escalate_precision`` (a rerun at fp64). These rungs are climbed by
  ``core.gsyeig.solve``.

Every rung taken is appended to ``info["recovery"]`` as a plain dict
(action, stage, params, outcome). ``faults.py`` injects the faults the
ladder is drilled against.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["SolverError", "ON_FAILURE", "validate_on_failure",
           "cholesky_shift_taus", "rung"]

ON_FAILURE = ("recover", "warn", "ignore")

# relative diagonal shifts tried on GS1 breakdown, weakest first —
# 1e-14 rescues roundoff-level indefiniteness without moving converged
# eigenvalues past the 1e-12 Table-3 tolerances; 1e-6 is the last rung
# before the pencil is declared non-SPD
_SHIFT_TAUS = (1e-14, 1e-10, 1e-6)


class SolverError(RuntimeError):
    """A diagnosed solver failure.

    ``diagnosis`` is a JSON-clean dict: ``stage``, ``reason``
    (``cholesky_breakdown`` | ``nonfinite_stage`` | ``nonfinite_output``),
    ``hint``, and the ``recovery`` trail of rungs already attempted.
    """

    def __init__(self, message: str, *, stage: str, reason: str,
                 hint: str = "", recovery=None, health=None):
        super().__init__(message)
        self.diagnosis = {
            "stage": stage,
            "reason": reason,
            "hint": hint,
            "recovery": list(recovery or []),
        }
        if health is not None:
            self.diagnosis["health"] = health


def validate_on_failure(on_failure: str) -> str:
    if on_failure not in ON_FAILURE:
        raise ValueError(
            f"on_failure must be one of {ON_FAILURE}, got {on_failure!r}")
    return on_failure


def cholesky_shift_taus() -> Tuple[float, ...]:
    return _SHIFT_TAUS


def rung(action: str, stage: str, outcome: str, **params) -> dict:
    """One recovery-ladder entry for ``info['recovery']``."""
    entry = {"action": action, "stage": stage, "outcome": outcome}
    if params:
        entry["params"] = {k: (float(v) if isinstance(v, float) else v)
                           for k, v in params.items()}
    return entry
