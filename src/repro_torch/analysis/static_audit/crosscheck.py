"""Cost-model cross-check: ``StageCost`` fields against what the audit
counted (``repro.analysis.static_audit.crosscheck`` in torch).

``analysis.variant_model`` prices each stage as (flops, bytes,
collective_bytes, dispatches, collectives, loop_steps), and the router
trusts those numbers. This module holds them to the audited runs, so
that model drift is a reported number:

* exact where the port is exactly countable: TT1 collectives a panel, KE
  collectives a block step and a restart segment, KE stage entries
  ``restarts + 2`` (the probe's ``dist.eigensolver`` counter), the TT2
  and TT4 step totals over the passes that ran;
* relative where the model is a smooth formula over a discrete schedule:
  TT1's total collectives (``3 n/w`` against ``3 n_panels``, 0.35) and
  TT3's loop steps (0.15).

The model's per-stage ``dispatches`` (TT1 2, TT2 1, TT3 1, ...) describe
the reference's fused JAX programs, which the port does not have: they
are reported beside the port's counted kernel calls and stage entries
(``dispatch_drift``) and never failed on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.analysis import variant_model as vm

from .contracts import (AuditSpec, KE_COLLECTIVES_PER_BLOCK_STEP,
                        TT1_COLLECTIVES_PER_PANEL, ke_dispatch_budget)
from .registry import EntryReport


@dataclasses.dataclass
class CrossCheck:
    stage: str
    field: str
    model_value: float
    counted_value: float
    relation: str          # "exact" | "rel<=tol"
    tol: float
    ok: bool
    note: str = ""

    def as_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def _exact(stage, field, model, counted, note="") -> CrossCheck:
    return CrossCheck(stage, field, float(model), float(counted), "exact",
                      0.0, float(model) == float(counted), note)


def _rel(stage, field, model, counted, tol, note="") -> CrossCheck:
    denom = max(abs(float(counted)), 1.0)
    err = abs(float(model) - float(counted)) / denom
    return CrossCheck(stage, field, float(model), float(counted),
                      f"rel<={tol}", tol, err <= tol, note)


def chase_steps(n: int, passes: List[int]) -> int:
    """Sequential steps of the chase passes ``passes`` (bandwidths): each
    pass's ``T_pass`` in ``kernels/rot_apply/schedule.py::pass_schedule``
    (the reference's stagger, which the model prices)."""
    from repro_torch.kernels.rot_apply.schedule import pass_schedule
    return sum(pass_schedule(n, b)[1] for b in passes)


def replay_steps(n: int, passes: List[int]) -> int:
    """Sequential sweeps of the replay of ``passes``: a pass replays its
    ``J = n - b`` recorded column sweeps (``pass_schedule``'s J)."""
    from repro_torch.kernels.rot_apply.schedule import pass_schedule
    return sum(pass_schedule(n, b)[3] for b in passes)


def _plan_sms(report: EntryReport) -> int:
    """The SMs ``bisect_plan`` was given on the run of ``report``: the
    card's (``kernel.sm_count``) where it ran there, else the H100's that
    the planners assume (``kernels.gemm.kernel.SMS``)."""
    from repro_torch.kernels.gemm.kernel import SMS
    from repro_torch.kernels.tridiag_eig.kernel import sm_count
    dev = next((p.device for p in report.profiles
                if p.device.startswith("cuda")), None)
    return SMS if dev is None else sm_count(torch.device(dev).index or 0)


def tt3_steps(n: int, s: int, bisections: int, rounds: int,
              max_iters: int, sms: int) -> int:
    """Sequential steps of the port's TT3 schedule: each bisection launch
    runs ``ceil(max_iters / levels)`` Sturm sweeps of n rows at
    ``bisect_plan``'s levels on ``sms`` SMs (its most, without the early
    stop), and each inverse-iteration round the solve's fused
    factor-and-forward pass (n - 1 rows), its back substitution (n) and
    the Gram-Schmidt over the s columns (``kernels/tridiag_eig/kernel.py``)."""
    from repro_torch.kernels.tridiag_eig.kernel import bisect_plan
    levels = bisect_plan(n, s, sms, max_iters).levels
    sweeps = -(-max_iters // levels)
    return bisections * sweeps * n + rounds * ((n - 1) + n + s)


def _passes(report: EntryReport, n: int, w: int, kernel: str) -> List[int]:
    """The bandwidths of the passes the entry ran: the executed passes'
    schedule, as many as its recorded ``kernel`` calls."""
    from repro_torch.core.sbr import _executed_passes
    return _executed_passes(n, w)[:report.kernel_calls.get(kernel, 0)]


def crosscheck_stagecosts(reports: Dict[str, EntryReport],
                          spec: Optional[AuditSpec] = None
                          ) -> List[CrossCheck]:
    """Compare StageCost fields to the counted runs. ``reports`` is
    ``{entry_name: EntryReport}``; a skipped or absent entry's checks are
    left out."""
    from repro_torch.kernels.tridiag_eig.kernel import LAUNCHES_PER_ROUND
    spec = spec or AuditSpec()
    n, s, w, p, m = spec.n, spec.s, spec.w, spec.p, spec.m
    tt = vm.stage_costs("TT", n, s, band_width=w)
    checks: List[CrossCheck] = []

    def got(name):
        r = reports.get(name)
        return None if r is None or r.skipped else r

    r = got("dist/band_sweep_program")
    if r is not None:
        checks.append(_exact(
            "TT1", "collectives_per_panel",
            tt["TT1"].collectives / (n / max(w, 1)),
            r.max_collectives_per_step,
            f"gather+all_reduce+gather = {TT1_COLLECTIVES_PER_PANEL}"))
        checks.append(_rel(
            "TT1", "collectives", tt["TT1"].collectives,
            r.total_collectives, 0.35,
            "model 3 n/w vs counted 3 n_panels (discrete panel schedule)"))

    r = got("core/band_chase")
    if r is not None:
        checks.append(_exact(
            "TT2", "loop_steps", tt["TT2"].loop_steps,
            chase_steps(n, _passes(r, n, w, "chase_pass")),
            "pass_schedule's T_pass over the chase_pass launches"))

    r = got("core/tridiag_eig_batched")
    if r is not None:
        calls = r.kernel_calls
        checks.append(_rel(
            "TT3", "loop_steps", tt["TT3"].loop_steps,
            tt3_steps(n, s, calls.get("bisect_sturm", 0),
                      calls.get("invit", 0) // LAUNCHES_PER_ROUND,
                      spec.tt3_max_iters, _plan_sms(r)), 0.15,
            "bisect_plan's sweeps x n + a round's solve and Gram-Schmidt"))

    r = got("core/apply_q2")
    if r is not None:
        checks.append(_exact(
            "TT4", "loop_steps", tt["TT4"].loop_steps,
            replay_steps(n, _passes(r, n, w, "replay_pass")),
            "J = n - b recorded sweeps a replay_pass launch"))

    r = got("dist/ke_restart_program")
    if r is not None:
        n_iter = vm.estimate_lanczos_iters(n, s, m, p=p)
        ke = vm.stage_costs("KE", n, s, m=m, p=p, n_iter=n_iter)["KE_iter"]
        n_restart = vm.estimate_lanczos_restarts(n_iter, s, m, p)
        n_block_steps = -(-n_iter // p)
        checks.append(_exact(
            "KE", "collectives_per_block_step",
            ke.collectives / n_block_steps, r.max_collectives_per_step,
            f"all_reduce + all_gather = {KE_COLLECTIVES_PER_BLOCK_STEP}"))
        checks.append(_exact(
            "KE", "collectives_per_restart_segment",
            KE_COLLECTIVES_PER_BLOCK_STEP * (m // p), r.total_collectives,
            "2 collectives x (m/p) block steps of a segment from block 0"))
        solve = next((q for q in r.probes
                      if q.name == "solve_ke_distributed"), None)
        if solve is not None:
            counted = solve.stage_entries.get("dist", 0)
            checks.append(_exact(
                "KE", "dispatches",
                ke.dispatches - n_restart,
                counted - solve.extra["n_restart"],
                f"restarts + 2: model {ke.dispatches:g} at its "
                f"{n_restart} restarts; counted {counted} stage entries at "
                f"{solve.extra['n_restart']} (ke_dispatch_budget = "
                f"{ke_dispatch_budget(solve.extra['n_restart'])})"))
    return checks


def dispatch_drift(reports: Dict[str, EntryReport],
                   spec: Optional[AuditSpec] = None) -> List[dict]:
    """The model's per-stage ``dispatches`` beside what the port counted
    on the entry of that stage (kernel calls by instance and stage
    entries): reported, not failed on (module docstring)."""
    spec = spec or AuditSpec()
    n, s, w = spec.n, spec.s, spec.w
    tt = vm.stage_costs("TT", n, s, band_width=w)
    td = vm.stage_costs("TD", n, s)
    ke = vm.stage_costs("KE", n, s, m=spec.m, p=spec.p)["KE_iter"]
    rows = [("TT1", tt["TT1"].dispatches, "core/reduce_to_band"),
            ("TT2", tt["TT2"].dispatches, "core/band_chase"),
            ("TT3", tt["TT3"].dispatches, "core/tridiag_eig_batched"),
            ("TD2", td["TD2"].dispatches, "core/tridiag_eig_batched"),
            ("TT4", tt["TT4"].dispatches, "core/apply_q2"),
            ("KE", ke.dispatches, "dist/ke_restart_program")]
    out = []
    for stage, model, entry in rows:
        r = reports.get(entry)
        if r is None or r.skipped:
            continue
        calls, stages = dict(r.kernel_calls), dict(r.stage_entries)
        if stage == "KE":
            probe = next((q for q in r.probes
                          if q.name == "solve_ke_distributed"), None)
            if probe is None:
                continue
            calls, stages = dict(probe.kernel_calls), dict(
                probe.stage_entries)
        out.append({"stage": stage, "entry": entry,
                    "model_dispatches": float(model),
                    "kernel_calls": calls,
                    "counted_launches": int(sum(calls.values())),
                    "stage_entries": stages})
    return out


def all_ok(checks: List[CrossCheck]) -> bool:
    return all(c.ok for c in checks)


__all__ = ["CrossCheck", "crosscheck_stagecosts", "dispatch_drift",
           "all_ok", "chase_steps", "replay_steps", "tt3_steps"]
