"""The port's audit: budget contracts for every entry point
(``repro.analysis.static_audit`` in torch).

Where the reference lowers each solver program and walks its jaxpr, the
port RUNS each entry once at the small ``AuditSpec`` (on the CPU through
the plain versions, on the card through the kernels) and counts what
happened (``profile``): kernel calls by instance, stage entries,
collectives a step, host reads, isfinite sites and every float
conversion. ``contracts`` holds the budgets (the reference's constants,
names and values: TT1 3 collectives a panel, KE 2 a block step, dist TT3
exactly ``1 + iters``, ...), ``registry`` checks them,
``crosscheck`` holds the cost model to the counts, ``dtype_lint`` and
``kernel_lint`` lint the dtype policy and the wrappers' signatures, and
``launch/audit.py`` is the CLI.
"""
from .contracts import (AuditSpec, KE_COLLECTIVES_PER_BLOCK_STEP,
                        TT1_COLLECTIVES_PER_PANEL, ke_dispatch_budget,
                        lanczos_block_dispatch_budget,
                        lanczos_single_dispatch_budget, register_all,
                        tt3_dist_collectives)
from .crosscheck import (CrossCheck, all_ok, crosscheck_stagecosts,
                         dispatch_drift)
from .dtype_lint import find_precision_leaks, lint_reports
from .kernel_lint import LintFinding, errors, lint_signature_parity
from .profile import ProgramProfile, mark_step, profile_fn
from .registry import (AuditEntry, BudgetContract, EntryReport, ProgramSpec,
                       check_all, check_entry, clear_registry, entries,
                       get_entry, register)

__all__ = [
    "AuditSpec", "register_all",
    "ProgramProfile", "profile_fn", "mark_step",
    "AuditEntry", "BudgetContract", "EntryReport", "ProgramSpec",
    "register", "get_entry", "entries", "clear_registry", "check_entry",
    "check_all",
    "CrossCheck", "crosscheck_stagecosts", "dispatch_drift", "all_ok",
    "LintFinding", "lint_signature_parity", "errors",
    "find_precision_leaks", "lint_reports",
    "TT1_COLLECTIVES_PER_PANEL", "KE_COLLECTIVES_PER_BLOCK_STEP",
    "ke_dispatch_budget", "lanczos_block_dispatch_budget",
    "lanczos_single_dispatch_budget", "tt3_dist_collectives",
]
