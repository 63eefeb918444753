"""Dtype policy lint: precision leaks and bucket re-captures
(``repro.analysis.static_audit.dtype_lint`` in torch).

Two failure modes the fp64 pipelines must never pick up silently:

* **precision leaks**: a conversion demoting float64 to float32, bfloat16
  or float16 that the entry's contract did not DECLARE (a float32 tensor
  made from a Python literal, an fp32 intermediate of a helper). The
  profile records every float conversion with its count;
  ``find_precision_leaks`` lists the demotions outside the contract's
  ``declared_downcasts``. The mixed and fast pipelines declare their
  demoted stages (``core.precision.declared_downcasts``); the fp64
  contracts declare nothing, so for them every downcast is a leak, and
  each contract also forbids undeclared ones (``forbid_f64_downcasts``),
  so the audit fails on one.
* **re-captures**: the reference lints weak-typed inputs, which trace a
  second program for one shape bucket. The port's counterpart is a second
  call of a bucket that builds its program again: the batched entries'
  ``warm`` run counts the pipelines and programs it built (the
  ``bucket_reuse`` contract), and ``lint_reports`` lists any.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from .profile import ProgramProfile
from .registry import EntryReport


def find_precision_leaks(profile: ProgramProfile,
                         declared: Sequence[str] = ()) -> List[str]:
    """Human-readable leaks of one profiled program: its float64
    demotions outside ``declared`` (the owning contract's
    ``declared_downcasts``)."""
    allowed = set(declared)
    return [f"{profile.name}: {conv} x{count}"
            for conv, count in sorted(profile.f64_downcasts().items())
            if conv not in allowed]


def lint_reports(reports: Dict[str, EntryReport]) -> dict:
    """The dtype findings of every entry, for ``AUDIT_torch.json``."""
    leaks: List[str] = []
    recaptures: Dict[str, int] = {}
    converts: Dict[str, int] = {}
    for name, rep in reports.items():
        if rep.skipped:
            continue
        declared = rep.contract.declared_downcasts
        for prof in rep.profiles:
            leaks.extend(f"{name}/{leak}"
                         for leak in find_precision_leaks(prof, declared))
            if prof.name == "warm":
                built = (prof.extra.get("pipelines_built", 0)
                         + prof.extra.get("programs_built", 0))
                if built or not prof.extra.get("cache_hit", True):
                    recaptures[name] = built
            for conv, count in prof.converts.items():
                converts[conv] = converts.get(conv, 0) + count
    return {"precision_leaks": leaks,
            "bucket_recaptures": recaptures,
            "convert_counts": converts,
            "ok": not leaks and not recaptures}


__all__ = ["find_precision_leaks", "lint_reports"]
