"""Kernel wrapper lint: ops-versus-plain signature parity (the port's
counterpart of ``repro.analysis.static_audit.pallas_lint``).

Every public ops wrapper ``X`` with a plain version ``X_ref`` in its
family's ``ref.py`` must accept the plain version's required tensor
arguments as its leading parameters (the wrapper-only knobs, such as
``bm`` or ``block``, come after, with defaults), so that tests and callers
can swap the two without shims.

The reference's other two checks are not ported: the (8, 128) sublane x
lane tile multiples and the double-buffered VMEM footprint describe
Pallas BlockSpecs on a TPU. The CUDA kernels take their shapes as they
are (no padding to tiles), and their shared-memory plans are checked by
the planners that make them (``house_plan``, ``chase_plan``,
``orth_plan``, ...), which raise on a plan that does not fit.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import pkgutil
from typing import List

#: wrapper -> plain-version pairs outside the ``X`` / ``X_ref`` naming
#: (``None``: no single plain version takes the wrapper's arguments)
_REF_ALIASES = {"invit_batched": "invit_ref",
                # the plain bisection takes the kernel's inputs (e2, scal),
                # which the wrapper derives from (d, e)
                "bisect_sturm": None,
                "symm_block": "symm_block_upper_ref",
                "symv": "symv_upper_ref"}


@dataclasses.dataclass
class LintFinding:
    kernel: str
    check: str       # "signature"
    severity: str    # "error" | "warn"
    detail: str

    def as_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def _required_params(fn) -> List[str]:
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def lint_signature_parity(package: str = "repro_torch.kernels"
                          ) -> List[LintFinding]:
    """Wrapper-versus-plain parity across every family's ``ops`` module."""
    findings: List[LintFinding] = []
    pkg = importlib.import_module(package)
    for info in pkgutil.iter_modules(pkg.__path__):
        if not info.ispkg:
            continue
        ops = importlib.import_module(f"{package}.{info.name}.ops")
        ref = importlib.import_module(f"{package}.{info.name}.ref")
        pairs = 0
        for attr in getattr(ops, "__all__", ()):
            fn = getattr(ops, attr)
            ref_name = _REF_ALIASES.get(attr, f"{attr}_ref")
            plain = None if ref_name is None else getattr(ref, ref_name,
                                                          None)
            if plain is None:
                continue
            pairs += 1
            req = _required_params(plain)
            params = list(inspect.signature(fn).parameters)
            if params[:len(req)] != req:
                findings.append(LintFinding(
                    info.name, "signature", "error",
                    f"{attr}({', '.join(params)}) does not lead with "
                    f"{ref_name}'s required args ({', '.join(req)})"))
        if pairs == 0:
            findings.append(LintFinding(
                info.name, "signature", "warn",
                "no wrapper/plain pair found to compare"))
    return findings


def errors(findings: List[LintFinding]) -> List[LintFinding]:
    return [f for f in findings if f.severity == "error"]


__all__ = ["LintFinding", "lint_signature_parity", "errors"]
