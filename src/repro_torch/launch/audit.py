"""The port's audit CLI: prove every entry point has the shape we claim.

    PYTHONPATH=src python -m repro_torch.launch.audit --device cpu
    PYTHONPATH=src python -m repro_torch.launch.audit --device cpu --quick
    PYTHONPATH=src python -m repro_torch.launch.audit --device cpu --devices 1
    PYTHONPATH=src python -m repro_torch.launch.audit --device cpu \\
        --entry dist/tt3_program

Runs every registered entry (``analysis.static_audit.contracts``) once at
the small ``AuditSpec`` and counts it (``profile``): the TT1 sweep, the
bulge chase and its replay, TT3, the fixed-trip Krylov loop, the
``solve_batched`` buckets at fp64, mixed and fast, the distributed TT1
sweep, KE restart, KE prep and TT3 on a mesh, the GS1/GS2 health
sentinels and every kernel family's ops wrapper; then holds each to its
budget (kernel calls, stage entries, collectives a step and in all, host
reads, isfinite sites, the dtype policy), lints the wrappers' signatures
against their plain versions and cross-checks ``analysis.variant_model``
against the counts.

Runs on the card (``--device cuda``, the default; no CUDA raises) unless
``--device cpu``; ``--quick`` leaves out the ten ``solve_batched``
buckets. On the card every entry is also held to its recorded
kernel calls equalling the launch counters' deltas. ``--devices N``
(default 2) runs the mesh entries on an (N, 1) mesh of N ranks in one
spawn (``dist.launcher.run_local``: gloo on the CPU, NCCL on the cards);
``--devices 1`` skips them. Writes ``artifacts/AUDIT_torch.json`` (not the
reference's ``artifacts/AUDIT.json``), prints ``AUDIT PASSED`` or
``AUDIT FAILED`` and exits nonzero on a budget, dtype, lint or exact
cross-check violation (warnings do not fail).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis.static_audit import (
    AuditSpec, all_ok, check_entry, crosscheck_stagecosts, dispatch_drift,
    entries, errors, get_entry, lint_reports, lint_signature_parity,
    register_all)
from repro_torch.analysis.static_audit.registry import skipped_report

DEFAULT_OUT = "artifacts/AUDIT_torch.json"


def _mesh_reports(mesh, names: Sequence[str], spec: AuditSpec) -> dict:
    """The mesh entries ``names``, checked inside every rank of ``mesh``
    on its device (a spawned rank starts with an empty registry)."""
    from repro_torch.dist.mesh import mesh_device
    register_all(spec, mesh_device(mesh))
    return {name: check_entry(get_entry(name), mesh) for name in names}


def run_audit(quick: bool = False, entry: Optional[str] = None,
              spec: Optional[AuditSpec] = None, device=None,
              mesh_shape: Optional[Tuple[int, ...]] = (2, 1)) -> dict:
    """Audit everything (the ``quick`` entries, or one entry) on
    ``device`` (the card unless ``device="cpu"``); the mesh entries on a
    ``mesh_shape`` world of ranks (``None`` skips them). Returns the
    ``AUDIT_torch.json`` payload."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    spec = register_all(spec, dev)
    selected = [get_entry(entry)] if entry else entries(
        ["quick"] if quick else None)
    meshed = [e.name for e in selected if e.needs_mesh]
    reports = {e.name: check_entry(e) for e in selected
               if not e.needs_mesh}
    if meshed and mesh_shape is not None:
        from repro_torch.dist.launcher import run_local
        reports.update(run_local(_mesh_reports, mesh_shape, dev.type,
                                 meshed, spec))
    else:
        reports.update({name: skipped_report(get_entry(name))
                        for name in meshed})
    reports = [reports[e.name] for e in selected]
    rd = {r.name: r for r in reports}

    checks = crosscheck_stagecosts(rd, spec) if entry is None else []
    sigs = lint_signature_parity() if entry is None else []
    dtypes = lint_reports(rd)
    n_viol = sum(len(r.violations) for r in reports)
    n_lint_err = len(errors(sigs))
    n_xfail = sum(1 for c in checks if not c.ok)
    ok = n_viol == 0 and n_lint_err == 0 and all_ok(checks) and dtypes["ok"]
    # the health sentinels in one place: every sentinel-bearing contract
    # holds with ZERO extra host reads or stage entries, and its isfinite
    # sites are in the path
    sentinel = [r for r in reports if not r.skipped
                and (r.contract.min_isfinite_sites
                     or r.contract.min_isfinite_sites_per_program)]
    return {
        "schema": "repro_torch/audit/v1",
        "torch_version": torch.__version__,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "mesh": list(mesh_shape) if mesh_shape and meshed else None,
        "spec": spec.as_json_dict(),
        "ok": ok,
        "summary": {
            "entries": len(reports),
            "skipped": sum(1 for r in reports if r.skipped),
            "budget_violations": n_viol,
            "crosscheck_failures": n_xfail,
            "lint_errors": n_lint_err,
            "lint_warnings": len(sigs) - n_lint_err,
            "precision_leaks": len(dtypes["precision_leaks"]),
            "seconds": sum(p.seconds for r in reports
                           for p in r.profiles + r.probes),
        },
        "sentinels": {
            "entries": len(sentinel),
            "isfinite_sites": sum(r.isfinite_sites for r in sentinel),
            "extra_dispatches_allowed": max(
                (r.contract.sentinel_extra_dispatches for r in sentinel),
                default=0),
            "ok": all(r.ok for r in sentinel),
        },
        "entries": [r.as_json_dict() for r in reports],
        "crosscheck": [c.as_json_dict() for c in checks],
        "dispatch_drift": dispatch_drift(rd, spec) if entry is None else [],
        "signature_lint": [f.as_json_dict() for f in sigs],
        "dtype_lint": dtypes,
    }


def print_human(payload: dict) -> None:
    mesh = payload["mesh"]
    print(f"audit: {payload['summary']['entries']} entries on "
          f"{payload['device_name']}"
          + (f", mesh {tuple(mesh)}" if mesh else ", no mesh")
          + f", torch {payload['torch_version']}")
    for e in payload["entries"]:
        if e["skipped"]:
            print(f"  SKIP {e['name']} (needs a mesh)")
            continue
        mark = "ok  " if e["ok"] else "FAIL"
        calls = ", ".join(f"{k} {v}" for k, v in e["kernel_calls"].items())
        stages = ", ".join(f"{k} {v}" for k, v in e["stage_entries"].items())
        print(f"  {mark} {e['name']}: kernel calls [{calls}], stage "
              f"entries [{stages}], {e['total_collectives']} collective(s), "
              f"<= {e['max_collectives_per_step']}/step, "
              f"{e['host_reads']} host read(s), {e['isfinite_sites']} "
              f"isfinite")
        for v in e["violations"]:
            print(f"       !! {v}")
    if payload["crosscheck"]:
        print("cost-model cross-check (StageCost vs counted):")
        for c in payload["crosscheck"]:
            mark = "ok  " if c["ok"] else "FAIL"
            print(f"  {mark} {c['stage']}.{c['field']}: model "
                  f"{c['model_value']:g} vs counted {c['counted_value']:g} "
                  f"({c['relation']})")
    for d in payload["dispatch_drift"]:
        print(f"  drift {d['stage']}: model {d['model_dispatches']:g} "
              f"dispatch(es) vs {d['counted_launches']} kernel launch(es) "
              f"{d['kernel_calls']} and stage entries {d['stage_entries']} "
              f"({d['entry']}; reported, not checked)")
    for f in payload["signature_lint"]:
        tag = "!!" if f["severity"] == "error" else "--"
        print(f"  {tag} [{f['check']}] {f['kernel']}: {f['detail']}")
    for leak in payload["dtype_lint"]["precision_leaks"]:
        print(f"  !! precision leak: {leak}")
    for name, built in payload["dtype_lint"]["bucket_recaptures"].items():
        print(f"  !! {name}: the second call built {built} program(s)")
    sen = payload["sentinels"]
    mark = "ok  " if sen["ok"] else "FAIL"
    print(f"  {mark} health sentinels: {sen['isfinite_sites']} isfinite "
          f"site(s) across {sen['entries']} contract(s), "
          f"+{sen['extra_dispatches_allowed']} host reads or stage entries "
          f"allowed")
    print("AUDIT " + ("PASSED" if payload["ok"] else "FAILED"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run-and-count budget audit of every entry point of "
                    "the port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks of the mesh the mesh entries run on (an "
                         "(N, 1) mesh); 1 skips them")
    ap.add_argument("--quick", action="store_true",
                    help="only the 'quick'-tagged entries: all but the ten "
                         "solve_batched buckets")
    ap.add_argument("--entry", default=None,
                    help="audit a single registry entry by name")
    ap.add_argument("--json", action="store_true",
                    help="print the payload as JSON instead of a summary")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT,
                    help="artifact path ('' disables writing)")
    args = ap.parse_args(argv)
    if args.devices < 1:
        raise SystemExit(f"--devices must be >= 1, got {args.devices}")
    shape = (args.devices, 1) if args.devices > 1 else None
    payload = run_audit(quick=args.quick, entry=args.entry,
                        device=args.device, mesh_shape=shape)
    if args.out and args.entry is None:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.json:
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        print_human(payload)
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
