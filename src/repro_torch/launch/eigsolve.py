"""CLI for the port's eigensolver (the TD, TT, KE and KI variants):

    PYTHONPATH=src python -m repro_torch.launch.eigsolve \\
        --problem md --n 9997 --s 100 --variant KE --invert --json

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. The payload has the keys of ``repro.launch.eigsolve`` plus
``device`` and ``kernel_launches`` (launches of each kernel instance);
with ``--variant auto`` the router's decision and table under ``router``;
with ``--precision mixed|fast`` it also has ``precision`` and the
``refinement`` block (steps, converged, and the relative-residual and
B-orthogonality trajectories of the fp64 refinement).

``--mesh DATAxMODEL`` runs the KE or TT variant (or ``auto``, narrowed to
those two) on a (data, model) mesh through ``repro_torch.dist``: one rank
a mesh position, started by ``dist.launcher.run_local`` (gloo with
``--device cpu``, NCCL on the cards, one card a rank; ``--devices N``
must equal DATA x MODEL and not exceed the visible cards). On the CPU:

    PYTHONPATH=src python -m repro_torch.launch.eigsolve --problem md \
        --n 64 --s 4 --variant TT --devices 2 --mesh 2x1 --device cpu --json

The payload's ``mesh`` and ``n_devices`` report the mesh (``"single"`` and
the visible devices without one).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import accuracy_report, solve
from repro_torch.data.problems import dft_like, md_like
from repro_torch.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=["md", "dft"], default="md")
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--s", type=int, default=8)
    ap.add_argument("--variant", choices=["TD", "TT", "KE", "KI", "auto"],
                    default="TD", help="auto: the cost model's router "
                                       "(its decision under 'router')")
    ap.add_argument("--which", choices=["smallest", "largest"],
                    default="smallest")
    ap.add_argument("--invert", action="store_true",
                    help="the paper's MD trick (requires A SPD)")
    ap.add_argument("--gs2", choices=["trsm", "sygst"], default="trsm",
                    help="GS2: two triangular solves, or the blocked DSYGST")
    ap.add_argument("--td1", choices=["unblocked", "blocked"],
                    default="unblocked",
                    help="TD1: unblocked, or the dlatrd-style panels of 32")
    ap.add_argument("--band-width", type=int, default=8,
                    help="TT's band width w (stage 1 reduces to w)")
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=300)
    ap.add_argument("--p", type=int, default=None, dest="krylov_block",
                    help="Lanczos block size (s-step width); default 1")
    ap.add_argument("--filter-degree", type=int, default=None,
                    help="Chebyshev start-filter degree (KE/KI); default: "
                         "16 on clustered spectra, else off; 0 forces off")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="Lanczos residual tolerance (0 = machine-eps "
                         "criterion)")
    ap.add_argument("--precision", choices=["fp64", "mixed", "fast"],
                    default="fp64",
                    help="compute dtype of the GEMM-heavy stages (mixed = "
                         "fp32, fast = bf16 with fp32 accumulation); below "
                         "fp64 the payload reports the fp64 refinement")
    ap.add_argument("--on-failure", choices=["recover", "warn", "ignore"],
                    default="warn")
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh (e.g. 2x1): the KE or TT variant "
                         "(or auto, narrowed to those two) on that many "
                         "local ranks through repro_torch.dist")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to start (must equal DATA x MODEL; on the "
                         "cards at most the visible ones)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    if args.mesh is None:
        if args.devices is not None:
            raise SystemExit("--devices needs --mesh DATAxMODEL")
        payload = _payload(args, dev, None)
    else:
        dims = tuple(int(x) for x in args.mesh.lower().split("x"))
        if len(dims) != 2:
            raise SystemExit(f"--mesh wants DATAxMODEL, e.g. 2x1; got "
                             f"{args.mesh!r}")
        if args.devices is not None and args.devices != dims[0] * dims[1]:
            raise SystemExit(f"--devices {args.devices} does not fill the "
                             f"{args.mesh} mesh")
        if args.variant not in ("KE", "TT", "auto"):
            raise SystemExit("--mesh is only implemented for --variant KE, "
                             "TT, or auto")
        from repro_torch.dist.launcher import run_local
        payload = run_local(_mesh_payload, dims, dev.type, args)
    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        for k, v in payload.items():
            print(f"{k}: {v}")


def _mesh_payload(mesh, args: argparse.Namespace) -> dict:
    """One rank's solve and payload (rank 0's is printed)."""
    from repro_torch.dist.mesh import mesh_device
    return _payload(args, mesh_device(mesh), mesh)


def _payload(args: argparse.Namespace, dev: torch.device, mesh) -> dict:
    prob = (md_like if args.problem == "md" else dft_like)(args.n, device=dev)
    res = solve(prob.A, prob.B, args.s, variant=args.variant,
                which=args.which, invert=args.invert, gs2=args.gs2,
                td1=args.td1, band_width=args.band_width, m=args.m,
                tol=args.tol, max_restarts=args.max_restarts,
                krylov_block=args.krylov_block,
                filter=args.filter_degree,
                # the clustered-spectrum hint: the DFT generator's low end
                clustered=(args.problem == "dft"
                           and args.which == "smallest"),
                precision=args.precision, on_failure=args.on_failure,
                max_retries=args.max_retries, device=dev, mesh=mesh)
    acc = accuracy_report(prob.A, prob.B, res.X, res.evals)
    exact = prob.exact_evals
    want = exact[:args.s] if args.which == "smallest" else exact[-args.s:]
    err = float(torch.max(torch.abs(res.evals - want)))
    payload = {
        "variant": res.info["variant"],
        "requested_variant": args.variant,
        "n": args.n, "s": args.s,
        "mesh": args.mesh or "single",
        "n_devices": (mesh.size() if mesh is not None
                      else torch.cuda.device_count() if dev.type == "cuda"
                      else 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "evals": [float(x) for x in res.evals],
        "stage_times_s": {k: round(v, 4) for k, v in res.stage_times.items()},
        "b_orthogonality": float(acc.b_orthogonality),
        "relative_residual": float(acc.relative_residual),
        "max_abs_eval_error": err,
        "n_matvec": int(res.info.get("n_matvec", 0)),
        "health": res.info["health"],
        "recovery": res.info["recovery"],
        "kernel_launches": res.info["kernel_launches"],
    }
    if "router" in res.info:
        payload["router"] = res.info["router"]
    if "warnings" in res.info:
        payload["warnings"] = res.info["warnings"]
    if "refinement" in res.info:
        rinfo = res.info["refinement"]
        payload["precision"] = args.precision
        payload["refinement"] = {
            "steps": int(rinfo["steps"]),
            "converged": bool(rinfo["converged"]),
            "relative_residual": [float(x)
                                  for x in rinfo["relative_residual"]],
            "b_orthogonality": [float(x) for x in rinfo["b_orthogonality"]],
        }
    return payload


if __name__ == "__main__":
    main()
