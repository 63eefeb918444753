"""CLI for the port's eigensolver serving engine: synthetic md/dft request
streams through shape-bucketed continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.eigenserve \\
        --slots 4 --bucket-shapes 48,64 --requests 12 --stream mixed

Each request is one ``(A, B, s)`` pencil drawn from the paper's two
workload generators (``data.problems.md_like`` / ``dft_like``) at one of
the bucket shapes — the MD-timestep / DFT-SCF-iteration serving pattern.
``--oversize-every K`` injects an oversized pencil every K requests to
exercise the ``variant='auto'`` router fallback path. Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given. The
reference's ``--mesh``/``--devices`` are kept and raise: the mesh path is
not ported yet (ROADMAP.md §1 item 12c; ``launch/eigsolve.py --mesh``
runs one distributed solve).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.data.problems import dft_like, md_like
from repro_torch.device import resolve_device, synchronize
from repro_torch.serve.eigen_engine import EigenEngine, _mesh_not_ported


def request_stream(kinds, shapes, n_requests: int, seed: int,
                   oversize_every: int, oversize_n: int, device=None):
    """Yield (problem, workload, invert) tuples round-robin over
    (workload, shape); every ``oversize_every``-th request is an oversized
    pencil destined for the router path."""
    gens = {"md": md_like, "dft": dft_like}
    for i in range(n_requests):
        kind = kinds[i % len(kinds)]
        oversized = oversize_every and (i + 1) % oversize_every == 0
        n = oversize_n if oversized else shapes[(i // len(kinds)) % len(shapes)]
        prob = gens[kind](n, seed=seed * 100_003 + i, device=device)
        # the paper's MD trick: Krylov service of the MD smallest end works
        # on the inverse pair (md_like's A is SPD)
        yield prob, kind, kind == "md"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=4,
                    help="seats per shape bucket (batched dispatch size)")
    ap.add_argument("--bucket-shapes", default="48,64",
                    help="comma-separated admissible n values")
    ap.add_argument("--stream", choices=["md", "dft", "mixed"],
                    default="mixed")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--s", type=int, default=4)
    ap.add_argument("--variant", choices=["TD", "TT", "KE", "KI"],
                    default="TD")
    ap.add_argument("--band-width", type=int, default=8)
    ap.add_argument("--max-restarts", type=int, default=200)
    ap.add_argument("--max-batched-n", type=int, default=256)
    ap.add_argument("--oversize-every", type=int, default=0,
                    help="inject an oversized (router-path) request every "
                         "K submissions (0 = never)")
    ap.add_argument("--oversize-n", type=int, default=320)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh for the router fallback path "
                         "(not ported yet: raises)")
    ap.add_argument("--devices", type=int, default=None,
                    help="device count of the mesh (not ported yet: "
                         "raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--on-failure", choices=["recover", "warn", "ignore"],
                    default="recover",
                    help="per-lane failure policy: 'recover' quarantines "
                         "unhealthy/unconverged lanes and retries them up "
                         "the degradation ladder, dead-lettering what "
                         "cannot be saved")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="individual retries per quarantined lane before "
                         "it is dead-lettered")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--json", action="store_true")
    return ap


def serve(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the stream of ``args`` through one engine and return the
    payload; asserts that every request retired and that every retired
    pencil is on the generator's spectrum."""
    if args.mesh or args.devices:
        raise _mesh_not_ported()
    dev = resolve_device(args.device)
    shapes = [int(x) for x in args.bucket_shapes.split(",") if x]
    kinds = ["md", "dft"] if args.stream == "mixed" else [args.stream]
    engine = EigenEngine(slots=args.slots, bucket_shapes=shapes,
                         variant=args.variant,
                         max_batched_n=args.max_batched_n,
                         band_width=args.band_width,
                         max_restarts=args.max_restarts,
                         on_failure=args.on_failure,
                         max_retries=args.max_retries, device=dev)

    stream = list(request_stream(kinds, shapes, args.requests, args.seed,
                                 args.oversize_every, args.oversize_n,
                                 device=dev))
    # the pencils are made before the clock starts, as the reference's are
    synchronize(dev)
    t0 = time.perf_counter()
    exact = {}
    for prob, kind, invert in stream:
        # Krylov variants use the inverse-pair trick on MD; direct variants
        # solve the pencil as-is
        inv = invert and args.variant in ("KE", "KI")
        uid = engine.submit(prob.A, prob.B, args.s, invert=inv)
        exact[uid] = prob.exact_evals[:args.s]
        engine.tick()          # continuous service: dispatch full buckets
    done = engine.run_until_drained(flush=True)
    wall = time.perf_counter() - t0
    del stream
    # the no-silent-drop invariant: every submission retires somewhere
    assert len(done) + len(engine.dead_letters) == args.requests

    # verify every retirement against the generator's known spectrum
    max_err = 0.0
    for req in done:
        ref = exact[req.uid].cpu().numpy()
        max_err = max(max_err, float(np.max(np.abs(req.evals - ref))))

    payload = {
        "requests": args.requests,
        "slots": args.slots,
        "bucket_shapes": shapes,
        "stream": args.stream,
        "variant": args.variant,
        "device": str(dev),
        "wall_s": round(wall, 4),
        "requests_per_s": round(args.requests / max(wall, 1e-12), 2),
        "max_abs_eval_error": max_err,
        "summary": engine.summary(),
    }
    return payload


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    payload = serve(args)
    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        for k, v in payload.items():
            print(f"{k}: {v}")
    max_err = payload["max_abs_eval_error"]
    assert max_err < 1e-6, f"serving accuracy regression: {max_err}"
    print("eigenserve OK")


if __name__ == "__main__":
    main()
