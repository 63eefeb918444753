"""KE's Lanczos counts at tol=0 under each symmetric product, over several
MD sizes, block sizes and start blocks.

At tol=0 the restart count follows the product's rounding, so one solve
says little about a product; this prints one line per (n, p, start,
product) and a table of n_matvec, n_restart and KE_iter, with each
solve's eigenvalue error against the exact spectrum.

  PYTHONPATH=src python -m repro_torch.launch.krylov_counts \\
      --n 9997 8000 --p 1 4 --starts default 1 2 --products kernel matmul

Products: ``kernel`` (the one-triangle kernel, one launch a block),
``columns`` (the same kernel on one column at a time, so its p=1 form;
p > 1 only) and ``matmul`` (``torch.matmul`` on the full matrix).
``--device cpu`` runs the kernel's plain version.
``default`` is the solve's own start (``SOLVE_SEED``); an integer seeds a
generator on the device. To count with another tree's package, run this
file with that tree's ``src`` first on PYTHONPATH:
``PYTHONPATH=<tree>/src python src/repro_torch/launch/krylov_counts.py``.
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

from repro_torch.core import solve
from repro_torch.data.problems import md_like
from repro_torch.device import resolve_device
from repro_torch.kernels.symv import ops as symv_ops


@contextlib.contextmanager
def _one_column_at_a_time():
    """The kernel's block product taken a column at a time."""
    block = symv_ops.symm_block

    def columns(A, X):
        return torch.cat([block(A, X[:, k:k + 1]) for k in range(X.shape[1])],
                         dim=1)

    symv_ops.symm_block = columns
    try:
        yield
    finally:
        symv_ops.symm_block = block


def _solve(prob, s: int, p: int, start: str, product: str) -> dict:
    gen = None
    if start != "default":
        gen = torch.Generator(device=prob.A.device).manual_seed(int(start))
    ctx = (_one_column_at_a_time() if product == "columns"
           else contextlib.nullcontext())
    with ctx:
        res = solve(prob.A, prob.B, s, variant="KE", invert=True,
                    use_kernel=product != "matmul", krylov_block=p,
                    generator=gen, device=prob.A.device)
    if prob.A.is_cuda:
        torch.cuda.synchronize()
    exact = prob.exact_evals[:s]
    return dict(n=prob.A.shape[0], p=p, start=start, product=product,
                n_matvec=res.info["n_matvec"], n_restart=res.info["n_restart"],
                converged=bool(res.info["converged"]),
                KE_iter_s=res.stage_times["KE_iter"],
                eval_err=float(torch.max(torch.abs(res.evals - exact))),
                max_abs_eval=float(torch.max(torch.abs(prob.exact_evals))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[9997])
    ap.add_argument("--s", type=int, default=100)
    ap.add_argument("--p", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--starts", nargs="+", default=["default", "1", "2"])
    ap.add_argument("--products", nargs="+", default=["kernel", "matmul"],
                    choices=["kernel", "columns", "matmul"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernel's plain "
                         "version)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    rows = []
    for n in args.n:
        prob = md_like(n, device=dev)
        for p in args.p:
            for start in args.starts:
                for product in args.products:
                    if product == "columns" and p == 1:
                        continue
                    row = _solve(prob, args.s, p, start, product)
                    print(json.dumps(row), flush=True)
                    rows.append(row)
        del prob
    print("n p start: n_matvec / n_restart / KE_iter s by product")
    keys = sorted({(r["n"], r["p"], r["start"]) for r in rows},
                  key=lambda k: (k[0], k[1], k[2] != "default", k[2]))
    for key in keys:
        cells = [f"{r['product']} {r['n_matvec']} / {r['n_restart']} / "
                 f"{r['KE_iter_s']:.4f}" for r in rows
                 if (r["n"], r["p"], r["start"]) == key]
        print(f"{key[0]} {key[1]} {key[2]}: " + ", ".join(cells))


if __name__ == "__main__":
    main()
