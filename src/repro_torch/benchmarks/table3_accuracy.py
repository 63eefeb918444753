"""Paper Table 3: accuracy (B-orthogonality and relative residual) of the
four solvers, in the port:

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_accuracy \\
        [--full] [--precision mixed] [--device cpu]

It prints the lines of ``benchmarks/table3_accuracy.py``:
``table3_<problem>_<variant>,0.0,orth=..;resid=..;eval_relerr=..``, the
metrics as the paper defines them on the original pencil (after the fp64
refinement of a demoted solve), and the largest relative eigenvalue error
against the generator's exact spectrum. Solves already run by Table 2 in
the same process are reused.
"""
from __future__ import annotations

import torch

from repro_torch.core.residuals import b_orthogonality, relative_residual

from .common import BAND_W, parser, solve_cached
from .table2_stage_timings import specs


def main(args) -> list[str]:
    out = []
    for name, prob, s, invert, m, mr in specs(args):
        out.append(f"# table3 {name}: n={prob.A.shape[0]} s={s} "
                   f"(precision={args.precision})")
        for variant in ("TD", "TT", "KE", "KI"):
            res = solve_cached(name, prob, s, variant,
                               invert=invert and variant in ("KE", "KI"),
                               band_width=BAND_W, max_restarts=mr, m=m,
                               precision=args.precision,
                               device=prob.A.device)
            orth = float(b_orthogonality(res.X, prob.B))
            resid = float(relative_residual(prob.A, prob.B, res.X,
                                            res.evals))
            exact = prob.exact_evals[:s]
            err = float(torch.max(torch.abs(res.evals - exact)
                                  / torch.abs(exact)))
            out.append(f"table3_{name}_{variant},0.0,"
                       f"orth={orth:.3e};resid={resid:.3e};"
                       f"eval_relerr={err:.3e}")
    return out


if __name__ == "__main__":
    for line in main(parser(__doc__.splitlines()[0]).parse_args()):
        print(line)
