"""Paper Table 2: per-stage time of the four GSYEIG solvers on the MD-like
and DFT-like problems, in the port:

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_stage_timings \\
        [--full] [--precision mixed] [--device cpu]

It prints the lines of ``benchmarks/table2_stage_timings.py``: a stage
table per problem (seconds; RF where a demoted solve refines), the Krylov
counts, and ``table2_<problem>_<variant>_total,<us>,orth=..;resid=..``.
Every variant but TT is timed on a second, warm run; the solves are
cached for Table 3.
"""
from __future__ import annotations

from repro_torch.core.residuals import accuracy_report

from .common import (BAND_W, dft_problem, md_problem, parser, sizes,
                     solve_cached)

STAGE_KEYS = ["GS1", "GS2", "TD1", "TD2", "TD3", "TT1", "TT2", "TT3", "TT4",
              "KE_iter", "KI_iter", "BT1", "RF", "Tot."]


def specs(args):
    """(name, problem, s, KE/KI invert, m, max_restarts) per experiment: m
    tuned per experiment as the paper did; the clustered DFT end needs a
    subspace covering the cluster."""
    sz = sizes(args)
    (md_n, md_s), (dft_n, dft_s) = sz["md"], sz["dft"]
    restarts = 300 if args.full else None
    return [("md", md_problem(md_n, args.device), md_s, True, None,
             restarts or 120),
            ("dft", dft_problem(dft_n, args.device), dft_s, False,
             sz["dft_m"], restarts or 200)]


def run_experiment(prob, s: int, invert: bool, m, max_restarts: int,
                   tag: str, precision: str):
    from repro_torch.core import solve
    rows, info = {}, {}
    for variant in ("TD", "TT", "KE", "KI"):
        kw = dict(invert=invert and variant in ("KE", "KI"),
                  band_width=BAND_W, max_restarts=max_restarts, m=m,
                  precision=precision, device=prob.A.device)
        if variant != "TT":
            # a first run pays the kernels' build and the caches; the
            # cached second run is the one timed (and Table 3's)
            solve(prob.A, prob.B, s, variant=variant, **kw)
        res = solve_cached(tag, prob, s, variant, **kw)
        rows[variant] = res.stage_times
        acc = accuracy_report(prob.A, prob.B, res.X, res.evals)
        info[variant] = dict(res.info, orth=float(acc.b_orthogonality),
                             resid=float(acc.relative_residual))
    return rows, info


def main(args) -> list[str]:
    out = []
    for name, prob, s, invert, m, mr in specs(args):
        rows, info = run_experiment(prob, s, invert, m, mr, name,
                                    args.precision)
        n = prob.A.shape[0]
        out.append(f"# table2 {name}: n={n} s={s} "
                   f"(KE/KI inverse-trick={invert}, precision="
                   f"{args.precision}, device={prob.A.device})")
        out.append("stage," + ",".join(rows.keys()))
        for key in STAGE_KEYS:
            vals = [f"{rows[v][key]:.3f}" if key in rows[v] else "-"
                    for v in rows]
            if any(v != "-" for v in vals):
                out.append(f"{key}," + ",".join(vals))
        for v, i in info.items():
            if "n_matvec" in i:
                out.append(f"# {name}/{v}: matvecs={i['n_matvec']} "
                           f"restarts={i['n_restart']} "
                           f"converged={i['converged']}")
        for v in rows:
            out.append(f"table2_{name}_{v}_total,"
                       f"{rows[v]['Tot.'] * 1e6:.1f},"
                       f"orth={info[v]['orth']:.2e};"
                       f"resid={info[v]['resid']:.2e}")
    return out


if __name__ == "__main__":
    for line in main(parser(__doc__.splitlines()[0]).parse_args()):
        print(line)
