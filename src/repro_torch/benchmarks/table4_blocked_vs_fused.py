"""Paper Table 4: the fused library factorizations against the blocked
algorithms for GS1 and GS2, in the port:

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_blocked_vs_fused \\
        [--full] [--device cpu]

It prints the lines of ``benchmarks/table4_blocked_vs_fused.py``
(``table4_<problem>_GS1_fused,<us>,n=..`` and so on): GS1 as the fused
Cholesky and the blocked one at block 128 (the ``gemm`` and ``trsm``
kernels on the card), GS2 as the two triangular solves (2 n^3) and the
blocked DSYGST (n^3), each the median of three warm calls. GS1 and GS2
stay fp64 at every precision, so this table has no ``--precision``.
"""
from __future__ import annotations

from repro_torch.core import (cholesky_blocked, cholesky_upper,
                              to_standard_sygst, to_standard_two_trsm)

from .common import dft_problem, md_problem, parser, sizes, time_call


def main(args) -> list[str]:
    out = []
    sz = sizes(args)
    for name, prob in (("md", md_problem(sz["md"][0], args.device)),
                       ("dft", dft_problem(sz["dft"][0], args.device))):
        n = prob.A.shape[0]
        dev = prob.A.device
        out.append(f"# table4 {name}: n={n} (device={dev})")
        t, U = time_call(cholesky_upper, prob.B, device=dev)
        out.append(f"table4_{name}_GS1_fused,{t * 1e6:.1f},n={n}")
        t, _ = time_call(cholesky_blocked, prob.B, block=128, device=dev)
        out.append(f"table4_{name}_GS1_blocked128,{t * 1e6:.1f},n={n}")
        t, _ = time_call(to_standard_two_trsm, prob.A, U, device=dev)
        out.append(f"table4_{name}_GS2_two_trsm,{t * 1e6:.1f},flops=2n^3")
        t, _ = time_call(to_standard_sygst, prob.A, U, block=128, device=dev)
        out.append(f"table4_{name}_GS2_sygst,{t * 1e6:.1f},flops=n^3")
    return out


if __name__ == "__main__":
    ap = parser(__doc__.splitlines()[0], precision=False)
    for line in main(ap.parse_args()):
        print(line)
