"""KE's restart counts at tol=0 and p=4: the port against the JAX reference
at the same start blocks, on the CPU.

At tol=0 the threshold is eps * |theta|, and a residual bound moves by a
factor ~1.5 from one restart to the next, so the count a solve stops at
follows rounding. This file asks whether the port's counts scatter over
start blocks as the reference's do, or move away from them: both
packages run the thick-restart block Lanczos (p=4, tol=0) on the same
operator, the largest end of the MD inverse pair (B, A) as KE runs it
with ``invert=True``, from the same (n, 4) start block made with numpy
from a seed. The port's product here is its plain version (the CPU).

The test keeps a small case. The table at larger sizes:

    PYTHONPATH=src python tests/test_torch_krylov_counts.py \\
        --n 1500 2500 --s 40 60 --seeds 1 2 3 4

``--ulp`` moves each start by one ulp in half its entries: how far the
counts move under a change of rounding alone.
"""
import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import lanczos as jl
from repro.core import operators as jo
from repro.core.cholesky import cholesky_upper as j_chol
from repro.core.standard_form import to_standard_two_trsm as j_gs2
from repro.data.problems import md_like
from repro_torch.core import lanczos as tl
from repro_torch.core import operators as to

P = 4
KEY = jax.random.PRNGKey(20120520)
#: the restarts two runs at the tol=0 floor may lie apart (ROADMAP.md §3,
#: "Counts at the rounding floor")
RESTART_ALLOWANCE = 2


def md_inverse_pair_operator(n: int) -> np.ndarray:
    """C of the MD inverse pair (B, A): U = chol(A), C = U^-T B U^-1."""
    prob = md_like(n)
    U = j_chol(prob.A)
    return np.array(j_gs2(prob.B, U))


def start_block(n: int, seed: int, ulp: bool = False) -> np.ndarray:
    """The (n, 4) start block of ``seed``; with ``ulp``, half its entries
    (drawn from the same seed) moved one ulp up: a start that differs only
    in rounding."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal((n, P))
    if ulp:
        up = rng.random((n, P)) < 0.5
        v0 = np.where(up, np.nextafter(v0, np.inf), v0)
    return v0


def counts(C: np.ndarray, s: int, v0: np.ndarray) -> dict:
    """n_matvec and n_restart of both packages from the same start."""
    rj = jl.lanczos_solve(jo.ExplicitC(jnp.asarray(C)), s, which="LA",
                          key=KEY, v0=jnp.asarray(v0), p=P, tol=0.0)
    rt = tl.lanczos_solve(to.ExplicitC(torch.from_numpy(C)), s, which="LA",
                          v0=torch.from_numpy(v0), p=P, tol=0.0)
    assert bool(rj.converged) and rt.converged
    evj, evt = np.asarray(rj.evals), rt.evals.numpy()
    return dict(ref_matvec=int(rj.n_matvec), ref_restart=int(rj.n_restart),
                port_matvec=int(rt.n_matvec), port_restart=int(rt.n_restart),
                eval_gap=float(np.max(np.abs(evt - evj) / np.abs(evj))))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ke_p4_counts_agree_with_reference(seed):
    n, s = 160, 6
    got = counts(md_inverse_pair_operator(n), s, start_block(n, seed))
    assert got["eval_gap"] <= 1e-12
    assert abs(got["port_restart"] - got["ref_restart"]) <= RESTART_ALLOWANCE


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1500, 2500])
    ap.add_argument("--s", type=int, nargs="+", default=[40, 60],
                    help="s for each n")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--ulp", action="store_true",
                    help="each start one ulp off in half its entries")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    print("n s seed | ref n_matvec n_restart | port n_matvec n_restart | "
          "max rel eval gap", flush=True)
    for n, s in zip(args.n, args.s):
        C = md_inverse_pair_operator(n)
        for seed in args.seeds:
            r = counts(C, s, start_block(n, seed, args.ulp))
            print(f"{n} {s} {seed} | {r['ref_matvec']} {r['ref_restart']} | "
                  f"{r['port_matvec']} {r['port_restart']} | "
                  f"{r['eval_gap']:.2e}", flush=True)


if __name__ == "__main__":
    main()
