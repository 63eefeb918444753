"""The mixed (fp32) and fast (bf16) precision levels of the PyTorch port and
their fp64 refinement, against the JAX reference, on the CPU.

The same inputs (the reference's pencils, numpy-seeded data, and the random
starts and guard block the reference draws) go through both packages:
the precision tables, ``matmul_acc``, ``refine_eigenpairs``, the Table-3
bars at all three levels (the counterpart of
``tests/test_accuracy_harness.py::test_table3_metrics_precision``), the
``escalate_precision`` rung, and each reduced plain kernel version against
the reference's Pallas kernel in interpret mode. Tolerances are stated
where they are used, with their reasons: below fp64 the two packages sum
in other orders, so results agree within the compute dtype's gamma bound,
plus one unit of the storage dtype where a result is rounded to bf16.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import accuracy_report as j_accuracy_report
from repro.core import precision as jprec
from repro.core import refinement as j_ref
from repro.core import sbr as j_sbr
from repro.core import solve as j_solve
from repro.data.problems import dft_like, md_like
from repro.kernels.house_panel.ops import house_panel as j_house_panel
from repro.kernels.rot_apply.ops import rot_apply as j_rot_apply
from repro.kernels.symv.ops import symm_block as j_symm_block
from repro.kernels.syr2k.ops import syr2k as j_syr2k
from repro_torch.core import precision as tprec
from repro_torch.core import refinement as t_ref
from repro_torch.core import solve
from repro_torch.core.band_storage import clean_band, unpack_band
from repro_torch.interop import (guard_block_from_numpy, problem_from_numpy,
                                 start_block_from_numpy)
from repro_torch.kernels.house_panel import ops as hp_ops
from repro_torch.kernels.rot_apply import ref as rot_ref
from repro_torch.kernels.rot_apply.schedule import P_LEFT, padded_band
from repro_torch.kernels.symv import ref as symv_ref
from repro_torch.kernels.syr2k import ref as syr2k_ref

N, S = 64, 6
TABLE3 = 1e-12
VARIANTS = ("TD", "TT", "KE", "KI")
DTYPES = {"mixed": torch.float32, "fast": torch.bfloat16}
J_DTYPES = {"mixed": jnp.float32, "fast": jnp.bfloat16}
#: unit roundoff of fp32 (the compute dtype of both reduced levels), and
#: of each storage dtype
U32 = 2.0 ** -24
U_STORE = {"mixed": 2.0 ** -24, "fast": 2.0 ** -8}


def _gamma(k: int, u: float = U32) -> float:
    return k * u / (1 - k * u)


def _t(x, dt=torch.float64):
    return torch.from_numpy(np.array(x, dtype=np.float64)).to(dt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float64)) if not isinstance(
        x, torch.Tensor) else x.double().numpy()


def _sym(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (M + M.T)


# ------------------------------------------------------------- the tables --

@pytest.mark.parametrize("precision", ["fp64", "mixed", "fast"])
def test_precision_tables_are_the_reference(precision):
    assert tprec.PRECISIONS == jprec.PRECISIONS
    assert (str(tprec.compute_dtype(precision)).split(".")[-1]
            == jnp.dtype(jprec.compute_dtype(precision)).name)
    assert (str(tprec.acc_dtype(precision)).split(".")[-1]
            == jnp.dtype(jprec.acc_dtype(precision)).name)
    assert tprec.compute_eps(precision) == jprec.compute_eps(precision)
    assert (tprec.declared_downcasts(precision)
            == jprec.declared_downcasts(precision))
    assert (tprec.default_refine_steps(precision)
            == jprec.default_refine_steps(precision))
    x = _t(np.ones((2, 2)))
    assert tprec.demote(x, precision).dtype == tprec.compute_dtype(precision)
    assert tprec.promote(tprec.demote(x, precision)).dtype == torch.float64


def test_tf32_products_are_refused_below_fp64(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tprec.check_fp32_matmul("fp64")
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tprec.check_fp32_matmul("mixed")
    p = md_like(16)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    with pytest.raises(RuntimeError, match="allow_tf32"):
        solve(tp.A, tp.B, 2, precision="mixed", device="cpu")


@pytest.mark.parametrize("m,k,n", [(7, 5, 3), (40, 64, 9), (128, 300, 16)])
def test_matmul_acc_bf16_vs_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    ja = jnp.asarray(a, jnp.bfloat16)
    jb = jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jprec.matmul_acc(ja, jb).astype(jnp.float32))
    got = tprec.matmul_acc(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # both sum bf16 products (exact in fp32) in fp32, in other orders, then
    # round to bf16: gamma_k(fp32) |a||b| apart before one bf16 rounding
    absprod = np.abs(np.asarray(ja, np.float64)) @ np.abs(
        np.asarray(jb, np.float64))
    bar = _gamma(k) * absprod + 2 * U_STORE["fast"] * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= bar)
    # fp32 and fp64 products are plain products
    a32 = _t(a, torch.float32)
    assert torch.equal(tprec.matmul_acc(a32, a32.mT), a32 @ a32.mT)


# ------------------------------------------------------------- refinement --

def _reference_guard(n, guard):
    return np.array(jax.random.normal(jax.random.PRNGKey(1203), (n, guard),
                                      jnp.float64))


@pytest.mark.parametrize("problem,which,noise", [("md", "smallest", 1e-6),
                                                 ("dft", "largest", 1e-4),
                                                 ("md", "largest", 1e-3)])
def test_refine_eigenpairs_vs_reference(problem, which, noise):
    """The same perturbed pairs and guard block: both packages converge
    under the Table-3 bar in trajectories no more than a step apart."""
    n, s = 96, 5
    p = (md_like if problem == "md" else dft_like)(n)
    A, B = np.asarray(p.A), np.asarray(p.B)
    # exact pairs of the pencil, then the perturbation
    L = np.linalg.cholesky(B)
    lam_all, Y = np.linalg.eigh(np.linalg.solve(L, np.linalg.solve(L, A).T))
    X_all = np.linalg.solve(L.T, Y)
    sel = slice(0, s) if which == "smallest" else slice(n - s, n)
    rng = np.random.default_rng(5)
    lam = lam_all[sel] * (1 + noise * rng.standard_normal(s))
    X = X_all[:, sel] + noise * rng.standard_normal((n, s))
    guard = t_ref.default_guard(s, n)
    assert guard == j_ref.default_guard(s, n)
    jl, jX, jinfo = j_ref.refine_eigenpairs(jnp.asarray(A), jnp.asarray(B),
                                            jnp.asarray(lam), jnp.asarray(X),
                                            which=which)
    tl, tX, tinfo = t_ref.refine_eigenpairs(
        _t(A), _t(B), _t(lam), _t(X), which=which,
        guard0=guard_block_from_numpy(_reference_guard(n, guard), "cpu"))
    assert jinfo["converged"] and tinfo["converged"]
    assert abs(tinfo["steps"] - jinfo["steps"]) <= 1
    assert set(tinfo) == set(jinfo)
    assert tinfo["guard"] == jinfo["guard"] and tinfo["tol"] == jinfo["tol"]
    assert tinfo["relative_residual"][-1] <= TABLE3
    assert tinfo["b_orthogonality"][-1] <= TABLE3
    # the input's metrics are the same numbers up to the sums' rounding
    np.testing.assert_allclose(tinfo["relative_residual"][0],
                               jinfo["relative_residual"][0], rtol=1e-9)
    scale = np.abs(lam_all).max()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-12 * scale)
    json.dumps(tinfo)


def test_refine_fixed_steps_vs_reference():
    n, s = 80, 4
    p = md_like(n)
    A, B = np.asarray(p.A), np.asarray(p.B)
    L = np.linalg.cholesky(B)
    lam_all, Y = np.linalg.eigh(np.linalg.solve(L, np.linalg.solve(L, A).T))
    X_all = np.linalg.solve(L.T, Y)
    rng = np.random.default_rng(9)
    lam = lam_all[:s] * (1 + 1e-5 * rng.standard_normal(s))
    X = X_all[:, :s] + 1e-5 * rng.standard_normal((n, s))
    jl, jX = j_ref.refine_eigenpairs_fixed(jnp.asarray(A), jnp.asarray(B),
                                           jnp.asarray(lam), jnp.asarray(X),
                                           steps=4, guard=8)
    tl, tX = t_ref.refine_eigenpairs_fixed(
        _t(A), _t(B), _t(lam), _t(X), steps=4, guard=8,
        guard0=_t(_reference_guard(n, 8)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10)
    assert torch.equal(t_ref.refine_eigenpairs_fixed(
        _t(A), _t(B), _t(lam), _t(X), steps=0)[0], _t(lam))


# ------------------------------------------------- Table 3 at all levels --

def _reference_x0(n, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(20120520), (n, s),
                                      jnp.float64))


def _reference_krylov_starts(n):
    key = jax.random.PRNGKey(20120520)
    v0 = np.array(jax.random.normal(key, (n, 1), jnp.float64))
    probe = np.array(jax.random.normal(jax.random.fold_in(key, 2), (n,),
                                       jnp.float64))
    return start_block_from_numpy(v0, "cpu"), start_block_from_numpy(probe,
                                                                     "cpu")


def _table3_both(variant, problem, precision, n):
    """The reference's Table-3 cell at (n, S) in both packages, from the
    same random starts: each meets the bars, and the eigenvalues agree
    within 1e-10 max|lambda| (both are refined to the fp64 floor)."""
    gen = md_like if problem == "md_like" else dft_like
    p = gen(n)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    invert = problem == "md_like" and variant in ("KE", "KI")
    kw = dict(variant=variant, which="smallest", band_width=8,
              max_restarts=800, invert=invert, precision=precision)
    ref = j_solve(p.A, p.B, S, **kw)
    v0, probe = _reference_krylov_starts(n)
    guard = t_ref.default_guard(S, n)
    res = solve(tp.A, tp.B, S, x0=start_block_from_numpy(_reference_x0(n, S),
                                                         "cpu"),
                v0=v0, probe_v0=probe,
                guard0=guard_block_from_numpy(_reference_guard(n, guard),
                                              "cpu"),
                device="cpu", **kw)
    acc = j_accuracy_report(p.A, p.B, jnp.asarray(res.X.numpy()),
                            jnp.asarray(res.evals.numpy()))
    assert float(acc.relative_residual) <= TABLE3
    assert float(acc.b_orthogonality) <= TABLE3
    scale = float(np.abs(np.asarray(p.exact_evals)).max())
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(ref.evals),
                               rtol=0, atol=1e-10 * scale)
    if precision == "fp64":
        assert "refinement" not in res.info and "RF" not in res.stage_times
    else:
        rinfo = res.info["refinement"]
        assert rinfo["converged"] and rinfo["tol"] <= TABLE3
        assert set(rinfo) == set(ref.info["refinement"])
        assert "RF" in res.stage_times
        json.dumps(res.info)


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fast"])
@pytest.mark.parametrize("problem", ["md_like", "dft_like"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_table3_metrics_precision(variant, problem, precision):
    """The reference's Table-3 cell at N=64, S=6 (``_table3_both``)."""
    _table3_both(variant, problem, precision, N)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
@pytest.mark.parametrize("variant", ["TT", "KE"])
def test_padded_working_copies_solve_as_the_reference(variant, precision):
    """At n=75, where a row of 75 entries is no multiple of 16 bytes, the
    reduced working copies (TT1's, the Krylov operator's) are padded: the
    solve still meets the bars and agrees with the reference as at N=64
    (``_table3_both``)."""
    _table3_both(variant, "md_like", precision, 75)


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fast"])
@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_demoted_krylov_operator_has_padded_rows(precision, kind):
    """Below fp64 the operator's product matrix (C, or A of the implicit
    operator) is a padded copy, rows on 16-byte boundaries, holding the
    cast values; U is cast as it is; fp64 keeps the operator as given."""
    from repro_torch.core import lanczos as tl
    from repro_torch.core.operators import ExplicitC, ImplicitC
    n = 75
    M = _t(_sym(n, 5))
    U = torch.triu(_t(np.random.default_rng(6).standard_normal((n, n))))
    op = ExplicitC(M) if kind == "explicit" else ImplicitC(M, U)
    dt = tprec.compute_dtype(precision)
    if precision == "fp64":
        assert tl._demoted(op, None, dt, False) == (None, 0.0)
        return
    op_c = tl.demote_op(op, dt)
    Mc = op_c[0]
    assert Mc.dtype == dt and tuple(Mc.shape) == (n, n)
    assert Mc.stride(0) * Mc.element_size() % 16 == 0
    assert Mc.stride(0) - n < 16 // Mc.element_size()
    assert Mc.data_ptr() % 16 == 0 and torch.equal(Mc, M.to(dt))
    if kind == "implicit":
        assert op_c.U.dtype == dt and op_c.U.is_contiguous()
        assert torch.equal(op_c.U, U.to(dt))


@pytest.mark.parametrize("variant,precision", [("TD", "mixed"),
                                               ("KE", "fast")])
def test_stalled_refinement_escalates_to_fp64_in_both(variant, precision):
    """An unreachable refinement tolerance stalls at the fp64 floor: both
    packages take the escalate_precision rung (the rerun at fp64 cannot
    reach it either)."""
    n = 48
    p = md_like(n)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    kw = dict(variant=variant, invert=variant == "KE", precision=precision,
              refine_tol=1e-300, on_failure="recover")
    ref = j_solve(p.A, p.B, 3, **kw)
    res = solve(tp.A, tp.B, 3, device="cpu", **kw)
    for r in (ref, res):
        rungs = [x for x in r.info["recovery"]
                 if x["action"] == "escalate_precision"]
        assert len(rungs) == 1 and rungs[0]["outcome"] == "failed"
        assert rungs[0]["params"] == {"from_precision": precision,
                                      "to_precision": "fp64"}
    assert res.info["recovery"] == ref.info["recovery"]
    assert res.info["precision"] == "fp64"


def test_demoted_solve_runs_the_reduced_instances():
    """A mixed TT solve on the CPU takes the fp32 plain versions; its
    stage inputs are fp32 and it reports RF; TD at fast reports the fp32
    plain product nowhere (TD1 is plain torch)."""
    p = md_like(N)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    res = solve(tp.A, tp.B, S, variant="TT", band_width=8,
                precision="mixed", device="cpu")
    assert res.info["tt1"]["kernel_launches"] == {"house_panel_fp32": 0,
                                                  "syr2k_fp32": 0}
    assert res.evals.dtype == torch.float64 and res.X.dtype == torch.float64
    assert res.stage_times["RF"] > 0


# ------------------------------------------- reduced plain kernel versions --

@pytest.mark.parametrize("level", ["mixed", "fast"])
@pytest.mark.parametrize("n,k", [(9, 4), (33, 16), (70, 8)])
def test_syr2k_reduced_plain_vs_pallas_interpret(level, n, k):
    """C + alpha (V W^T + W V^T) with the reference's kernel in interpret
    mode (fp32 accumulation, rounded to the storage dtype at the store):
    within gamma_(2k+1)(fp32) (|C| + |V||W|^T + |W||V|^T) before that
    rounding, plus one unit of the storage dtype."""
    rng = np.random.default_rng(n * k)
    C, V, W = _sym(n, n + k), rng.standard_normal((n, k)), \
        rng.standard_normal((n, k))
    jdt, dt = J_DTYPES[level], DTYPES[level]
    want = np.asarray(j_syr2k(jnp.asarray(C, jdt), jnp.asarray(V, jdt),
                              jnp.asarray(W, jdt), alpha=-1.0,
                              force_interpret=True).astype(jnp.float32))
    Cs, Vs, Ws = _t(C, dt), _t(V, dt), _t(W, dt)
    got = syr2k_ref.syr2k_reduced_ref(Cs, Vs, Ws, -1.0)
    assert got.dtype == dt
    Cd, Vd, Wd = (x.double().numpy() for x in (Cs, Vs, Ws))
    mag = np.abs(Cd) + np.abs(Vd) @ np.abs(Wd).T + np.abs(Wd) @ np.abs(Vd).T
    bar = _gamma(2 * k + 1) * mag + U_STORE[level] * 2 * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= bar)
    # the symmetrized form is the average of the stored result and its
    # transpose, rounded again
    sym = syr2k_ref.syr2k_reduced_ref(Cs, Vs, Ws, -1.0, symmetrize=True)
    assert torch.equal(sym, (0.5 * (got.float() + got.float().mT)).to(dt))


@pytest.mark.parametrize("level", ["mixed", "fast"])
@pytest.mark.parametrize("rows,b,row_start", [(24, 4, 3), (61, 8, 8),
                                              (100, 16, 16)])
def test_house_panel_reduced_plain_vs_pallas_interpret(level, rows, b,
                                                       row_start):
    """(V, T) of a panel stored in fp32 or bf16, both factored in fp32: V
    (|v| <= 1) and T within 4 b gamma_rows(fp32) max(1, |x|) (b dependent
    reflectors, each from sums over the rows), plus two units of the
    storage dtype (both round to bf16 at the store)."""
    E = np.random.default_rng(rows + b).standard_normal((rows, b))
    jdt, dt = J_DTYPES[level], DTYPES[level]
    jV, jT = j_house_panel(jnp.asarray(E, jdt), row_start, force_kernel=True,
                           force_interpret=True)
    V, T = hp_ops.house_panel(_t(E, dt), row_start)
    assert V.dtype == dt and T.dtype == dt
    for got, want in ((V, jV), (T, jT)):
        want = np.asarray(want.astype(jnp.float32), np.float64)
        scale = np.maximum(1.0, np.abs(want))
        bar = (4 * b * _gamma(rows) + 2 * U_STORE[level]) * scale
        assert np.all(np.abs(got.double().numpy() - want) <= bar)


@pytest.mark.parametrize("level", ["mixed", "fast"])
@pytest.mark.parametrize("G,L", [(1, 1), (13, 5), (40, 130)])
def test_rot_apply_reduced_plain_vs_pallas_interpret(level, G, L):
    """Rotations computed in fp32 and rounded at the store, as the
    reference's kernel does; the interpreted kernel may fuse a product into
    the sum, so within 4 u(fp32) (|x0| + |x1|) plus one unit of the storage
    dtype."""
    rng = np.random.default_rng(G * L)
    pairs = rng.standard_normal((G, 2, L))
    th = rng.uniform(0, 2 * np.pi, G)
    cs = np.stack([np.cos(th), np.sin(th)], 1)
    jdt, dt = J_DTYPES[level], DTYPES[level]
    want = np.asarray(j_rot_apply(jnp.asarray(pairs, jdt), jnp.asarray(cs, jdt),
                                  force_kernel=True, force_interpret=True)
                      .astype(jnp.float32), np.float64)
    got = rot_ref.rot_apply_ref(_t(pairs, dt), _t(cs, dt))
    assert got.dtype == dt
    mag = np.abs(np.asarray(jnp.asarray(pairs, jdt), np.float64)).sum(axis=1,
                                                                     keepdims=True)
    assert np.all(np.abs(got.double().numpy() - want)
                  <= 2 * U_STORE[level] * np.abs(want) + 4 * U32 * mag)


def _band(n, w, seed):
    p = md_like(n)
    from repro.core.cholesky import cholesky_upper
    from repro.core.standard_form import to_standard_two_trsm
    C = to_standard_two_trsm(p.A, cholesky_upper(p.B))
    return np.asarray(j_sbr.reduce_to_band(C, w=w).Wb), np.asarray(C)


@pytest.mark.parametrize("level", ["mixed", "fast"])
@pytest.mark.parametrize("n,w", [(40, 4), (72, 8)])
def test_chase_and_replay_reduced_vs_reference(level, n, w):
    """The whole TT2 chase and the TT4 replay in fp32 or bf16. The chase:
    the port's plain version (the CUDA chase's rounding points) gives a
    tridiagonal whose eigenvalues are within 3 sqrt(w) u_store ||W||_2 of
    those of the reference's bf16/fp32 wavefront's tridiagonal and of the
    rounded band it chased (their rotations round at other points, so they
    agree to that order, not bitwise). Readings, in u_store ||W||_2 at
    (40, 4) and (72, 8): port - reference 1.75, 2.85 (fp32) and 3.43, 2.44
    (bf16); port - band 1.76, 2.12 and 1.50, 1.02; a chase stopped after
    its first pass reads 65 to 80 (bf16) and 4e6 (fp32). The replay:
    the reference's stream through the port's plain replay is the
    reference's apply_q2 within (4 u(fp32) + 2 u_store) max(1, |y|) a
    pass (the same rounding points; the reference may fuse products)."""
    Wb, C = _band(n, w, n)
    jdt, dt = J_DTYPES[level], DTYPES[level]
    exact = np.linalg.eigvalsh(C)
    norm = np.abs(exact).max()
    Wr = clean_band(_t(Wb, dt))
    band_ev = np.linalg.eigvalsh(unpack_band(Wr.double()).numpy())
    Wp = padded_band(Wr, w)
    tables = [rot_ref.chase_pass_lanes_ref(Wp, b, w, n)
              for b in j_sbr._executed_passes(n, w)]
    d, e = Wp[0, P_LEFT:P_LEFT + n], Wp[1, P_LEFT:P_LEFT + n - 1]
    jch = j_sbr.band_chase(jnp.asarray(Wb, jdt), w)
    ev, ev_ref = (np.linalg.eigvalsh(np.diag(dd) + np.diag(ee, 1)
                                     + np.diag(ee, -1))
                  for dd, ee in ((d.double().numpy(), e.double().numpy()),
                                 (_np(jch.d), _np(jch.e))))
    bar = 3 * np.sqrt(w) * U_STORE[level] * norm
    assert np.abs(ev - ev_ref).max() <= bar
    assert np.abs(ev - band_ev).max() <= bar
    assert all(t.dtype == dt for t in tables)
    # the replay of the reference's stream onto a slab
    Z = np.random.default_rng(n).standard_normal((n, 5))
    want = np.asarray(j_sbr.apply_q2(jch, jnp.asarray(Z, jdt), w)
                      .astype(jnp.float32), np.float64)
    Y = _t(Z, dt).clone()
    passes = j_sbr._executed_passes(n, w)
    for b, CS in zip(reversed(passes), reversed(jch.cs)):
        rot_ref.replay_pass_ref(Y, torch.from_numpy(
            np.array(CS.astype(jnp.float32))).to(dt), b, n, True)
    assert np.all(np.abs(Y.double().numpy() - want)
                  <= len(passes) * (4 * U32 + 2 * U_STORE[level])
                  * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("level", ["mixed", "fast"])
@pytest.mark.parametrize("n,p", [(9, 1), (70, 2), (130, 4), (100, 5)])
def test_symm_block_reduced_plain_vs_pallas_interpret(level, n, p):
    """Y = A X from the upper triangle, fp32 sums: within
    gamma_n(fp32) |sym(triu A)| |X| plus one unit of the storage dtype."""
    rng = np.random.default_rng(n + p)
    A = _sym(n, n) + np.tril(rng.standard_normal((n, n)) * 1e3, -1)
    X = rng.standard_normal((n, p))
    jdt, dt = J_DTYPES[level], DTYPES[level]
    want = np.asarray(j_symm_block(jnp.asarray(A, jdt), jnp.asarray(X, jdt),
                                   force_interpret=True).astype(jnp.float32),
                      np.float64)
    got = symv_ref.symm_block_upper_ref(_t(A, dt), _t(X, dt))
    assert got.dtype == dt
    Ad = np.asarray(jnp.asarray(A, jdt), np.float64)
    Xd = np.asarray(jnp.asarray(X, jdt), np.float64)
    mag = (np.abs(np.triu(Ad)) + np.abs(np.triu(Ad, 1)).T) @ np.abs(Xd)
    bar = 2 * _gamma(n) * mag + 2 * U_STORE[level] * np.abs(want)
    assert np.all(np.abs(got.double().numpy() - want) <= bar)
    v = symv_ref.symv_upper_ref(_t(A, dt), _t(X[:, 0], dt))
    assert torch.equal(v, got[:, 0]) if p == 1 else v.dtype == dt


def test_cli_precision_payload(monkeypatch):
    """``--precision mixed`` solves and reports the refinement block, as
    the reference's CLI does."""
    import io
    import sys
    from contextlib import redirect_stdout
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", [
        "eigsolve", "--problem", "md", "--n", "40", "--s", "3", "--variant",
        "TT", "--precision", "mixed", "--device", "cpu", "--json"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["precision"] == "mixed"
    ref = payload["refinement"]
    assert ref["converged"] and ref["steps"] == len(
        ref["relative_residual"]) - 1
    assert ref["relative_residual"][-1] <= TABLE3
    assert payload["relative_residual"] <= TABLE3
    assert payload["stage_times_s"]["RF"] > 0
    assert payload["kernel_launches"]["house_panel_fp32"] == 0
