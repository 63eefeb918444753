"""The Krylov core of the PyTorch port against the JAX reference, on the CPU.

Operators, the restart schedule, the Chebyshev filter and the whole
thick-restart block Lanczos get the same inputs in both packages: matrices
and start blocks made with numpy from a seed, and the filter probe vector
the reference draws (``normal(fold_in(key, 2), (n,))``), handed to the
port. Ritz values agree within 1e-12 relative, and the matvec and restart
counts are equal — or, where the threshold eps * |theta| is crossed
within rounding, differ by a restart or two, which the tests show is the
cause: at that floor a residual bound moves by a factor ~1.5 from one
restart to the next in either package.
Ritz vectors are compared after fixing each column's sign; the stored
basis is never compared elementwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import filtering as jf
from repro.core import lanczos as jl
from repro.core import operators as jo
from repro.core.cholesky import cholesky_upper as j_chol
from repro.core.standard_form import to_standard_two_trsm as j_gs2
from repro.data.problems import dft_like, md_like
from repro_torch.core import filtering as tf
from repro_torch.core import lanczos as tl
from repro_torch.core import operators as to

EPS = np.finfo(np.float64).eps
KEY = jax.random.PRNGKey(20120520)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _spectrum_matrix(n, seed):
    """Q diag(lam) Q^T with lam = linspace(-1, 1)^3: both ends separated."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-1.0, 1.0, n) ** 3
    C = (Q * lam) @ Q.T
    return 0.5 * (C + C.T)


def _standard_form(gen, n):
    p = gen(n)
    U = j_chol(p.B)
    return np.array(p.A), np.array(p.B), np.array(U), np.array(j_gs2(p.A, U))


def _probe(n):
    return np.array(jax.random.normal(jax.random.fold_in(KEY, 2), (n,),
                                      jnp.float64))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


# ------------------------------------------------------------- operators --

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_apply_op_vs_reference(kind, block, use_kernel):
    A, B, U, C = _standard_form(md_like, 40)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 3) if block else (40,))
    if kind == "explicit":
        jop, top = jo.ExplicitC(jnp.asarray(C)), to.ExplicitC(_t(C))
    else:
        jop = jo.ImplicitC(jnp.asarray(A), jnp.asarray(U))
        top = to.ImplicitC(_t(A), _t(U))
    y = to.apply_op(top, _t(w), use_kernel=use_kernel)
    _close(y.numpy(), jo.apply_op(jop, jnp.asarray(w), use_kernel=use_kernel))
    assert to.op_dim(top) == jo.op_dim(jop) == 40
    assert to.matvecs_per_apply(top) == jo.matvecs_per_apply(jop)


def test_implicit_operator_reads_only_the_upper_triangle_of_u():
    A, B, U, C = _standard_form(md_like, 30)
    Ug = U + np.tril(np.full_like(U, 1e6), -1)
    w = _t(np.random.default_rng(1).standard_normal((30, 2)))
    assert torch.equal(to.apply_op(to.ImplicitC(_t(A), _t(U)), w),
                       to.apply_op(to.ImplicitC(_t(A), _t(Ug)), w))
    _close(to.apply_op(to.ImplicitC(_t(A), _t(U)), w).numpy(), C @ w.numpy())


# ------------------------------------------------------ restart schedule --

@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_default_subspace_and_schedule_match_reference(p):
    for n in (30, 64, 100, 500, 9997, 17243):
        for s in (1, 2, 4, 8, 20, 50, 100, 448):
            if 2 * s + 1 >= n:
                continue
            m = tl.default_subspace(s, n, p)
            assert m == jl.default_subspace(s, n, p), (s, n, p)
            assert tl.restart_schedule(s, m, p) == jl.restart_schedule(s, m, p)


def test_qr_posdiag_vs_reference():
    W = np.random.default_rng(4).standard_normal((50, 4))
    Q, R = tl._qr_posdiag(_t(W))
    Qj, Rj = jl._qr_posdiag(jnp.asarray(W))
    assert bool(torch.all(torch.diagonal(R) >= 0))
    _close(Q.numpy(), Qj)
    _close(R.numpy(), Rj)


# --------------------------------------------------------------- filter --

def test_probe_steps_match_reference():
    for s in (1, 4, 6, 20, 100):
        for n in (10, 64, 1000):
            assert tf.probe_steps(s, n) == jf.probe_steps(s, n)


@pytest.mark.parametrize("which", ["SA", "LA"])
@pytest.mark.parametrize("gen", ["dft", "spectrum"])
def test_bounds_interval_and_filter_vs_reference(gen, which):
    n, s, degree = 64, 4, 16
    C = (_standard_form(dft_like, n)[3] if gen == "dft"
         else _spectrum_matrix(n, 5))
    v = _probe(n)
    kb = tf.probe_steps(s, n)
    jmv = lambda X: jnp.asarray(C) @ X  # noqa: E731
    tmv = lambda X: _t(C) @ X           # noqa: E731
    theta, beta = tf.estimate_bounds(tmv, _t(v), kb)
    theta_j, beta_j = jf.estimate_bounds(jmv, jnp.asarray(v), kb)
    _close(theta.numpy(), theta_j)
    _close(beta.numpy(), beta_j)
    a, b, a0 = tf.filter_interval(theta, beta, s, which)
    aj, bj, a0j = jf.filter_interval(theta_j, beta_j, s, which)
    for x, y in ((a, aj), (b, bj), (a0, a0j)):
        _close(x.numpy(), y)
    X = np.random.default_rng(6).standard_normal((n, 3))
    Y = tf.chebyshev_filter(tmv, _t(X), degree, a, b, a0)
    Yj = jf.chebyshev_filter(jmv, jnp.asarray(X), degree, aj, bj, a0j)
    _close(Y.numpy(), Yj)


def test_filter_guards_a_normalization_point_inside_the_window():
    # a0 at the centre of [a, b]: the reference's d0 guard moves it off
    C = _spectrum_matrix(20, 2)
    X = np.random.default_rng(7).standard_normal((20, 2))
    args = (0.5, 0.5 + 1e-3, 0.5 + 5e-4)
    Y = tf.chebyshev_filter(lambda Z: _t(C) @ Z, _t(X), 3,
                            *(torch.tensor(v, dtype=torch.float64)
                              for v in args))
    Yj = jf.chebyshev_filter(lambda Z: jnp.asarray(C) @ Z, jnp.asarray(X), 3,
                             *(jnp.asarray(v) for v in args))
    assert np.isfinite(Y.numpy()).all()
    _close(Y.numpy(), Yj, tol=1e-10)


# ---------------------------------------------------------- the solver --

def _ratios(res):
    """resid_bound / threshold per wanted pair (tol = 0): <= 1 converged."""
    th = np.asarray(res.evals)
    return np.asarray(res.resid_bounds) / (EPS * np.maximum(np.abs(th),
                                                            EPS ** (2 / 3)))


def _run_both(C, s, which, p, fd, max_restarts=500, v0=None):
    n = C.shape[0]
    if v0 is None:
        v0 = np.random.default_rng(n + p).standard_normal((n, p))
    rj = jl.lanczos_solve(jo.ExplicitC(jnp.asarray(C)), s, which=which,
                          key=KEY, v0=jnp.asarray(v0), p=p, filter_degree=fd,
                          max_restarts=max_restarts)
    rt = tl.lanczos_solve(to.ExplicitC(_t(C)), s, which=which, v0=_t(v0),
                          probe_v0=_t(_probe(n)), p=p, filter_degree=fd,
                          max_restarts=max_restarts)
    return rj, rt


def _check_parity(C, s, which, p, fd, v0=None):
    rj, rt = _run_both(C, s, which, p, fd, v0=v0)
    assert rj.converged and rt.converged and rt.healthy
    ev, evj = rt.evals.numpy(), np.asarray(rj.evals)
    assert np.abs((ev - evj) / evj).max() <= 1e-12
    V, Vj = rt.evecs.numpy(), np.asarray(rj.evecs)
    assert np.abs(np.abs(np.sum(V * Vj, 0)) - 1.0).max() <= 1e-10
    k0, k1 = sorted((rt.n_restart, rj.n_restart))
    if k0 != k1:
        # the run that stopped first was near its threshold, and at every
        # restart until it stopped too, the other run sat on its threshold
        # within rounding
        assert k1 - k0 <= 2
        first_t = rt.n_restart == k0
        stopped = _run_both(C, s, which, p, fd, max_restarts=k0,
                            v0=v0)[1 if first_t else 0]
        assert stopped.converged and 0.25 <= _ratios(stopped).max() <= 1.0
        for k in range(k0, k1):
            going_on = _run_both(C, s, which, p, fd, max_restarts=k,
                                 v0=v0)[0 if first_t else 1]
            assert not going_on.converged
            assert 1.0 < _ratios(going_on).max() <= 2.0
    m = tl.default_subspace(s, C.shape[0], p)
    per_restart = tl.restart_schedule(s, m, p)[1]
    assert abs(rt.n_matvec - rj.n_matvec) == (k1 - k0) * per_restart
    return rj, rt


@pytest.mark.parametrize("fd", [0, 16])
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("which", ["SA", "LA"])
def test_lanczos_solve_vs_reference(which, p, fd):
    _check_parity(_spectrum_matrix(120, 8), 5, which, p, fd)


@pytest.mark.parametrize("p", [1, 4])
def test_lanczos_solve_vs_reference_md_inverse_pair(p):
    # the largest end of the MD inverse pair (B, A), as KE runs it with
    # invert=True (its smallest end is the clustered one)
    A, B, _, _ = _standard_form(md_like, 96)
    U = np.array(j_chol(jnp.asarray(A)))
    C = np.array(j_gs2(jnp.asarray(B), jnp.asarray(U)))
    _check_parity(C, 4, "LA", p, 0)


def test_one_restart_apart_at_the_threshold_dft_largest():
    """The DFT pencil's largest end: the reference converges at restart 8,
    the port at 9, because at restart 8 the fourth Ritz pair sits on the
    eps * |theta| threshold (the reference's ratio ~0.88, the port's
    ~1.04) — rounding, not a difference of method."""
    C = _standard_form(dft_like, 64)[3]
    v0 = np.array(jax.random.normal(KEY, (64, 1), jnp.float64))
    rj, rt = _check_parity(C, 4, "LA", 1, 0, v0=v0)
    assert (rj.n_restart, rt.n_restart) == (8, 9)


def test_callable_operator_matches_the_operator():
    C = _spectrum_matrix(60, 9)
    v0 = _t(np.random.default_rng(1).standard_normal((60, 1)))
    a = tl.lanczos_solve(to.ExplicitC(_t(C)), 3, v0=v0)
    b = tl.lanczos_solve(lambda X: _t(C) @ X, 3, v0=v0)
    assert torch.equal(a.evals, b.evals) and a.n_matvec == b.n_matvec


def test_unconverged_exit_returns_the_ritz_vectors_of_the_last_basis():
    """||C y_i - theta_i y_i|| equals the reported bound for the port's
    vectors; the reference's unconverged exit takes the restarted basis
    with the last eigenvectors of T, which breaks that identity."""
    C = _spectrum_matrix(100, 10)
    rj, rt = _run_both(C, 4, "SA", 1, 0, max_restarts=1)
    assert not rt.converged and not rj.converged
    _close(rt.evals.numpy(), rj.evals)

    def gap(res):
        Y, th = np.asarray(res.evecs), np.asarray(res.evals)
        norms = np.linalg.norm(C @ Y - Y * th, axis=0)
        return np.abs(norms - np.asarray(res.resid_bounds)).max()

    assert gap(rt) <= 1e-10
    assert gap(rj) > 1e-3


def test_default_start_is_seeded_and_validated():
    C = _t(_spectrum_matrix(50, 11))
    a = tl.lanczos_solve(to.ExplicitC(C), 3, filter_degree=4)
    b = tl.lanczos_solve(to.ExplicitC(C), 3, filter_degree=4)
    assert torch.equal(a.evecs, b.evecs) and a.converged
    with pytest.raises(ValueError, match="v0"):
        tl.lanczos_solve(to.ExplicitC(C), 3, v0=torch.ones((50, 2)))
    # the operator demotes to fp32 or bf16 only
    with pytest.raises(ValueError, match="compute_dtype"):
        tl.lanczos_solve(to.ExplicitC(C), 3, compute_dtype=torch.float16)


def test_krylov_counts_prints_one_row_per_solve_and_restores_the_product(
        monkeypatch, capsys):
    import json
    import sys
    from repro_torch.kernels.symv import ops as symv_ops
    from repro_torch.launch import krylov_counts
    block = symv_ops.symm_block
    monkeypatch.setattr(sys, "argv", [
        "krylov_counts", "--n", "60", "--s", "4", "--p", "1", "2",
        "--starts", "default", "3", "--products", "kernel", "columns",
        "matmul", "--device", "cpu"])
    krylov_counts.main()
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    # columns only at p > 1: 2 starts x (2 products at p=1 + 3 at p=2)
    assert len(rows) == 10
    assert {r["product"] for r in rows if r["p"] == 1} == {"kernel", "matmul"}
    for r in rows:
        assert r["converged"] and r["n_matvec"] > 0
        assert r["eval_err"] <= 1e-10 * r["max_abs_eval"]
    assert len(lines) == len(rows) + 1 + 4     # the header, one per key
    assert symv_ops.symm_block is block
