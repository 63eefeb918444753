"""The blocked GS1/GS2/TD1 stages of the PyTorch port (the paper's Table-4
alternatives) against the JAX reference, on the CPU.

``cholesky_blocked``, ``to_standard_sygst`` and ``tridiagonalize_blocked``
are held against their JAX functions at block = 32 / panel = 32 on sizes
that are not multiples of the block (n = 100: three full blocks and a
ragged one; n_cols = n - 2 not a multiple of 32), so they run blocked for
real; the reference default block = 256 would make every small test
matrix one block. Whole solves with the blocked stages are held against
``repro.core.solve`` with the same knobs and scored by the reference's
``accuracy_report``. Each tolerance is stated where it is used.
"""
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import accuracy_report
from repro.core import solve as j_solve
from repro.core.cholesky import cholesky_blocked as j_cholesky_blocked
from repro.core.standard_form import to_standard_sygst as j_sygst
from repro.core.standard_form import to_standard_two_trsm as j_two_trsm
from repro.core.tridiag import tridiagonalize_blocked as j_td_blocked
from repro.data.problems import dft_like, md_like
from repro_torch import core as port_core
from repro_torch.core import solve
from repro_torch.core.cholesky import cholesky_blocked
from repro_torch.core.standard_form import to_standard_sygst
from repro_torch.core.tridiag import tridiagonalize_blocked
from repro_torch.interop import problem_from_numpy, start_block_from_numpy
from repro_torch.resilience.health import chol_health
from repro_torch.resilience.recovery import SolverError

TABLE3 = 1e-12
SIZES = [(100, 32), (67, 32), (64, 32), (33, 256), (5, 2)]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _spd(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T + n * np.eye(n)          # kappa < 10


def _sym(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (M + M.T)


@pytest.mark.parametrize("n,block", SIZES)
def test_cholesky_blocked_matches_reference(n, block):
    B = _spd(n, n)
    got = cholesky_blocked(_t(B), block).numpy()
    ref = np.asarray(j_cholesky_blocked(jnp.asarray(B), block))
    # Cholesky is backward stable; with kappa(B) < 10 each factor is within
    # ~n u kappa ||U|| of the exact one (<= 1e-13 ||U|| here)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-12 * scale
    assert np.all(np.tril(got, -1) == 0.0)
    np.testing.assert_allclose(got.T @ got, B, rtol=0, atol=1e-12 * n * n)


def test_cholesky_blocked_breakdown_gives_nan_like_the_reference():
    # B not SPD in its second block: the reference's factor is NaN from
    # that block row on, finite above it; the port's is the same, and the
    # GS1 sentinel reads it as a breakdown
    n, block = 70, 32
    B = np.diag(np.r_[np.ones(40), -np.ones(30)])
    got = cholesky_blocked(_t(B), block)
    ref = np.asarray(j_cholesky_blocked(jnp.asarray(B), block))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert np.isnan(ref[32:]).any() and not np.isnan(ref[:32]).any()
    ok, _ = chol_health(got)
    assert not bool(ok)
    ok, _ = chol_health(cholesky_blocked(_t(_spd(n, 1)), block))
    assert bool(ok)


@pytest.mark.parametrize("n,block", SIZES)
def test_to_standard_sygst_matches_reference(n, block):
    A = _sym(n, n + 1)
    U = np.asarray(j_cholesky_blocked(jnp.asarray(_spd(n, n)), block))
    got = to_standard_sygst(_t(A), _t(U), block).numpy()
    ref = np.asarray(j_sygst(jnp.asarray(A), jnp.asarray(U), block=block))
    two = np.asarray(j_two_trsm(jnp.asarray(A), jnp.asarray(U)))
    # both backward-stable reductions of the same pencil; with kappa(U)
    # ~ sqrt(10) they agree to ~n u kappa(B) ||C|| (<= 1e-13 ||C|| here)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-12 * scale
    assert np.abs(got - two).max() <= 1e-12 * scale
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("n,panel", [(100, 32), (67, 32), (34, 32), (30, 8),
                                     (3, 32), (2, 32), (1, 32)])
def test_tridiagonalize_blocked_matches_reference(n, panel):
    C = _sym(n, n)
    got = tridiagonalize_blocked(_t(C), panel)
    ref = j_td_blocked(jnp.asarray(C), panel=panel)
    norm = max(np.abs(np.linalg.eigvalsh(C)).max(), 1.0)
    # reflectors are forward-sensitive: the reference's own blocked and
    # unblocked TD1 differ by ~2e-13 in d at n = 100 (||C||_2 ~ 14); the
    # bars leave a factor ~10 over the port-vs-reference gaps measured
    # (4e-13 in d at n = 67, 1e-13 in V)
    for k in ("d", "e"):
        assert np.abs(getattr(got, k).numpy() - np.asarray(
            getattr(ref, k))).max(initial=0.0) <= 1e-12 * norm
    for k in ("V", "tau"):
        assert np.abs(getattr(got, k).numpy()
                      - np.asarray(getattr(ref, k))).max() <= 1e-11
    # the columns past n - 2 stay zero, as the reference's masked ones
    assert not got.V[:, max(n - 2, 0):].any()
    assert not got.tau[max(n - 2, 0):].any()
    if n > 1:
        T = np.diag(got.d.numpy()) + np.diag(got.e.numpy(), 1) \
            + np.diag(got.e.numpy(), -1)
        assert np.abs(np.linalg.eigvalsh(T)
                      - np.linalg.eigvalsh(C)).max() <= 1e-12 * norm


# --------------------------------------------------------------- solves --

N = 100
BLOCKED = dict(gs1="blocked", gs2="sygst", td1="blocked", block=32)


def _pencil(name, n=N):
    p = (md_like if name == "md" else dft_like)(n)
    return p, problem_from_numpy(p.A, p.B, p.exact_evals, p.name,
                                 device="cpu")


def _table3(p, X, lam):
    acc = accuracy_report(p.A, p.B, jnp.asarray(X), jnp.asarray(lam))
    assert float(acc.relative_residual) <= TABLE3
    assert float(acc.b_orthogonality) <= TABLE3


def _reference_x0(n, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(20120520), (n, s),
                                      jnp.float64))


@pytest.mark.parametrize("problem,which,invert", [
    ("md", "smallest", False), ("md", "largest", False),
    ("dft", "smallest", False), ("dft", "largest", False),
    ("md", "smallest", True)])
def test_blocked_td_solve_parity(problem, which, invert):
    s = 6
    p, tp = _pencil(problem)
    ref = j_solve(p.A, p.B, s, variant="TD", which=which, invert=invert,
                  **BLOCKED)
    res = solve(tp.A, tp.B, s, variant="TD", which=which, invert=invert,
                x0=start_block_from_numpy(_reference_x0(N, s), "cpu"),
                device="cpu", **BLOCKED)
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    # the same Table-3 bar both packages meet, on the eigenvalues
    assert np.abs(ev - ev_ref).max() <= 1e-12 * np.abs(ev_ref).max()
    _table3(p, res.X.numpy(), ev)
    _table3(p, np.asarray(ref.X), ev_ref)
    exact = np.asarray(p.exact_evals)
    want = exact[:s] if which == "smallest" else exact[-s:]
    assert np.abs(ev - want).max() <= 1e-10 * np.abs(exact).max()
    assert set(res.stage_times) == set(ref.stage_times)
    assert res.info["health"] == ref.info["health"]
    # the blocked stages give what the fused ones give
    fused = solve(tp.A, tp.B, s, variant="TD", which=which, invert=invert,
                  x0=start_block_from_numpy(_reference_x0(N, s), "cpu"),
                  device="cpu")
    assert np.abs(ev - fused.evals.numpy()).max() <= \
        1e-12 * np.abs(ev_ref).max()


@pytest.mark.parametrize("variant,kw", [("KE", dict(invert=True)),
                                        ("KI", dict(invert=True)),
                                        ("TT", {})])
def test_blocked_gs1_gs2_under_the_other_variants(variant, kw):
    s = 4
    p, tp = _pencil("md", 64)
    knobs = dict(gs1="blocked", gs2="sygst", block=32)
    ref = j_solve(p.A, p.B, s, variant=variant, **knobs, **kw)
    res = solve(tp.A, tp.B, s, variant=variant, device="cpu", **knobs, **kw)
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs(ev - ev_ref).max() <= 1e-12 * np.abs(ev_ref).max()
    _table3(p, res.X.numpy(), ev)
    assert set(res.stage_times) == set(ref.stage_times)


def test_blocked_gs1_keeps_the_shift_ladder():
    # a roundoff-indefinite B: the blocked factor breaks down, the first
    # diagonal-shift rung (fused, as in the reference) rescues it
    p, tp = _pencil("md", 64)
    B = np.array(p.B)
    w, Q = np.linalg.eigh(B)
    w[0] = -1e-14 * w[-1]
    Bi = (Q * w) @ Q.T
    Bi = 0.5 * (Bi + Bi.T)
    ref = j_solve(p.A, jnp.asarray(Bi), 3, gs1="blocked", block=32)
    res = solve(tp.A, _t(Bi), 3, gs1="blocked", block=32, device="cpu")
    assert res.info["recovery"] == ref.info["recovery"]
    assert res.info["recovery"][0]["action"] == "cholesky_shift"
    assert res.info["gs1_shift"] == ref.info["gs1_shift"]
    with pytest.raises(SolverError, match="GS1"):
        solve(tp.A, -tp.B, 3, gs1="blocked", block=32, device="cpu")


@pytest.mark.parametrize("kw", [dict(gs1="lapack"), dict(gs2="dsygst"),
                                dict(td1="panel")])
def test_unknown_stage_options_raise(kw):
    _, tp = _pencil("md", 40)
    with pytest.raises(ValueError, match=next(iter(kw))):
        solve(tp.A, tp.B, 3, device="cpu", **kw)


def test_core_exports_the_stages():
    for name in ("cholesky_upper", "cholesky_blocked", "to_standard_two_trsm",
                 "to_standard_sygst", "tridiagonalize",
                 "tridiagonalize_blocked"):
        assert name in port_core.__all__ and hasattr(port_core, name)


def test_cli_blocked_payload(monkeypatch):
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", [
        "eigsolve", "--problem", "md", "--n", "70", "--s", "4", "--gs2",
        "sygst", "--td1", "blocked", "--device", "cpu", "--json"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["variant"] == "TD" and payload["device"] == "cpu"
    assert payload["relative_residual"] <= TABLE3
    assert payload["b_orthogonality"] <= TABLE3
    assert payload["max_abs_eval_error"] <= 1e-10
    assert set(payload["stage_times_s"]) == {"GS1", "GS2", "TD1", "TD2",
                                             "TD3", "BT1", "Tot."}
