"""The TD pipeline's stages in the PyTorch port against the JAX reference.

Inputs are made with numpy from a seed (or by ``repro.data.problems`` and
carried across with ``repro_torch.interop``) and go through both
packages on the CPU; results agree to 1e-12 relative.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import back_transform as jbt
from repro.core import cholesky as jch
from repro.core import linalg_utils as jlu
from repro.core import residuals as jres
from repro.core import standard_form as jsf
from repro.core import tridiag as jtd
from repro.data.problems import dft_like as j_dft_like
from repro.data.problems import md_like as j_md_like
from repro.resilience.health import chol_health as j_chol_health
from repro_torch.core import back_transform as tbt
from repro_torch.core import cholesky as tch
from repro_torch.core import linalg_utils as tlu
from repro_torch.core import precision as tprec
from repro_torch.core import residuals as tres
from repro_torch.core import standard_form as tsf
from repro_torch.core import tridiag as ttd
from repro_torch.data import problems as tprob
from repro_torch.interop import problem_from_numpy, start_block_from_numpy
from repro_torch.resilience.health import chol_health

RTOL = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1.0)


def _sym(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (M + M.T)


def _spd(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T / n + np.eye(n)


# --------------------------------------------------------------- helpers --

@pytest.mark.parametrize("pivot", [0, 1, 5, 14, 15, 16])
def test_householder_masked_vs_reference(pivot):
    x = np.random.default_rng(pivot).standard_normal(16)
    v, tau, beta = tlu.householder_masked(_t(x), pivot)
    jv, jtau, jbeta = jlu.householder_masked(jnp.asarray(x), jnp.asarray(pivot))
    _close(v.numpy(), jv)
    _close(tau.numpy(), jtau)
    _close(beta.numpy(), jbeta)


def test_householder_masked_zero_tail_is_identity():
    x = np.zeros(8)
    x[3] = -2.0
    v, tau, beta = tlu.householder_masked(_t(x), 3)
    assert float(tau) == 0.0 and float(beta) == -2.0
    assert np.array_equal(v.numpy(), np.eye(8)[3])


def test_gershgorin_bounds_bitwise():
    rng = np.random.default_rng(3)
    d, e = rng.standard_normal(30), rng.standard_normal(29)
    lo, hi = tlu.gershgorin_bounds(_t(d), _t(e))
    jlo, jhi = jlu.gershgorin_bounds(jnp.asarray(d), jnp.asarray(e))
    assert float(lo) == float(jlo) and float(hi) == float(jhi)


# ------------------------------------------------------------ TD1 / TD3 --

@pytest.mark.parametrize("n", [2, 3, 17, 48])
def test_tridiagonalize_vs_reference(n):
    C = _sym(n, n)
    res = ttd.tridiagonalize(_t(C))
    ref = jtd.tridiagonalize(jnp.asarray(C))
    _close(res.d.numpy(), ref.d)
    _close(np.abs(res.e.numpy()), np.abs(np.asarray(ref.e)))
    _close(res.V.numpy(), ref.V)
    _close(res.tau.numpy(), ref.tau)
    # T is similar to C
    T = np.diag(res.d.numpy()) + np.diag(res.e.numpy(), 1) \
        + np.diag(res.e.numpy(), -1)
    _close(np.linalg.eigvalsh(T), np.linalg.eigvalsh(C))


@pytest.mark.parametrize("fn", ["apply_q", "apply_qt"])
def test_apply_q_vs_reference(fn):
    n, s = 40, 5
    C = _sym(n, 1)
    Z = np.random.default_rng(2).standard_normal((n, s))
    res = ttd.tridiagonalize(_t(C))
    jres_ = jtd.TridiagResult(*(jnp.asarray(x.numpy()) for x in res))
    Y = getattr(ttd, fn)(res, _t(Z)).numpy()
    _close(Y, getattr(jtd, fn)(jres_, jnp.asarray(Z)))


def test_apply_q_reconstructs_c():
    n = 24
    C = _sym(n, 4)
    res = ttd.tridiagonalize(_t(C))
    Q = ttd.apply_q(res, torch.eye(n, dtype=torch.float64))
    T = Q.mT @ _t(C) @ Q
    _close(torch.diagonal(T).numpy(), res.d.numpy())
    _close(torch.diagonal(T, -1).numpy(), res.e.numpy())
    _close(torch.triu(T, 2).numpy(), np.zeros((n, n)))


# ------------------------------------------------------- GS1 / GS2 / BT1 --

def test_cholesky_upper_vs_reference():
    B = _spd(32, 5)
    _close(tch.cholesky_upper(_t(B)).numpy(), jch.cholesky_upper(jnp.asarray(B)))


def test_cholesky_breakdown_is_nan_and_unhealthy():
    B = _spd(16, 6)
    B[3, 3] = -1.0
    U = tch.cholesky_upper(_t(B))
    assert torch.isnan(U).all()
    ok, _ = chol_health(U)
    jok, _ = j_chol_health(jch.cholesky_upper(jnp.asarray(B)))
    assert not bool(ok) and not bool(jok)


def test_diag_shifted_vs_reference():
    B = _spd(12, 7)
    _close(tch.diag_shifted(_t(B), 1e-6).numpy(),
           jch.diag_shifted(jnp.asarray(B), 1e-6))


def test_to_standard_two_trsm_vs_reference():
    A, B = _sym(40, 8), _spd(40, 9)
    U = jch.cholesky_upper(jnp.asarray(B))
    C = tsf.to_standard_two_trsm(_t(A), _t(U))
    _close(C.numpy(), jsf.to_standard_two_trsm(jnp.asarray(A), U))
    assert torch.equal(C, C.mT)


def test_back_transform_vs_reference():
    B = _spd(30, 10)
    U = np.asarray(jch.cholesky_upper(jnp.asarray(B)))
    Y = np.random.default_rng(11).standard_normal((30, 4))
    X = tbt.back_transform_generalized(_t(U), _t(Y))
    _close(X.numpy(), jbt.back_transform_generalized(jnp.asarray(U),
                                                     jnp.asarray(Y)))
    _close(tbt.forward_transform_generalized(_t(U), X).numpy(), Y)


def test_residual_metrics_vs_reference():
    A, B = _sym(24, 12), _spd(24, 13)
    X = np.random.default_rng(14).standard_normal((24, 3))
    lam = np.array([0.1, 0.5, 2.0])
    acc = tres.accuracy_report(_t(A), _t(B), _t(X), _t(lam))
    ref = jres.accuracy_report(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X),
                               jnp.asarray(lam))
    _close(acc.b_orthogonality.numpy(), ref.b_orthogonality)
    _close(acc.relative_residual.numpy(), ref.relative_residual)
    _close(tres.b_normalize(_t(X), _t(B)).numpy(),
           jres.b_normalize(jnp.asarray(X), jnp.asarray(B)))


# --------------------------------------------------------- precision, data --

@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_demoted_precisions_resolve_to_their_dtypes(precision):
    # the demoted levels run (tests/test_torch_precision.py); their dtypes
    # are the reference's, and an unknown level still raises
    assert tprec.validate_precision(precision) == precision
    want = {"mixed": torch.float32, "fast": torch.bfloat16}[precision]
    assert tprec.compute_dtype(precision) == want
    with pytest.raises(ValueError):
        tprec.validate_precision("fp16")
    assert tprec.compute_dtype("fp64") == torch.float64


def test_ensure_strong_pins_float64():
    x = tprec.ensure_strong(np.ones((2, 2), np.float32), torch.device("cpu"))
    assert x.dtype == torch.float64


@pytest.mark.parametrize("gen", ["md", "dft"])
def test_generators_have_the_stated_spectrum(gen):
    make = tprob.md_like if gen == "md" else tprob.dft_like
    p = make(32, device="cpu")
    assert p.A.dtype == torch.float64 and p.A.shape == (32, 32)
    L = torch.linalg.cholesky(p.B)
    Linv = torch.linalg.inv(L)
    ev = torch.linalg.eigvalsh(Linv @ p.A @ Linv.mT)
    _close(ev.numpy(), p.exact_evals.numpy(), rtol=1e-10)
    assert torch.equal(make(32, device="cpu").A, p.A)  # seeded
    assert tprob.paper_shapes() == {"md": dict(n=9_997, s=100),
                                    "dft": dict(n=17_243, s=448)}


@pytest.mark.parametrize("gen", [j_md_like, j_dft_like])
def test_interop_carries_the_reference_pencil(gen):
    p = gen(16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
        x0 = start_block_from_numpy(np.asarray(p.A)[:, :3], device="cpu")
    assert np.array_equal(tp.A.numpy(), np.asarray(p.A))
    assert np.array_equal(tp.B.numpy(), np.asarray(p.B))
    assert tp.name == p.name and x0.shape == (16, 3)
