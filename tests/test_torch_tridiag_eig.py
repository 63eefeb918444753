"""TD2 in the PyTorch port against the JAX reference, on the CPU.

The same tridiagonals, made with numpy from a seed, go through
``repro.core.tridiag_eig`` (and the Pallas kernel in interpret mode) and
through ``repro_torch``'s plain versions — the code a CPU tensor runs.
Bisection is held bitwise; inverse iteration gets the start block JAX drew
and is held elementwise on separated spectra (after fixing each column's
sign) and by residual, orthogonality and subspace angle on clusters.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import tridiag_eig as jte
from repro.kernels.tridiag_eig.ops import bisect_sturm as j_bisect_sturm
from repro_torch.core import tridiag_eig as tte
from repro_torch.kernels import _build
from repro_torch.kernels.tridiag_eig import kernel, ops

KEY = jax.random.PRNGKey(9)


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def _wilkinson(m=10):
    """W(2m+1)+: the top eigenvalue pairs agree to ~machine precision."""
    n = 2 * m + 1
    return np.abs(np.arange(n) - m).astype(np.float64), np.ones(n - 1)


def _graded(n=40):
    return 10.0 ** (-np.arange(n) / 3.0), 1e-4 * 10.0 ** (-np.arange(n - 1) / 3.0)


def _fixture(name):
    if name == "random64":
        return _rand(64, 0), np.arange(8)
    if name == "random128":
        return _rand(128, 1), np.arange(120, 128)
    if name == "wilkinson_top":
        d, e = _wilkinson(10)
        return (d, e), np.arange(13, 21)
    if name == "wilkinson_low":
        return _wilkinson(10), np.arange(6)
    return _graded(40), np.arange(8)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _dense(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _jax_x0(key, n, s):
    return np.array(jax.random.normal(key, (n, s), jnp.float64))


def _check_pairs(d, e, lam, Z, tol=1e-12):
    T = _dense(d, e)
    scale = max(np.abs(T).max(), 1.0)
    assert np.abs(T @ Z - Z * lam).max() < tol * scale
    assert np.abs(Z.T @ Z - np.eye(Z.shape[1])).max() < tol


def _sign_fixed(Z, ref):
    sign = np.where(np.sum(Z * ref, 0) < 0, -1.0, 1.0)
    return Z * sign


# ------------------------------------------------------------ bisection --

@pytest.mark.parametrize("name", ["random64", "random128", "wilkinson_top",
                                  "wilkinson_low", "graded"])
def test_bisection_bitwise_vs_reference(name):
    (d, e), ks = _fixture(name)
    ref = np.asarray(jte.bisect_eigenvalues(jnp.asarray(d), jnp.asarray(e),
                                            jnp.asarray(ks)))
    lam = tte.bisect_eigenvalues(_t(d), _t(e), torch.from_numpy(ks)).numpy()
    assert np.array_equal(ref, lam)


@pytest.mark.parametrize("name", ["random64", "wilkinson_top"])
def test_bisection_bitwise_vs_pallas_interpret(name):
    (d, e), ks = _fixture(name)
    ref = np.asarray(j_bisect_sturm(jnp.asarray(d), jnp.asarray(e),
                                    jnp.asarray(ks), force_kernel=True))
    lam = ops.bisect_sturm(_t(d), _t(e), torch.from_numpy(ks)).numpy()
    assert np.array_equal(ref, lam)


def test_bisection_lanes_are_independent_of_order():
    (d, e), ks = _fixture("random64")
    perm = np.array([5, 0, 7, 2, 1, 6, 3, 4])
    lam = tte.bisect_eigenvalues(_t(d), _t(e), torch.from_numpy(ks)).numpy()
    lam_p = tte.bisect_eigenvalues(_t(d), _t(e),
                                   torch.from_numpy(ks[perm])).numpy()
    assert np.array_equal(lam[perm], lam_p)


def test_sturm_count_matches_reference():
    d, e = _rand(48, 3)
    for x in (-2.0, 0.0, 0.7, 3.5):
        assert tte.sturm_count(_t(d), _t(e), x) == int(
            jte.sturm_count(jnp.asarray(d), jnp.asarray(e), jnp.asarray(x)))


# ----------------------------------------------------- inverse iteration --

@pytest.mark.parametrize("name", ["random64", "random128", "graded"])
def test_inverse_iteration_elementwise_vs_reference(name):
    """Separated spectra: each vector is determined up to sign. The sign
    is not: the last pivot of a solve at a converged shift is a rounding
    residue whose sign the reference's compiler may set differently."""
    (d, e), ks = _fixture(name)
    lam = np.asarray(jte.bisect_eigenvalues(jnp.asarray(d), jnp.asarray(e),
                                            jnp.asarray(ks)))
    n, s = d.shape[0], ks.shape[0]
    Z_ref = np.asarray(jte.inverse_iteration(jnp.asarray(d), jnp.asarray(e),
                                             jnp.asarray(lam), KEY))
    Z = tte.inverse_iteration(_t(d), _t(e), _t(lam),
                              x0=_t(_jax_x0(KEY, n, s))).numpy()
    assert np.abs(_sign_fixed(Z, Z_ref) - Z_ref).max() <= 1e-10
    _check_pairs(d, e, lam, Z)


@pytest.mark.parametrize("name", ["wilkinson_top", "wilkinson_low"])
def test_inverse_iteration_clustered_vs_reference(name):
    (d, e), ks = _fixture(name)
    lam = np.asarray(jte.bisect_eigenvalues(jnp.asarray(d), jnp.asarray(e),
                                            jnp.asarray(ks)))
    n, s = d.shape[0], ks.shape[0]
    Z_ref = np.asarray(jte.inverse_iteration(jnp.asarray(d), jnp.asarray(e),
                                             jnp.asarray(lam), KEY))
    Z = tte.inverse_iteration(_t(d), _t(e), _t(lam),
                              x0=_t(_jax_x0(KEY, n, s))).numpy()
    _check_pairs(d, e, lam, Z)
    cid = tte._cluster_ids(_t(lam), float(np.abs(d).max())).numpy()
    for c in np.unique(cid):
        A, B = Z[:, cid == c], Z_ref[:, cid == c]
        assert np.linalg.norm(A - B @ (B.T @ A), 2) <= 1e-12


def test_eigh_selected_shuffled_ks_regression():
    """Unsorted ``ks`` must be sorted before the gap-based clustering and
    restored after: the Wilkinson top pair interleaved here used to land in
    different clusters and come back overlapping at ~1e-3."""
    d, e = _wilkinson(10)
    n = d.shape[0]
    ks = np.array([n - 1, n - 3, n - 2, n - 4])
    lam, Z = tte.eigh_tridiag_selected(_t(d), _t(e), torch.from_numpy(ks))
    _check_pairs(d, e, lam.numpy(), Z.numpy())
    ref = np.linalg.eigvalsh(_dense(d, e))
    assert np.abs(lam.numpy() - ref[ks]).max() < 1e-12


def test_eigh_selected_shuffled_matches_sorted():
    d, e = _rand(32, 7)
    ks = np.arange(6)
    perm = np.array([4, 0, 5, 2, 1, 3])
    lam_s, Z_s = tte.eigh_tridiag_selected(_t(d), _t(e), torch.from_numpy(ks))
    lam_p, Z_p = tte.eigh_tridiag_selected(_t(d), _t(e),
                                           torch.from_numpy(ks[perm]))
    assert torch.equal(lam_s[perm], lam_p)
    assert torch.equal(Z_s[:, perm], Z_p)


def test_eigh_selected_start_block_in_sorted_order():
    """``x0`` follows the sorted indices, as the reference draws it."""
    d, e = _rand(40, 11)
    ks = np.array([3, 0, 2])
    x0 = _jax_x0(KEY, 40, 3)
    lam, Z = tte.eigh_tridiag_selected(_t(d), _t(e), torch.from_numpy(ks),
                                       x0=_t(x0))
    ref_lam, ref_Z = jte.eigh_tridiag_selected(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(ks), KEY, method="scan")
    assert np.array_equal(np.asarray(ref_lam), lam.numpy())
    assert np.abs(_sign_fixed(Z.numpy(), np.asarray(ref_Z))
                  - np.asarray(ref_Z)).max() <= 1e-10


def test_n_equals_1():
    lam, Z = tte.eigh_tridiag_selected(_t([2.5]), _t(np.zeros(0)),
                                       torch.tensor([0]))
    assert np.allclose(lam.numpy(), [2.5])
    assert np.allclose(np.abs(Z.numpy()), [[1.0]])


def test_s_equals_n():
    d, e = _rand(12, 5)
    lam, Z = tte.eigh_tridiag_selected(_t(d), _t(e), torch.arange(12))
    ref = np.linalg.eigvalsh(_dense(d, e))
    assert np.abs(lam.numpy() - ref).max() < 1e-12
    _check_pairs(d, e, lam.numpy(), Z.numpy())


def test_default_start_block_is_seeded():
    d, e = _rand(30, 2)
    a = tte.eigh_tridiag_selected(_t(d), _t(e), torch.arange(4))
    b = tte.eigh_tridiag_selected(_t(d), _t(e), torch.arange(4))
    assert torch.equal(a.Z, b.Z)


# -------------------------------------------------- norms, wrappers, build --

def test_rescaled_norm_survives_what_the_naive_norm_overflows():
    """Columns at the 1/pivmin scale: the naive 2-norm is inf (torch, numpy
    and jnp alike), the max-abs-rescaled one is finite and right."""
    x = torch.full((4, 1), 1e200, dtype=torch.float64)
    assert torch.isinf(torch.linalg.vector_norm(x, dim=0)).all()
    with np.errstate(over="ignore"):
        assert np.isinf(np.linalg.norm(x.numpy(), axis=0)).all()
    nrm = tte.rescaled_norm(x, 0)
    assert torch.allclose(nrm, torch.tensor([[2e200]], dtype=torch.float64))
    assert torch.allclose(tte.normalize_columns(x), torch.full_like(x, 0.5))


@pytest.mark.parametrize("fn", ["bisect_sturm", "invit"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    d, e = _rand(8, 0)
    if fn == "bisect_sturm":
        e2, scal = tte.bisect_inputs(_t(d), _t(e))
        call = lambda: kernel.bisect_sturm(_t(d), e2, torch.arange(2), scal)  # noqa: E731
    else:
        call = lambda: kernel.invit(  # noqa: E731
            _t(d), _t(e), _t([0.0, 1.0]), torch.zeros(2, dtype=torch.int32),
            torch.tensor(1e-300, dtype=torch.float64),
            torch.ones((8, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")
    monkeypatch.setattr(kernel, "bisect_sturm", boom)
    monkeypatch.setattr(kernel, "invit", boom)
    d, e = _rand(20, 4)
    lam, Z = ops.tridiag_eig_kernel(_t(d), _t(e), torch.arange(3))
    _check_pairs(d, e, lam.numpy(), Z.numpy())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_launch_counters_reset_and_read():
    kernel.reset_launches()
    assert kernel.launch_counts() == {"bisect_sturm": 0, "invit": 0}
