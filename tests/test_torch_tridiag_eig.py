"""TD2 in the PyTorch port against the JAX reference, on the CPU.

The same tridiagonals, made with numpy from a seed, go through
``repro.core.tridiag_eig`` (and the Pallas kernel in interpret mode) and
through ``repro_torch``'s plain versions — the code a CPU tensor runs.
Bisection is held bitwise; inverse iteration gets the start block JAX drew
and is held elementwise on separated spectra (after fixing each column's
sign) and by residual, orthogonality and subspace angle on clusters.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import tridiag_eig as jte
from repro.kernels.tridiag_eig.ops import bisect_sturm as j_bisect_sturm
from repro_torch.core import tridiag_eig as tte
from repro_torch.kernels import _build
from repro_torch.kernels.tridiag_eig import kernel, ops, ref, schedule

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


# ------------------------------------------- multisection (the kernel's order) --

def _multisection_fixture(name):
    if name == "split":                   # e = 0 splits it into three blocks
        d, e = _rand(40, 5)
        e[[9, 24]] = 0.0
        return (d, e), np.arange(0, 40, 5)
    if name == "constant":                # a constant diagonal
        return (np.full(30, 2.0), np.ones(29)), np.arange(11, 19)
    if name == "straddle0":               # eigenvalues on both sides of 0
        return (np.linspace(-1.0, 1.0, 33), np.full(32, 0.1)), np.arange(13, 20)
    return _fixture(name)


@functools.lru_cache(maxsize=None)
def _plain_bisection(name, max_iters):
    """(inputs, the plain bisection, the JAX one) of a fixture."""
    (d, e), ks = _multisection_fixture(name)
    e2, scal = tte.bisect_inputs(_t(d), _t(e))
    ks_t = torch.from_numpy(ks)
    plain = ref.bisect_sturm_ref(_t(d), e2, ks_t, scal, max_iters=max_iters)
    jax_lam = np.asarray(jte.bisect_eigenvalues(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(ks), max_iters=max_iters))
    return (_t(d), e2, ks_t, scal), plain, jax_lam


@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_iters", [80, 7, 1])
@pytest.mark.parametrize("levels", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("name", ["random64", "wilkinson_top", "graded",
                                  "split", "constant", "straddle0"])
def test_multisection_bitwise_vs_bisection(name, levels, max_iters, stop):
    """The kernel's order (m levels a Sturm sweep, the walk, the stop at a
    fixed point) is the sequential bisection bit for bit: against the
    port's plain version and the JAX reference."""
    args, plain, jax_lam = _plain_bisection(name, max_iters)
    lam, sweeps = schedule.bisect_multisection(*args, levels, max_iters,
                                               stop=stop)
    assert torch.equal(lam, plain)
    assert np.array_equal(lam.numpy(), jax_lam)
    rounds = -(-max_iters // levels)
    assert bool(torch.all((sweeps >= 1) & (sweeps <= rounds)))
    if not stop:    # the sweep counts do not depend on the stop
        on = schedule.bisect_multisection(*args, levels, max_iters)[1]
        assert torch.equal(on, sweeps)


def test_multisection_stops_at_the_fixed_point():
    """At 80 levels O(1) eigenvalues reach their fixed point before the
    last sweep, and one level a sweep counts the levels taken."""
    args, plain, _ = _plain_bisection("random64", 80)
    _, levels = schedule.bisect_multisection(*args, 1, 80)
    assert 40 < int(levels.max()) < 80
    _, sweeps = schedule.bisect_multisection(*args, 8, 80)
    assert torch.equal(sweeps, -(-levels // 8))


@pytest.mark.parametrize("n,s,sms,max_iters,want", [
    (9997, 100, 132, 80, (8, 256, 1, 100)),     # MD: a team an SM
    (17243, 448, 132, 80, (6, 64, 4, 112)),     # DFT: four teams an SM
    (9997, 1, 132, 80, (8, 256, 1, 1)),
    (1, 1, 132, 80, (8, 256, 1, 1)),            # n does not move the plan
    (1, 3, 132, 7, (7, 128, 1, 3)),             # m at most max_iters
    (50, 5, 132, 1, (1, 2, 1, 5)),
    (3000, 130, 132, 80, (8, 256, 1, 130)),
    (3000, 300, 132, 80, (6, 64, 3, 100)),      # 192 threads, not 384
    (100, 448, 16, 80, (3, 8, 28, 16)),         # a smaller card
    (100, 264, 132, 80, (7, 128, 2, 132)),      # two teams: 256 threads
    (100, 660, 132, 80, (5, 32, 5, 132)),       # five: 160, not 320
    (100, 16896, 132, 80, (1, 2, 128, 132)),    # 128 teams: 256 threads
    (100, 17028, 132, 80, (1, 2, 129, 132)),    # 129: past 256 at any m
    (100, 10 ** 5, 132, 80, (1, 2, 512, 196)),  # beyond 512 teams an SM
])
def test_bisect_plan(n, s, sms, max_iters, want):
    plan = kernel.bisect_plan(n, s, sms, max_iters)
    assert tuple(plan) == want
    assert plan.lanes == 1 << plan.levels
    assert plan.per_block * plan.lanes <= kernel.MAX_THREADS
    assert plan.per_block * plan.blocks >= s > plan.per_block * (plan.blocks - 1)
    if plan.levels > 1:     # the most levels within FLAT_THREADS an SM
        teams = -(-s // sms)
        assert teams << plan.levels <= kernel.FLAT_THREADS
        assert (teams << plan.levels + 1 > kernel.FLAT_THREADS
                or plan.levels == min(max_iters, kernel.MAX_LEVELS))


def test_bisect_plan_forced_levels_and_refusals():
    assert kernel.bisect_plan(9997, 448, 132, levels=10) == (10, 1024, 1, 448)
    assert kernel.bisect_plan(9997, 100, 132, levels=1) == (1, 2, 1, 100)
    for bad in ({"s": 0}, {"sms": 0}, {"levels": 0}, {"levels": 11}):
        args = {"n": 10, "s": 4, "sms": 132, **bad}
        with pytest.raises(ValueError):
            kernel.bisect_plan(**args)


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


# ------------------------- the Gram-Schmidt of the CUDA invit, in its order --

def _orth_panels(Z, cid, nb=kernel.PANEL):
    """One Gram-Schmidt round of ``csrc/tridiag_eig.cu``'s ``invit_orth``,
    in its order of work: every column's rescaled norm; again for the
    singleton columns past the first; then each cluster of two or more
    columns in panels of ``nb``: the panel projected against the cluster's
    earlier columns (C = Z_prev^T Z_panel, Z_panel -= Z_prev C), then its
    columns one at a time (classical: the coefficients from the column
    after that projection), each renormalized but the first column of Z."""
    tiny = torch.finfo(Z.dtype).tiny
    Z = tte.normalize_columns(Z)
    c = cid.tolist()
    s = len(c)
    single = [i for i in range(1, s)
              if c[i] != c[i - 1] and (i + 1 == s or c[i + 1] != c[i])]
    if single:
        Z[:, single] = tte.normalize_columns(Z[:, single])
    c0 = p0 = 0
    while p0 < s:
        if p0 > 0 and c[p0] != c[p0 - 1]:
            c0 = p0
        c1 = p0 + 1
        while c1 < s and c[c1] == c[c0]:
            c1 += 1
        p1 = min(c1, p0 + nb)
        if c1 - c0 > 1:
            P = Z[:, p0:p1].clone()
            if p0 > c0:
                prev = Z[:, c0:p0]
                P -= prev @ (prev.mT @ P)
            for ii in range(p1 - p0):
                if ii > 0:
                    P[:, ii] -= P[:, :ii] @ (P[:, :ii].mT @ P[:, ii])
                if p0 + ii > 0:
                    P[:, ii] /= torch.clamp_min(tte.rescaled_norm(P[:, ii], 0),
                                                tiny)
            Z[:, p0:p1] = P
        p0 = p1
    return Z


def _invit_panels(d, e, lam, cid, pivmin, X0, iters=3):
    """The CUDA ``invit``'s rounds in plain PyTorch: the pivoted solve, then
    ``_orth_panels`` (a second plain form beside ``invit_ref``)."""
    Z = X0
    for _ in range(iters):
        Z = _orth_panels(tte._gttrf_gtts2(d, e, lam, Z, float(pivmin)), cid)
    return Z


def _grouped(sizes, wanted, seed):
    """A tridiagonal whose eigenvalues come in groups: group g of sizes[g]
    near g + 1 (spread ~1e-6, coupling 1e-7 across groups), so clusters
    of 1e-3 ||T|| hold the groups; the ``wanted`` smallest are taken."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([g + 1.0 + 1e-6 * rng.standard_normal(m)
                        for g, m in enumerate(sizes)])
    e = 1e-6 * rng.standard_normal(d.shape[0] - 1)
    for edge in np.cumsum(sizes)[:-1]:
        e[edge - 1] = 1e-7
    return d, e, np.arange(wanted)


#: cluster layouts (group sizes, wanted): one cluster of 40 over two
#: panels; clusters of 20, 33, 37 across the 32-column panel edges (s=90);
#: singletons between clusters (s=40); a separated random spectrum
INVIT_LAYOUTS = {
    "one_cluster": ((80,), 40),
    "straddle_panels": ((20, 33, 37, 10), 90),
    "singletons": ((1, 1, 6, 1, 3, 1, 1, 25, 1, 8), 40),
}


def _layout(name):
    if name == "separated":
        (d, e), _ = _fixture("random128")
        return d, e, np.arange(40)
    sizes, wanted = INVIT_LAYOUTS[name]
    return _grouped(sizes, wanted, len(name))


@pytest.mark.parametrize("name", [*INVIT_LAYOUTS, "separated"])
def test_panel_gram_schmidt_vs_reference(name):
    """The kernel's order of work against the JAX ``inverse_iteration`` on
    the same start block: residual and orthogonality within 1e-12, each
    cluster's subspace within 1e-8, singleton columns within 1e-10."""
    d, e, ks = _layout(name)
    n, s = d.shape[0], ks.shape[0]
    lam = np.asarray(jte.bisect_eigenvalues(jnp.asarray(d), jnp.asarray(e),
                                            jnp.asarray(ks)))
    Z_ref = np.asarray(jte.inverse_iteration(jnp.asarray(d), jnp.asarray(e),
                                             jnp.asarray(lam), KEY))
    dt, et, lt = _t(d), _t(e), _t(lam)
    cid = tte._cluster_ids(lt, tte._scale(dt, et))
    X0 = tte.normalize_columns(_t(_jax_x0(KEY, n, s)))
    Z = _invit_panels(dt, et, lt, cid, tte._pivmin(dt, et), X0).numpy()
    _check_pairs(d, e, lam, Z)
    cidn = cid.numpy()
    sizes = np.bincount(cidn)
    if name != "separated":
        assert sizes.max() > 1
    single = sizes[cidn] == 1
    if single.any():
        assert np.abs(_sign_fixed(Z, Z_ref) - Z_ref)[:, single].max() <= 1e-10
    for c in np.flatnonzero(sizes > 1):
        A, B = Z[:, cidn == c], Z_ref[:, cidn == c]
        assert np.linalg.norm(A - B @ (B.T @ A), 2) <= 1e-8


def test_panel_gram_schmidt_at_the_pivmin_scale_vs_invit_ref():
    """Shifts on exact eigenvalues of a diagonal T: a clamped zero pivot
    sends the solve's columns to ~1/pivmin, where the reference's naive
    norm overflows (ROADMAP.md §3), so the oracle is ``invit_ref``."""
    d = np.array([1.0, 1.0 + 1e-9, 1.0 + 2e-9, 2.0, 3.0, 3.0 + 1e-9, 5.0,
                  7.0])
    e = np.zeros(7)
    dt, et = _t(d), _t(e)
    lam = tte.bisect_eigenvalues(dt, et, torch.arange(6))
    cid = tte._cluster_ids(lam, tte._scale(dt, et))
    piv = tte._pivmin(dt, et)
    X0 = tte.normalize_columns(_t(_jax_x0(KEY, 8, 6)))
    first = tte._gttrf_gtts2(dt, et, lam, X0, float(piv))
    assert float(first.abs().max()) > 1e250          # the 1/pivmin scale
    Z = _invit_panels(dt, et, lam, cid, piv, X0)
    Zp = ref.invit_ref(dt, et, lam, cid, piv, X0)
    assert torch.isfinite(Z).all()
    _check_pairs(d, e, lam.numpy(), Z.numpy())
    cidl = cid.long()
    for c in torch.unique(cidl).tolist():
        A, B = Z[:, cidl == c], Zp[:, cidl == c]
        assert float(torch.linalg.matrix_norm(A - B @ (B.mT @ A), 2)) <= 1e-8


def test_orth_plan_spans_the_card():
    """The Gram-Schmidt runs a block per SM at the paper's sizes, each with
    its rows of a 32-column panel in shared memory."""
    md = kernel.orth_plan(9997, 100, 132)
    dft = kernel.orth_plan(17243, 448, 132)
    assert (md.blocks, md.rows, dft.blocks, dft.rows) == (132, 76, 132, 131)
    assert dft.smem == 131 * kernel.PANEL * 8 <= kernel.SMEM_MAX
    assert kernel.orth_plan(12, 3, 132).blocks == 1
    with pytest.raises(ValueError, match="n up to"):
        kernel.orth_plan(10 ** 6, 4, 132)
    assert kernel.LAUNCHES_PER_ROUND == 2


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
