"""The distributed building blocks and solvers of ``repro_torch.dist`` in
gloo worlds of 1, 2 and 4 ranks on the CPU (``dist.launcher.run_local``).

Oracles, as the JAX mesh paths allow (their GSPMD Cholesky raises on
every mesh, and their shard_maps need n to tile the mesh):
  * ``dist_symv``/``_rs``, ``dist_gemm``/``_rs``, ``dist_syr2k``, the
    panel products and ``dist_reduce_to_band`` at n=48 against the JAX
    ``dist_*`` on a (2, 1) mesh of 2 forced host devices (a subprocess),
    at n=49 against numpy;
  * ``dist_cholesky``/``dist_trsm_left_t``/``dist_trsm_left`` against the
    reference's blocked bodies (``_chol_blocked``, ``_trsm_lt_blocked``,
    ``_trsm_l_blocked``) run unsharded with the same block;
  * ``dist_tridiag_eig`` against the port's replicated
    ``eigh_tridiag_selected`` (eigenvalues bit for bit);
  * ``solve(..., mesh=)`` against the JAX single-device ``solve`` on the
    same pencil, scored by ``repro.core.residuals.accuracy_report``.
Each world runs many checks once (cached per module); every rank reports
its verdicts, so the tests also show that all ranks took the same branches.
Only this module's functions (no JAX at import) run inside the ranks.
"""
import functools
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist import launcher

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(2, 1), (1, 2), (2, 2)]
S = 4
TABLE3 = 1e-12
#: the Wilkinson matrix W21+ and 7 top indices: its near-degenerate top
#: pairs cross the index slices at 2 and 4 ranks
WILK_N, WILK_KS = 21, list(range(14, 21))


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    A = 0.5 * (M + M.T)
    return {"A": A, "x": rng.standard_normal(n),
            "Bm": rng.standard_normal((n, 5)),
            "V": rng.standard_normal((n, 3)),
            "W": rng.standard_normal((n, 3)),
            "T": np.triu(rng.standard_normal((3, 3))),
            "SPD": A @ A.T + n * np.eye(n)}


INPUTS = {48: _inputs(48), 49: _inputs(49)}


def _wilkinson():
    m = (WILK_N - 1) // 2
    d = torch.abs(torch.arange(-m, m + 1, dtype=torch.float64))
    e = torch.ones(WILK_N - 1, dtype=torch.float64)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (WILK_N, len(WILK_KS))))
    return d, e, x0


def _gather_ranks(obj):
    """Every rank's ``obj``, in rank order."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ------------------------------------------------------------ the worlds --

def _la_world(mesh, inputs):
    from repro_torch.dist import sharded_la as sl
    from repro_torch.dist.eigensolver import (dist_reduce_to_band,
                                              dist_reduce_to_band_stepwise,
                                              dist_tridiag_eig)
    from repro_torch.dist.mesh import tiling
    torch.set_num_threads(1)
    out = {}
    for n, d in inputs.items():
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        A = t["A"]
        r = out[n] = {}
        r["symv"] = sl.dist_symv(mesh, A, t["x"])
        r["symv_rs"] = sl.dist_symv_rs(mesh, A, t["x"])
        r["gemm"] = sl.dist_gemm(mesh, A, t["Bm"])
        r["gemm_rs"] = sl.dist_gemm_rs(mesh, A, t["Bm"])
        r["syr2k"] = sl.dist_syr2k(mesh, A, t["V"], t["W"])
        r["panel_matmul"] = sl.dist_panel_matmul(mesh, A, t["V"])
        r["wy_two_sided"] = sl.dist_apply_wy_two_sided(mesh, A, t["V"],
                                                       t["T"])
        r["wy_right"] = sl.dist_apply_wy_right(mesh, A, t["V"], t["T"])
        r["reduce_to_band"] = dist_reduce_to_band(mesh, A, 4)
        r["reduce_to_band_stepwise"] = dist_reduce_to_band_stepwise(
            mesh, A, 4)
        for block in (7, None):
            U = sl.dist_cholesky(mesh, t["SPD"], block)
            r[f"cholesky {block}"] = U
            r[f"trsm_left_t {block}"] = sl.dist_trsm_left_t(mesh, U, t["Bm"],
                                                            block)
            r[f"trsm_left {block}"] = sl.dist_trsm_left(mesh, U, t["Bm"],
                                                        block)
    d, e, x0 = _wilkinson()
    tl = tiling(mesh)
    c0 = dict(tl.counts)
    out["tt3"] = dist_tridiag_eig(mesh, d, e, torch.tensor(WILK_KS), x0=x0)
    out["tt3 collectives"] = {k: v - c0.get(k, 0) for k, v in
                              tl.counts.items() if v - c0.get(k, 0)}
    out["tt3 ranks"] = _gather_ranks(out["tt3"].lam.tolist())
    return out


@functools.lru_cache(maxsize=None)
def _la(shape):
    return launcher.run_local(_la_world, shape, "cpu", INPUTS)


SOLVE_CASES = [(n, v, prec, inv) for n in (48, 49) for v in ("KE", "TT")
               for prec in ("fp64", "mixed") for inv in (False, True)]


def _which(variant, invert):
    # the MD pencil's smallest end does not converge under KE without the
    # inverse-pair trick (as in the reference); KE takes the largest there
    return "largest" if variant == "KE" and not invert else "smallest"


def _solve_world(mesh, pencils, drill):
    from repro_torch.core import solve
    from repro_torch.dist.eigensolver import solve_ke_distributed
    torch.set_num_threads(1)
    out = {}
    for case in SOLVE_CASES:
        n, variant, precision, invert = case
        A, B = (torch.from_numpy(x) for x in pencils[n])
        res = solve(A, B, S, variant=variant, which=_which(variant, invert),
                    invert=invert, precision=precision, mesh=mesh,
                    max_restarts=300, device="cpu")
        keep = ("variant", "n_restart", "converged", "healthy", "fused",
                "collectives", "n_matvec", "mesh", "health", "refinement")
        out[case] = {"evals": res.evals, "X": res.X,
                     "info": {k: res.info[k] for k in keep
                              if k in res.info},
                     "ranks": _gather_ranks((
                         res.evals.tolist(), res.info.get("n_restart"),
                         res.info.get("converged"),
                         res.info["health"]["healthy"]))}
    A, B = (torch.from_numpy(x) for x in pencils[48])
    res = solve(A, B, S, variant="auto", mesh=mesh, invert=True)
    out["auto"] = {"variant": res.info["variant"],
                   "router": res.info["router"], "evals": res.evals}
    if drill:
        A, B = (torch.from_numpy(x) for x in pencils["drill"])
        lam, _, info = solve_ke_distributed(mesh, A, B, **DRILL_KW)
        out["drill"] = {"lam": lam, "info": info,
                        "ranks": _gather_ranks((lam.tolist(),
                                                info["n_restart"]))}
    return out


#: the preemption drill's arguments (tests/test_resilience.py:338-394)
DRILL_KW = dict(s=4, p=4, m=8, invert=True, max_restarts=200,
                return_info=True)


def _preempted_world(mesh, A, B, ckdir):
    """The drill's interrupted run: preempt after 2 restarts; every rank
    reports where it stopped before the error goes up."""
    from repro_torch.dist.eigensolver import solve_ke_distributed
    from repro_torch.resilience.faults import SimulatedPreemption
    torch.set_num_threads(1)
    try:
        solve_ke_distributed(mesh, torch.from_numpy(A), torch.from_numpy(B),
                             checkpoint_dir=ckdir, checkpoint_every=1,
                             preempt_after=2, **DRILL_KW)
    except SimulatedPreemption as err:
        err.ranks_at = _gather_ranks(err.at_restart)
        raise
    raise AssertionError("no preemption raised")


def _resumed_world(mesh, A, B, ckdir):
    from repro_torch.dist.eigensolver import solve_ke_distributed
    return solve_ke_distributed(mesh, torch.from_numpy(A),
                                torch.from_numpy(B), checkpoint_dir=ckdir,
                                resume=True, **DRILL_KW)


# ------------------------------------------------------- the references --

@pytest.fixture(scope="module")
def pencils():
    """The reference's MD pencils (n=48, 49; and md_like(48,
    PRNGKey(5)) for the drill) as numpy, with the JAX single-device TD
    solve's eigenvalues at both ends."""
    import jax
    from repro.core import solve as j_solve
    from repro.data.problems import md_like
    out, ref = {}, {}
    for n in (48, 49):
        p = md_like(n)
        out[n] = (np.array(p.A), np.array(p.B))
        for which in ("smallest", "largest"):
            ref[n, which] = np.array(j_solve(p.A, p.B, S, variant="TD",
                                             which=which).evals)
    p = md_like(48, key=jax.random.PRNGKey(5))
    out["drill"] = (np.array(p.A), np.array(p.B))
    return out, ref


@pytest.fixture(scope="module")
def solves(pencils):
    """shape -> the results of ``_solve_world`` on that mesh, one world a
    shape for the module."""
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = launcher.run_local(_solve_world, shape, "cpu",
                                              pencils[0], shape == (2, 1))
        return cache[shape]
    return get


_JAX_DIST = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    jax.config.update("jax_enable_x64", True)
    from repro.dist import sharded_la as sl
    from repro.dist.eigensolver import dist_reduce_to_band
    d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    A = d["A"]
    W, Q1 = dist_reduce_to_band(mesh, A, 4)
    out = {"symv": sl.dist_symv(mesh, A, d["x"]),
           "symv_rs": sl.dist_symv_rs(mesh, A, d["x"]),
           "gemm": sl.dist_gemm(mesh, A, d["Bm"]),
           "gemm_rs": sl.dist_gemm_rs(mesh, A, d["Bm"]),
           "syr2k": sl.dist_syr2k(mesh, A, d["V"], d["W"]),
           "panel_matmul": sl.dist_panel_matmul(mesh, A, d["V"]),
           "wy_two_sided": sl.dist_apply_wy_two_sided(mesh, A, d["V"],
                                                      d["T"]),
           "wy_right": sl.dist_apply_wy_right(mesh, A, d["V"], d["T"]),
           "reduce_to_band W": W, "reduce_to_band Q1": Q1}
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def jax_dist(tmp_path_factory):
    """The JAX ``dist_*`` at n=48 on a (2, 1) mesh of 2 forced host
    devices, in a subprocess (no device-count flag in this process)."""
    tmp = tmp_path_factory.mktemp("jax_dist")
    np.savez(tmp / "in.npz", **INPUTS[48])
    out = subprocess.run(
        [sys.executable, "-c", _JAX_DIST, str(tmp / "in.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu"),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _numpy_ref(op, d):
    A, V, T = d["A"], d["V"], d["T"]
    Q = np.eye(A.shape[0]) - V @ T @ V.T
    return {"symv": lambda: A @ d["x"], "symv_rs": lambda: A @ d["x"],
            "gemm": lambda: A @ d["Bm"], "gemm_rs": lambda: A @ d["Bm"],
            "syr2k": lambda: A - V @ d["W"].T - d["W"] @ V.T,
            "panel_matmul": lambda: A @ V,
            "wy_two_sided": lambda: Q.T @ A @ Q,
            "wy_right": lambda: A @ Q}[op]()


# ------------------------------------------------- (c) building blocks ----

PRODUCTS = ["symv", "symv_rs", "gemm", "gemm_rs", "syr2k", "panel_matmul",
            "wy_two_sided", "wy_right"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("op", PRODUCTS)
def test_products_against_the_reference(shape, op, jax_dist):
    """n=48 against the JAX dist_* at (2, 1), n=49 (which no JAX shard_map
    takes) against numpy: within 1e-12 of the result's scale."""
    got = _la(shape)
    for n, want in ((48, jax_dist[op]), (49, _numpy_ref(op, INPUTS[49]))):
        g = got[n][op].numpy()
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape", MESHES)
def test_reduce_to_band_against_the_reference(shape, jax_dist):
    """n=48: W and Q1 within 1e-11 ||C|| of the JAX dist_reduce_to_band at
    (2, 1). n=49 (padded to the row-block multiple): Q1^T C Q1 = W within
    1e-12 ||C||, Q1 orthogonal, off-band entries exactly zero; the
    stepwise baseline gives the same W (its triangles averaged)."""
    got = _la(shape)
    W, Q1 = (x.numpy() for x in got[48]["reduce_to_band"])
    scale = np.abs(INPUTS[48]["A"]).max()
    np.testing.assert_allclose(W, jax_dist["reduce_to_band W"], rtol=0,
                               atol=1e-11 * scale)
    np.testing.assert_allclose(Q1, jax_dist["reduce_to_band Q1"], rtol=0,
                               atol=1e-11)
    for n in (48, 49):
        C = INPUTS[n]["A"]
        W, Q1 = (x.numpy() for x in got[n]["reduce_to_band"])
        idx = np.arange(n)
        assert np.all(W[np.abs(idx[:, None] - idx[None, :]) > 4] == 0.0)
        np.testing.assert_allclose(Q1.T @ C @ Q1, W, rtol=0,
                                   atol=1e-12 * np.abs(C).max() * n)
        np.testing.assert_allclose(Q1.T @ Q1, np.eye(n), rtol=0, atol=1e-13)
        Ws, _ = (x.numpy() for x in got[n]["reduce_to_band_stepwise"])
        np.testing.assert_allclose(Ws, 0.5 * (W + W.T), rtol=0,
                                   atol=1e-12 * np.abs(C).max() * n)


@functools.lru_cache(maxsize=None)
def _blocked_bodies(n, block):
    """The reference's _chol_blocked, _trsm_lt_blocked and _trsm_l_blocked
    on INPUTS[n], unsharded, at ``block``."""
    import jax
    import jax.numpy as jnp
    from repro.dist.sharded_la import (_chol_blocked, _trsm_l_blocked,
                                       _trsm_lt_blocked)
    chol, lt, l = (jax.jit(functools.partial(f, block=block)) for f in
                   (_chol_blocked, _trsm_lt_blocked, _trsm_l_blocked))
    d = INPUTS[n]
    U = chol(jnp.asarray(d["SPD"]))
    return (np.array(U), np.array(lt(U, jnp.asarray(d["Bm"]))),
            np.array(l(U, jnp.asarray(d["Bm"]))))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("block", [7, None])
def test_cholesky_and_trsm_against_the_blocked_bodies(shape, block):
    """dist_cholesky, dist_trsm_left_t and dist_trsm_left against the
    reference's _chol_blocked, _trsm_lt_blocked and _trsm_l_blocked run
    unsharded with the same block (``_panel``'s default: one panel a row
    block, at least 16): within 1e-12 of the result's scale, U exactly
    upper triangular."""
    got = _la(shape)
    for n in (48, 49):
        U, Wt, X = _blocked_bodies(n, block or max(min(n // shape[0], 1024),
                                                   16))
        Ug = got[n][f"cholesky {block}"].numpy()
        assert np.all(np.tril(Ug, -1) == 0.0)
        for name, g, want in (("cholesky", Ug, U),
                              ("trsm_left_t", got[n][f"trsm_left_t {block}"],
                               Wt),
                              ("trsm_left", got[n][f"trsm_left {block}"], X)):
            np.testing.assert_allclose(np.asarray(g), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=name)


def _pod_world(mesh, d):
    from repro_torch.dist import sharded_la as sl
    from repro_torch.dist.mesh import tiling
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tl = tiling(mesh)
    U = sl.dist_cholesky(mesh, t["SPD"], 7)
    return (tl.R, tl.cm, sl.dist_symv(mesh, t["A"], t["x"]), U,
            sl.dist_trsm_left(mesh, U, t["Bm"], 7))


def test_a_pod_mesh_merges_its_row_axes():
    """A ("pod", "data", "model") mesh of (2, 1, 1): the row axes merge in
    mesh order into one row group of 2 (as the reference's ``_row_spec``);
    the product, the Cholesky and the backward solve at n=49 within
    1e-12 of numpy's scale."""
    d = INPUTS[49]
    R, cm, y, U, X = launcher.run_local(_pod_world, (2, 1, 1), "cpu", d,
                                        names=("pod", "data", "model"))
    assert (R, cm) == (2, 1)
    want = d["A"] @ d["x"]
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    U = U.numpy()
    np.testing.assert_allclose(U.T @ U, d["SPD"], rtol=0,
                               atol=1e-12 * np.abs(d["SPD"]).max())
    np.testing.assert_allclose(U @ X.numpy(), d["Bm"], rtol=0,
                               atol=1e-12 * np.abs(d["Bm"]).max())


# ------------------------------------------------------ (d) spectral TT3 --

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_dist_tridiag_eig_on_a_wilkinson_matrix(shape):
    """W21+'s 7 top eigenpairs split over 2 and 4 ranks (s padded to 8):
    the near-degenerate pairs (one cluster each) cross the index slices.
    Eigenvalues bit for bit the replicated ``eigh_tridiag_selected``'s on
    every rank; vectors with residual and orthogonality within 1e-13;
    1 + 3 collectives."""
    from repro_torch.core.tridiag_eig import (_cluster_ids, _scale,
                                              eigh_tridiag_selected)
    d, e, x0 = _wilkinson()
    got = _la(shape)
    ref = eigh_tridiag_selected(d, e, torch.tensor(WILK_KS), x0=x0)
    res = got["tt3"]
    assert torch.equal(res.lam, ref.lam)
    assert all(r == ref.lam.tolist() for r in got["tt3 ranks"])
    n_dev = shape[0] * shape[1]
    s_loc = -(-len(WILK_KS) // n_dev)
    cid = _cluster_ids(ref.lam, _scale(d, e)).tolist()
    assert any(cid[i - 1] == cid[i] for i in range(s_loc, len(cid), s_loc))
    T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    Z = res.Z
    assert float((T @ Z - Z * res.lam).abs().max()) <= 1e-13 * 10
    assert float((Z.T @ Z - torch.eye(len(WILK_KS),
                                      dtype=torch.float64)).abs().max()) \
        <= 1e-13
    assert got["tt3 collectives"] == {"tt3": 4}


# ------------------------------------------------- (e) solve(mesh=) -------

@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("case", SOLVE_CASES,
                         ids=["-".join(map(str, c)) for c in SOLVE_CASES])
def test_solve_on_a_mesh_against_the_reference(shape, case, solves,
                                               pencils):
    """KE (n=48 fused, n=49 replicated) and TT at fp64 and mixed, invert
    on and off: eigenvalues within 1e-10 max|lambda| of the JAX
    single-device solve's, the Table-3 bars by the reference's
    accuracy_report, healthy and converged; every rank returned the same
    eigenvalues (bit for bit) and verdicts."""
    import jax.numpy as jnp
    from repro.core.residuals import accuracy_report
    n, variant, precision, invert = case
    (A, B), want = pencils[0][n], pencils[1][n, _which(variant, invert)]
    got = solves(shape)[case]
    evals = got["evals"].numpy()
    np.testing.assert_allclose(evals, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    acc = accuracy_report(jnp.asarray(A), jnp.asarray(B),
                          jnp.asarray(got["X"].numpy()), jnp.asarray(evals))
    assert float(acc.relative_residual) <= TABLE3
    assert float(acc.b_orthogonality) <= TABLE3
    info = got["info"]
    assert info["variant"] == variant and info["mesh"] == list(shape)
    assert info["health"]["healthy"]
    if variant == "KE":
        assert info["converged"] and info["fused"] == (n == 48)
    if precision == "mixed":
        assert info["refinement"]["converged"]
    assert all(r == got["ranks"][0] for r in got["ranks"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_ke_on_a_mesh_issues_two_collectives_a_block_step(shape, solves):
    """The fused KE: exactly 2 matvec collectives per (n, p) block step
    (block steps from n_matvec / p) plus one verdict all-reduce a restart;
    the replicated path (n=49) issues neither."""
    fused = solves(shape)[(48, "KE", "fp64", True)]["info"]
    steps = fused["n_matvec"] // 4
    assert fused["collectives"]["matvec"] == 2 * steps
    assert fused["collectives"]["verdict"] == fused["n_restart"]
    rep = solves(shape)[(49, "KE", "fp64", True)]["info"]["collectives"]
    assert "matvec" not in rep and "verdict" not in rep


def test_auto_on_a_mesh_chooses_from_ke_and_tt(solves, pencils):
    got = solves((2, 1))["auto"]
    assert got["variant"] in ("KE", "TT")
    assert set(got["router"]["table"]) <= {"KE", "TT"}
    want = pencils[1][48, "smallest"]
    np.testing.assert_allclose(got["evals"].numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_mesh_rejects_what_it_does_not_implement(pencils):
    from repro_torch.core import solve
    A, B = (torch.from_numpy(x) for x in pencils[0][48])
    for kw in (dict(variant="TD"), dict(variant="KI"),
               dict(variant="KE", gs2="sygst"),
               dict(variant="KE", use_kernel=True)):
        with pytest.raises(NotImplementedError):
            launcher.run_local(_solve_one, (1, 1), "cpu", A, B, kw)


def _solve_one(mesh, A, B, kw):
    from repro_torch.core import solve
    return solve(A, B, S, mesh=mesh, **kw)


# ------------------------------------------- (f, g) the preemption drill --

def test_preemption_drill_resumes_on_a_smaller_mesh(solves, pencils,
                                                    tmp_path):
    """tests/test_resilience.py:338-394 with its arguments: md_like(48,
    PRNGKey(5)), s=4, p=4, m=8, invert, 200 restarts. Preempted after 2
    restarts on (2, 1) (every rank at the same restart), resumed on
    plan_remesh(1, 1)'s mesh: healthy, resumed_from >= 0, eigenvalues
    within 1e-12 of the uninterrupted (2, 1) run's."""
    from repro_torch.dist.elastic import plan_remesh
    from repro_torch.resilience.faults import SimulatedPreemption
    A, B = pencils[0]["drill"]
    ref = solves((2, 1))["drill"]
    assert ref["info"]["healthy"] and ref["info"]["converged"]
    assert all(r == ref["ranks"][0] for r in ref["ranks"])
    ckdir = str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption) as err:
        launcher.run_local(_preempted_world, (2, 1), "cpu", A, B, ckdir)
    assert err.value.ranks_at == [1, 1]
    plan = plan_remesh(1, 1)
    lam2, _, info2 = launcher.run_local(_resumed_world, plan.new_shape,
                                        "cpu", A, B, ckdir)
    assert info2["healthy"] and info2["resumed_from"] >= 0
    assert float((lam2 - ref["lam"]).abs().max()) < 1e-12


# ------------------------------------------------------------- (h) CLI ----

@pytest.mark.parametrize("variant", ["KE", "TT"])
def test_eigsolve_cli_on_a_two_rank_mesh(variant, monkeypatch):
    """``eigsolve --mesh 2x1 --devices 2 --device cpu``: the payload reports
    the mesh, meets the Table-3 bars and the exact spectrum."""
    from repro_torch.launch import eigsolve
    argv = ["eigsolve", "--problem", "md", "--n", "48", "--s", "4",
            "--variant", variant, "--mesh", "2x1", "--devices", "2",
            "--device", "cpu", "--json"] + (["--invert"] if variant == "KE"
                                             else [])
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["mesh"] == "2x1" and payload["n_devices"] == 2
    assert payload["variant"] == variant and payload["health"]["healthy"]
    assert payload["relative_residual"] <= TABLE3
    assert payload["b_orthogonality"] <= TABLE3
    assert payload["max_abs_eval_error"] <= 1e-10


@pytest.mark.parametrize("argv,match", [
    (["--devices", "2"], "--mesh"),
    (["--mesh", "2x1", "--devices", "3"], "does not fill"),
    (["--mesh", "2x1", "--variant", "TD"], "KE, TT"),
    (["--mesh", "2"], "DATAxMODEL")])
def test_eigsolve_cli_rejects_bad_meshes(argv, match, monkeypatch):
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", ["eigsolve", "--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match=match):
        eigsolve.main()
