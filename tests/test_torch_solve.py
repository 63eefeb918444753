"""The TD, TT, KE and KI solves of the PyTorch port against
``repro.core.solve``, on the CPU.

The reference's pencils and random starts (TD2's inverse-iteration block,
the Lanczos start block and the filter probe) are carried across
(``repro_torch.interop``); both results are scored by the reference's own
``accuracy_report`` against the shared Table-3 bars.
Also: failure containment, the device rule, the CLI, and import hygiene
(the port and ``chip_smoke.py`` import neither JAX nor ``repro``).
"""
import ast
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import accuracy_report
from repro.core import solve as j_solve
from repro.data.problems import dft_like, md_like
from repro_torch.core import gsyeig
from repro_torch.core import solve
from repro_torch.interop import problem_from_numpy, start_block_from_numpy
from repro_torch.resilience.recovery import SolverError

ROOT = Path(__file__).resolve().parents[1]
N, S = 64, 6
TABLE3 = {"relative_residual": 1e-12, "b_orthogonality": 1e-12}
#: every kernel instance's launches in a CPU solve (the fp32 and bf16
#: instances of the families that have them, beside each fp64 one)
_REDUCED = ("symv", "symm_block", "house_panel", "syr2k", "rot_apply",
            "chase_pass", "replay_pass")
NO_LAUNCHES = {"bisect_sturm": 0, "invit": 0, "symv": 0, "symm_block": 0,
               "house_panel": 0, "syr2k": 0, "rot_apply": 0, "chase_pass": 0,
               "replay_pass": 0, "gemm": 0, "trsm_tile": 0, "band_mv": 0,
               **{f"{k}_{s}": 0 for k in _REDUCED for s in ("fp32", "bf16")}}
CASES = [("md", "smallest", False), ("md", "largest", False),
         ("dft", "smallest", False), ("dft", "largest", False),
         ("md", "smallest", True)]


def _pencil(name):
    p = (md_like if name == "md" else dft_like)(N)
    return p, problem_from_numpy(p.A, p.B, p.exact_evals, p.name,
                                 device="cpu")


def _reference_x0(n, s):
    # the block the reference's TD2 draws: PRNGKey(20120520), sorted ks
    return np.array(jax.random.normal(jax.random.PRNGKey(20120520), (n, s),
                                      jnp.float64))


def _reference_krylov_starts(n, p):
    # what the reference's lanczos_solve draws from PRNGKey(20120520): the
    # (n, p) start block, and the filter probe from fold_in(key, 2)
    key = jax.random.PRNGKey(20120520)
    v0 = np.array(jax.random.normal(key, (n, p), jnp.float64))
    probe = np.array(jax.random.normal(jax.random.fold_in(key, 2), (n,),
                                       jnp.float64))
    return (start_block_from_numpy(v0, "cpu"),
            start_block_from_numpy(probe, "cpu"))


def _table3(p, X, lam):
    acc = accuracy_report(p.A, p.B, jnp.asarray(X), jnp.asarray(lam))
    assert float(acc.relative_residual) <= TABLE3["relative_residual"]
    assert float(acc.b_orthogonality) <= TABLE3["b_orthogonality"]


@pytest.mark.parametrize("problem,which,invert", CASES)
def test_td_solve_parity(problem, which, invert):
    p, tp = _pencil(problem)
    ref = j_solve(p.A, p.B, S, variant="TD", which=which, invert=invert)
    res = solve(tp.A, tp.B, S, variant="TD", which=which, invert=invert,
                x0=start_block_from_numpy(_reference_x0(N, S), "cpu"),
                device="cpu")
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs(ev - ev_ref).max() <= 1e-12 * np.abs(ev_ref).max()
    assert np.abs((ev - ev_ref) / ev_ref).max() <= 1e-12
    for X, lam in ((res.X.numpy(), ev), (np.asarray(ref.X), ev_ref)):
        acc = accuracy_report(p.A, p.B, jnp.asarray(X), jnp.asarray(lam))
        assert float(acc.relative_residual) <= TABLE3["relative_residual"]
        assert float(acc.b_orthogonality) <= TABLE3["b_orthogonality"]
    exact = np.asarray(p.exact_evals)
    want = exact[:S] if which == "smallest" else exact[-S:]
    assert np.abs(ev - want).max() <= 1e-10 * np.abs(exact).max()
    assert set(res.stage_times) == {"GS1", "GS2", "TD1", "TD2", "TD3",
                                    "BT1", "Tot."}
    assert res.info["health"]["healthy"]


@pytest.mark.parametrize("problem,which,invert", CASES)
def test_tt_solve_parity(problem, which, invert):
    p, tp = _pencil(problem)
    ref = j_solve(p.A, p.B, S, variant="TT", which=which, invert=invert)
    # TT3 draws the same start block as TD2 in the reference
    res = solve(tp.A, tp.B, S, variant="TT", which=which, invert=invert,
                x0=start_block_from_numpy(_reference_x0(N, S), "cpu"),
                device="cpu")
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs(ev - ev_ref).max() <= 1e-12 * np.abs(ev_ref).max()
    # vectors after fixing each column's sign: a vector moves by about
    # u ||C|| / gap, and the MD low end is clustered (gaps ~1e-3 ||C||)
    X, X_ref = res.X.numpy(), np.asarray(ref.X)
    sign = np.where(np.sum(X * X_ref, axis=0) < 0, -1.0, 1.0)
    assert np.abs(X * sign - X_ref).max() <= 1e-10
    _table3(p, X, ev)
    _table3(p, X_ref, ev_ref)
    exact = np.asarray(p.exact_evals)
    want = exact[:S] if which == "smallest" else exact[-S:]
    assert np.abs(ev - want).max() <= 1e-10 * np.abs(exact).max()
    assert set(res.stage_times) == set(ref.stage_times) == {
        "GS1", "GS2", "TT1", "TT2", "TT3", "TT4", "BT1", "Tot."}
    assert res.info["tt1"]["n_chunks"] == ref.info["tt1"]["n_chunks"]
    assert res.info["tt1"]["kernel_launches"] == {"house_panel": 0,
                                                  "syr2k": 0}
    assert res.info["health"] == ref.info["health"]


KRYLOV_CASES = [
    ("md", 128, 6, "KE", dict(invert=True)),
    ("md", 128, 6, "KI", dict(invert=True)),
    ("md", 128, 6, "KE", dict(invert=True, krylov_block=4)),
    ("md", 96, 4, "KE", dict(invert=True, use_kernel=True)),
    ("md", 96, 4, "KI", dict(invert=True, use_kernel=True)),
    # the DFT largest end reaches the eps * |theta| floor slowly: at other
    # (n, s) the two packages cross it a restart apart, from rounding
    # (tests/test_torch_lanczos.py shows it at n=64, s=4)
    ("dft", 64, 6, "KE", dict(which="largest")),
]


@pytest.mark.parametrize("problem,n,s,variant,kw", KRYLOV_CASES)
def test_krylov_solve_parity(problem, n, s, variant, kw):
    p = (md_like if problem == "md" else dft_like)(n)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    # the reference's use_kernel runs the Pallas kernel in interpret mode;
    # its default XLA dot is the same product
    ref = j_solve(p.A, p.B, s, variant=variant,
                  **{k: v for k, v in kw.items() if k != "use_kernel"})
    v0, probe = _reference_krylov_starts(n, kw.get("krylov_block", 1))
    res = solve(tp.A, tp.B, s, variant=variant, v0=v0, probe_v0=probe,
                device="cpu", **kw)
    assert res.info["converged"] and ref.info["converged"]
    assert (res.info["n_matvec"], res.info["n_restart"]) == (
        ref.info["n_matvec"], ref.info["n_restart"])
    assert res.info["krylov"] == ref.info["krylov"]
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs((ev - ev_ref) / ev_ref).max() <= 1e-12
    _table3(p, res.X.numpy(), ev)
    _table3(p, ref.X, ev_ref)
    exact = np.asarray(p.exact_evals)
    want = exact[-s:] if kw.get("which") == "largest" else exact[:s]
    assert np.abs(ev - want).max() <= 1e-10 * np.abs(exact).max()
    keys = {"KE": {"GS1", "GS2", "KE_iter", "BT1", "Tot."},
            "KI": {"GS1", "KI_iter", "BT1", "Tot."}}[variant]
    assert set(res.stage_times) == keys == set(ref.stage_times)
    assert res.info["health"] == ref.info["health"]


def test_filtered_ke_on_the_clustered_dft_end_matches_the_reference():
    # the clustered end at the converging tol and the default degree-16
    # filter: the counts and the values agree; at tol=1e-9 neither package
    # meets the 1e-12 residual bar, so it is not asserted
    p = dft_like(64)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    ref = j_solve(p.A, p.B, 4, variant="KE", clustered=True, tol=1e-9)
    v0, probe = _reference_krylov_starts(64, 1)
    res = solve(tp.A, tp.B, 4, variant="KE", clustered=True, tol=1e-9,
                v0=v0, probe_v0=probe, device="cpu")
    assert res.info["krylov"] == ref.info["krylov"] == {"p": 1,
                                                        "filter_degree": 16}
    assert (res.info["n_matvec"], res.info["n_restart"]) == (
        ref.info["n_matvec"], ref.info["n_restart"])
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs((ev - ev_ref) / ev_ref).max() <= 1e-12
    assert np.abs(ev - np.asarray(p.exact_evals)[:4]).max() <= 1e-12


def test_krylov_info_is_json_clean():
    _, tp = _pencil("md")
    res = solve(tp.A, tp.B, 3, variant="KI", invert=True, use_kernel=True,
                device="cpu")
    info = json.loads(json.dumps(res.info))
    assert info["krylov"] == {"p": 1, "filter_degree": 0}
    assert info["converged"] is True
    assert isinstance(info["n_matvec"], int) and info["n_matvec"] > 0
    assert len(info["resid_bounds"]) == 3
    assert all(isinstance(r, float) for r in info["resid_bounds"])
    assert info["health"]["stages"] == {"GS1": True, "KI_iter": True,
                                        "OUT": True}
    assert info["kernel_launches"] == NO_LAUNCHES


def test_unconverged_krylov_warns():
    p, tp = _pencil("md")
    ref = j_solve(p.A, p.B, 3, variant="KE", invert=True, max_restarts=1)
    res = solve(tp.A, tp.B, 3, variant="KE", invert=True, max_restarts=1,
                device="cpu")
    assert not res.info["converged"] and not ref.info["converged"]
    assert res.info["warnings"] == ref.info["warnings"]
    assert res.info["health"]["healthy"]


def test_info_is_json_clean():
    _, tp = _pencil("md")
    res = solve(tp.A, tp.B, 3, device="cpu")
    info = json.loads(json.dumps(res.info))
    assert info["variant"] == "TD" and info["device"] == "cpu"
    assert info["kernel_launches"] == NO_LAUNCHES
    assert info["recovery"] == []
    assert info["health"]["stages"] == {"GS1": True, "GS2": True,
                                        "TD1": True, "OUT": True}


def test_default_start_block_is_reproducible():
    _, tp = _pencil("dft")
    a = solve(tp.A, tp.B, 4, device="cpu")
    b = solve(tp.A, tp.B, 4, device="cpu")
    assert torch.equal(a.X, b.X)


# ------------------------------------------------------- failure handling --

def test_non_spd_b_is_a_cholesky_breakdown():
    _, tp = _pencil("md")
    B = tp.B.clone()
    B[5, 5] = -10.0
    with pytest.raises(SolverError) as ei:
        solve(tp.A, B, 3, device="cpu")
    diag = ei.value.diagnosis
    assert diag["reason"] == "cholesky_breakdown" and diag["stage"] == "GS1"
    assert [r["outcome"] for r in diag["recovery"]] == ["failed"] * 3
    json.dumps(diag)


def test_roundoff_indefinite_b_is_rescued_by_the_first_shift():
    p, tp = _pencil("md")
    B = np.eye(N)
    B[0, 0] = -1e-16
    ref = j_solve(p.A, jnp.asarray(B), 3, variant="TD")
    res = solve(tp.A, torch.from_numpy(B), 3, device="cpu")
    assert res.info["gs1_shift"] == ref.info["gs1_shift"] == 1e-14
    assert res.info["recovery"] == ref.info["recovery"]


def test_nonfinite_a_fails_gs2_and_retries_under_recover():
    _, tp = _pencil("md")
    A = tp.A.clone()
    A[2, 3] = float("nan")
    with pytest.raises(SolverError) as ei:
        solve(A, tp.B, 3, device="cpu")
    assert ei.value.diagnosis["stage"] == "GS2"
    assert ei.value.diagnosis["reason"] == "nonfinite_stage"
    with pytest.raises(SolverError) as ei:
        solve(A, tp.B, 3, device="cpu", on_failure="recover", max_retries=2)
    trail = ei.value.diagnosis["recovery"]
    assert [r["action"] for r in trail] == ["transient_retry"] * 2
    res = solve(A, tp.B, 3, device="cpu", on_failure="ignore")
    assert not res.info["health"]["healthy"]
    assert res.info["health"]["first_unhealthy_stage"] == "GS2"


def test_nonfinite_a_poisons_ki_iter_and_retries_under_recover():
    # KI has no GS2 sentinel: the Lanczos health verdict catches it
    _, tp = _pencil("md")
    A = tp.A.clone()
    A[2, 3] = float("nan")
    with pytest.raises(SolverError) as ei:
        solve(A, tp.B, 3, variant="KI", device="cpu")
    assert ei.value.diagnosis["stage"] == "KI_iter"
    assert ei.value.diagnosis["reason"] == "nonfinite_stage"
    with pytest.raises(SolverError) as ei:
        solve(A, tp.B, 3, variant="KI", filter=4, on_failure="recover",
              device="cpu")
    assert [r["action"] for r in ei.value.diagnosis["recovery"]] == [
        "transient_retry"] * 2
    res = solve(A, tp.B, 3, variant="KI", on_failure="ignore", device="cpu")
    assert res.info["health"]["first_unhealthy_stage"] == "KI_iter"
    assert res.info["n_restart"] == 1


@pytest.mark.parametrize("kw", [dict(variant="auto"),
                                # the router prices each precision level
                                dict(variant="auto", precision="mixed")])
def test_unported_options_raise(kw):
    """The options this test once saw raise (``variant="auto"``, the one
    the port refused) now run: the router's decision is the reference's,
    and the solve is the chosen variant's."""
    p, tp = _pencil("md")
    ref = j_solve(p.A, p.B, 3, **kw)
    res = solve(tp.A, tp.B, 3, device="cpu", **kw)
    assert res.info["router"]["variant"] == ref.info["router"]["variant"]
    assert res.info["variant"] == ref.info["variant"]
    for v, t in ref.info["router"]["table"].items():
        assert res.info["router"]["table"][v] == pytest.approx(t, rel=1e-12)
    json.dumps(res.info)
    _table3(p, res.X.numpy(), res.evals.numpy())


def test_unconverged_krylov_escalates_under_recover():
    n = 96
    p = md_like(n)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    ref = j_solve(p.A, p.B, 4, variant="KE", invert=True, max_restarts=1,
                  on_failure="recover")
    v0, probe = _reference_krylov_starts(n, 1)
    res = solve(tp.A, tp.B, 4, variant="KE", invert=True, max_restarts=1,
                on_failure="recover", v0=v0, probe_v0=probe, device="cpu")
    assert res.info["recovery"] == ref.info["recovery"] == [
        {"action": "escalate_krylov", "stage": "KE_iter",
         "outcome": "recovered",
         "params": {"max_restarts": 4, "filter_degree": 16}}]
    assert res.info["converged"]
    assert (res.info["n_matvec"], res.info["n_restart"]) == (
        ref.info["n_matvec"], ref.info["n_restart"])
    _table3(p, res.X.numpy(), res.evals.numpy())


def test_failed_escalation_raises_for_the_tt_fallback():
    # a failed escalate_krylov rung raises the TT fallback rung, as in the
    # reference: the recovery trail is the reference's, action by action
    p, tp = _pencil("dft")
    ref = j_solve(p.A, p.B, 4, variant="KE", max_restarts=3,
                  on_failure="recover")
    res = solve(tp.A, tp.B, 4, variant="KE", max_restarts=3,
                on_failure="recover", device="cpu")
    assert res.info["recovery"] == ref.info["recovery"] == [
        {"action": "escalate_krylov", "stage": "KE_iter",
         "outcome": "failed",
         "params": {"max_restarts": 12, "filter_degree": 16}},
        {"action": "fallback_variant", "stage": "KE_iter",
         "outcome": "recovered", "params": {"variant": "TT"}}]
    assert res.info["variant"] == ref.info["variant"] == "TT"
    json.dumps(res.info)
    _table3(p, res.X.numpy(), res.evals.numpy())
    exact = np.asarray(p.exact_evals)
    assert np.abs(res.evals.numpy() - exact[:4]).max() <= (
        1e-10 * np.abs(exact).max())


# ------------------------------------------------------------ device rule --

def test_solve_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _pencil("md")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve(tp.A, tp.B, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve(tp.A, tp.B, 3, device="cuda")
    assert solve(tp.A, tp.B, 3, device="cpu").evals.shape == (3,)


def test_cli_payload(monkeypatch):
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", ["eigsolve", "--problem", "md", "--n",
                                      "40", "--s", "3", "--device", "cpu",
                                      "--json"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["variant"] == "TD" and payload["device"] == "cpu"
    assert payload["relative_residual"] <= 1e-12
    assert payload["b_orthogonality"] <= 1e-12
    assert payload["max_abs_eval_error"] <= 1e-10
    assert payload["kernel_launches"] == NO_LAUNCHES
    assert set(payload["stage_times_s"]) == {"GS1", "GS2", "TD1", "TD2",
                                             "TD3", "BT1", "Tot."}


def test_cli_payload_tt(monkeypatch):
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", [
        "eigsolve", "--problem", "md", "--n", "64", "--s", "4", "--variant",
        "TT", "--band-width", "6", "--device", "cpu", "--json"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["variant"] == "TT" and payload["device"] == "cpu"
    assert payload["relative_residual"] <= 1e-12
    assert payload["b_orthogonality"] <= 1e-12
    assert payload["max_abs_eval_error"] <= 1e-10
    assert payload["kernel_launches"] == NO_LAUNCHES
    assert set(payload["stage_times_s"]) == {"GS1", "GS2", "TT1", "TT2",
                                             "TT3", "TT4", "BT1", "Tot."}


def test_cli_payload_krylov(monkeypatch):
    from repro_torch.launch import eigsolve
    monkeypatch.setattr(sys, "argv", [
        "eigsolve", "--problem", "md", "--n", "64", "--s", "4", "--variant",
        "KE", "--invert", "--p", "2", "--device", "cpu", "--json"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        eigsolve.main()
    payload = json.loads(buf.getvalue())
    assert payload["variant"] == "KE" and payload["n_matvec"] > 0
    assert payload["relative_residual"] <= 1e-12
    assert payload["b_orthogonality"] <= 1e-12
    assert payload["max_abs_eval_error"] <= 1e-10
    assert set(payload["stage_times_s"]) == {"GS1", "GS2", "KE_iter", "BT1",
                                             "Tot."}


# --------------------------------------------------------- import hygiene --

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _banned(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _banned(node.module or ""):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_solve_signature_keeps_the_reference_defaults():
    assert gsyeig.VARIANTS == ("TD", "TT", "KE", "KI")
    assert gsyeig.SOLVE_SEED == 20120520
