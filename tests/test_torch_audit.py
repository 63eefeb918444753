"""The port's audit (``repro_torch.analysis.static_audit``,
``repro_torch.launch.audit``) on the CPU.

Three layers, as the reference's ``tests/test_static_audit.py``:

* **contract machinery**: a seeded precision leak the lint must catch, a
  clean program that passes the same contract, an impossible budget that
  must fail (and make the CLI exit nonzero, as a leak does), the wrappers'
  signature parity, the bucket cache;
* **golden profiles**: the whole audit run by the CLI (``--device cpu``,
  the mesh entries on a 2-rank gloo world) and its KE restart, band sweep
  and TT3 collective structures, its cross-check with the cost model;
* **parity with the reference's numbers**: its ``contracts.py`` cannot be
  imported on this jax (``profile.py`` imports ``jax.core.ClosedJaxpr``),
  so its literal constants, ``AuditSpec`` defaults and budget functions
  are read with ``ast``; and the ``dispatch_count`` hooks of
  ``core.lanczos`` and ``core.sbr`` against the reference's on the same
  inputs (the counterparts of ``tests/test_lanczos_and_solve.py``'s
  dispatch tests and ``tests/test_house_panel.py``'s TT1 test).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lanczos as jl
from repro.core import sbr as jsbr
from repro_torch.analysis.static_audit import (
    AuditEntry, AuditSpec, BudgetContract, KE_COLLECTIVES_PER_BLOCK_STEP,
    ProgramSpec, TT1_COLLECTIVES_PER_PANEL, check_all, check_entry,
    clear_registry,
    contracts, entries, get_entry, lint_signature_parity, profile_fn, tt3_dist_collectives)
from repro_torch.analysis.static_audit.kernel_lint import errors
from repro_torch.core import lanczos as tl
from repro_torch.core import sbr
from repro_torch.kernels import _launches
from repro_torch.kernels.symv import ops as symv_ops
from repro_torch.launch import audit as audit_cli

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro" / "analysis" / "static_audit"
KEY = jax.random.PRNGKey(20120520)


# --------------------------------------------------------------------------
# contract machinery
# --------------------------------------------------------------------------

def _entry(fn, args, contract, name="synthetic"):
    return AuditEntry(name=name,
                      build=lambda: [ProgramSpec(name=name, fn=fn,
                                                 args=args)],
                      contract=contract)


def _leaky(x):
    return (x.to(torch.float32) * 2).to(torch.float64)


def test_seeded_precision_leak_is_caught():
    """The lint would catch the classic accidental demotion: a float32
    round trip inside an fp64 program."""
    x = torch.zeros((4, 4), dtype=torch.float64)
    prof = profile_fn(_leaky, x)
    assert prof.f64_downcasts() == {"float64->float32": 1}
    assert prof.converts["float32->float64"] == 1
    rep = check_entry(_entry(_leaky, (x,), BudgetContract(
        forbid_f64_downcasts=True)))
    assert not rep.ok
    assert any("precision leak" in v for v in rep.violations)
    assert any("float32" in v and "outside allowed set" in v
               for v in rep.violations)
    # declared, the same demotion is policy, not a leak
    rep = check_entry(_entry(_leaky, (x,), BudgetContract(
        declared_downcasts=("float64->float32",),
        allowed_dtypes=contracts.MIXED_ALLOWED_DTYPES)))
    assert rep.ok, rep.violations


def test_clean_program_passes_same_contract():
    x = torch.zeros((4, 4), dtype=torch.float64)
    rep = check_entry(_entry(lambda x: x * 2.0, (x,), BudgetContract(
        exact_collectives=0, max_host_reads=0, forbid_f64_downcasts=True)))
    assert rep.ok, rep.violations


def test_impossible_budget_fails():
    A = torch.eye(8, dtype=torch.float64)
    x = torch.ones(8, dtype=torch.float64)
    rep = check_entry(_entry(symv_ops.symv, (A, x), BudgetContract(
        exact_kernel_calls={"symv": 0}, exact_collectives=999,
        max_stage_entries={"sbr": 0})))
    assert not rep.ok
    assert any("kernel calls symv 1 != pinned 0" in v
               for v in rep.violations)
    assert any("!= pinned 999" in v for v in rep.violations)


def test_host_reads_and_isfinite_sites_are_counted():
    """``.item()``, ``bool()`` and ``.tolist()`` are host reads on any
    device; ``torch.isfinite`` is a site (a composite op no dispatch mode
    sees)."""
    def prog(x):
        ok = torch.isfinite(x).all()
        return bool(ok), x.sum().item(), x.tolist()
    prof = profile_fn(prog, torch.ones(3, dtype=torch.float64))
    assert prof.host_reads == 3
    assert prof.isfinite_sites == 1
    assert prof.kernel_calls == {} and prof.launches == {}


def test_recording_is_off_outside_a_profile():
    """Notes cost nothing and count nothing with no recording active, and
    the launch counters stay the kernels' own."""
    assert not _launches.recording_active()
    A = torch.eye(8, dtype=torch.float64)
    symv_ops.symv(A, torch.ones(8, dtype=torch.float64))
    with _launches.recording() as rec:
        symv_ops.symv(A, torch.ones(8, dtype=torch.float64))
        symv_ops.symm_block(A.float(), torch.ones((8, 2)))
    assert rec.calls == {"symv": 1, "symm_block_fp32": 1}
    assert not _launches.recording_active()


def _cli(argv):
    return audit_cli.main(["--device", "cpu", "--devices", "1", "-o", ""]
                          + argv)


def test_cli_exits_nonzero_on_a_leak_and_an_impossible_contract(
        monkeypatch, capsys):
    """An undeclared float64 -> float32 demotion, and a contract no run
    can meet, each make ``launch.audit`` exit 1 and print AUDIT FAILED."""
    x = torch.zeros((4, 4), dtype=torch.float64)
    real = audit_cli.register_all

    def with_faults(spec=None, device=None):
        spec = real(spec, device)
        contracts.register(_entry(_leaky, (x,), BudgetContract(),
                                  name="test/leak"))
        contracts.register(_entry(
            symv_ops.symv, (torch.eye(4, dtype=torch.float64),
                            torch.ones(4, dtype=torch.float64)),
            BudgetContract(exact_kernel_calls={"symv": 2}),
            name="test/impossible"))
        return spec

    monkeypatch.setattr(audit_cli, "register_all", with_faults)
    try:
        assert _cli(["--entry", "test/leak"]) == 1
        out = capsys.readouterr().out
        assert "precision leak" in out
        assert out.rstrip().endswith("AUDIT FAILED")
        assert _cli(["--entry", "test/impossible"]) == 1
        out = capsys.readouterr().out
        assert "kernel calls symv 1 != pinned 2" in out
        assert out.rstrip().endswith("AUDIT FAILED")
        assert _cli(["--entry", "kernels/symv"]) == 0
        assert capsys.readouterr().out.rstrip().endswith("AUDIT PASSED")
    finally:
        # the registry without the faulty entries
        clear_registry()
        real(device="cpu")


def test_check_all_runs_the_kernel_entries():
    """``check_all`` by tag: the eight kernel families' entries, each one
    call of its instance on the CPU branch, no launch there."""
    contracts.register_all(device="cpu")
    reports = check_all(tags=["kernels"])
    assert [r.name for r in reports] == [
        f"kernels/{k}" for k in ("gemm", "symv", "syr2k", "trsm", "band_mv",
                                 "rot_apply", "house_panel", "tridiag_eig")]
    for r in reports:
        assert r.ok, (r.name, r.violations)
        assert sum(r.kernel_calls.values()) == 1
        assert all(p.launches == {} for p in r.profiles)


def test_the_card_is_the_default_device(monkeypatch):
    """``register_all`` and ``run_audit`` run on the card unless asked for
    the CPU (no CUDA raises), and every entry records its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        contracts.register_all()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        audit_cli.run_audit(entry="kernels/symv")
    contracts.register_all(device="cpu")
    assert {e.device for e in entries()} == {"cpu"}


def test_the_profile_reads_its_device_from_the_tensors():
    """A profile's device is where its tensors were, whatever the entry
    says; an entry registered for the card whose program ran on the host
    is a violation (on the card the launch-delta check could not be
    skipped by a wrong label)."""
    x = torch.ones(4, dtype=torch.float64)
    assert profile_fn(lambda t: t * 2, x).device == "cpu"
    entry = AuditEntry(name="on-host", build=lambda: [ProgramSpec(
        name="double", fn=lambda t: t * 2, args=(x,))],
        contract=BudgetContract(), device="cuda")
    rep = check_entry(entry)
    assert rep.violations == ["double: registered for cuda, ran on cpu"]


def test_quick_leaves_out_the_buckets():
    contracts.register_all(device="cpu")
    quick = {e.name for e in entries(["quick"])}
    every = {e.name for e in entries()}
    assert len(every) == 28
    assert every - quick == {e for e in every
                             if e.startswith("serve/solve_batched_")}
    assert len(every - quick) == 10


def test_a_missing_stage_sentinel_fails_the_audit(monkeypatch):
    """Each of GS1 and GS2 must carry its own isfinite site: with GS2's
    ``array_finite`` verdict taken out of ``_gs2_trsm_fused`` the entry
    fails, although GS1's ``chol_health`` has two sites of its own."""
    from repro_torch.core import gsyeig
    contracts.register_all(device="cpu")
    entry = get_entry("resilience/stage_sentinels")
    assert check_entry(entry).ok
    monkeypatch.setattr(gsyeig, "array_finite",
                        lambda *a: torch.ones((), dtype=torch.bool))
    rep = check_entry(entry)
    assert not rep.ok
    assert rep.isfinite_sites >= 2
    assert any("['gs2_trsm_sentinel']" in v and "isfinite" in v
               for v in rep.violations), rep.violations


def _bucket_profiles(warm_replays, graph_launches, cold_calls):
    from repro_torch.analysis.static_audit.profile import ProgramProfile
    base = dict(cache_hit=False, pipelines_built=0, programs_built=0,
                path="cuda_graphs", graphs=2, graph_launches=graph_launches,
                graph_replays={"krylov_init": 1, "krylov_restart": 3})
    cold = ProgramProfile(name="cold", device="cuda:0",
                          kernel_calls=cold_calls, extra=base)
    warm = ProgramProfile(name="warm", device="cuda:0", extra=dict(
        base, cache_hit=True, graph_replays=warm_replays))
    return [cold, warm]


def test_bucket_reuse_holds_the_warm_replays():
    """The second call of a bucket must run the first call's pieces, as
    often, and on the card from graphs that launch what the first call
    recorded: a warm call that replayed nothing, or graphs missing a
    piece or launching other kernels, fail."""
    from repro_torch.analysis.static_audit.registry import _check_reuse
    graphs = {"krylov_init": {"symm_block": 1},
              "krylov_restart": {"symm_block": 2}}
    same = {"krylov_init": 1, "krylov_restart": 3}
    assert _check_reuse(_bucket_profiles(same, graphs,
                                         {"symm_block": 9})) == []
    viol = _check_reuse(_bucket_profiles({}, graphs, {"symm_block": 9}))
    assert any("ran no piece" in v for v in viol)
    assert any("the first {" in v for v in viol)
    viol = _check_reuse(_bucket_profiles(
        same, {"krylov_init": {"symm_block": 1}}, {"symm_block": 9}))
    assert any("1 captured graph(s) for the program's 2" in v for v in viol)
    assert any("without a captured graph: ['krylov_restart']" in v
               for v in viol)
    viol = _check_reuse(_bucket_profiles(same, graphs, {"gemm": 9}))
    assert any("the graphs launch ['symm_block'], the first call recorded "
               "['gemm']" in v for v in viol)
    viol = _check_reuse(_bucket_profiles(same, graphs, {"symm_block": 2}))
    assert any("captured launches above" in v for v in viol)


def test_kernel_signature_parity_holds():
    findings = lint_signature_parity()
    assert errors(findings) == [], [f.detail for f in errors(findings)]
    assert not findings, [f.detail for f in findings]


def test_same_bucket_hits_pipeline_cache():
    from repro_torch.core import batched
    kwargs = dict(band_width=4, m=12, max_restarts=8, p=2)
    pipe1, key1 = batched.get_pipeline(32, 3, "KE", "smallest", **kwargs)
    before = batched.cache_stats()
    pipe2, key2 = batched.get_pipeline(32, 3, "KE", "smallest", **kwargs)
    after = batched.cache_stats()
    assert key1 == key2
    assert pipe2 is pipe1, "identical bucket rebuilt"
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    # a different bucket does not alias the cached one
    pipe3, key3 = batched.get_pipeline(32, 3, "KE", "largest", **kwargs)
    assert key3 != key1 and pipe3 is not pipe1


# --------------------------------------------------------------------------
# golden profiles (the CLI, the mesh entries on a 2-rank gloo world)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audit_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "AUDIT_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.audit", "--device", "cpu",
         "--json", "-o", str(out)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = json.loads(proc.stdout)
    assert json.loads(out.read_text()) == payload
    return payload


def _entry_of(report, name):
    return next(e for e in report["entries"] if e["name"] == name)


def test_audit_payload_overall_ok(audit_report):
    assert audit_report["ok"], audit_report["summary"]
    s = audit_report["summary"]
    assert s["entries"] == 28 and s["skipped"] == 0
    assert s["budget_violations"] == 0
    assert s["precision_leaks"] == 0
    assert s["crosscheck_failures"] == 0
    assert audit_report["mesh"] == [2, 1]
    assert audit_report["sentinels"]["ok"]
    assert audit_report["sentinels"]["extra_dispatches_allowed"] == 0


def test_golden_profile_ke_restart(audit_report):
    """One thick restart of the fused KE from block 0: exactly 2
    collectives (all_reduce + all_gather) a block step, m/p = 6 steps."""
    spec = AuditSpec()
    entry = _entry_of(audit_report, "dist/ke_restart_program")
    steps = spec.m // spec.p
    assert entry["max_collectives_per_step"] == KE_COLLECTIVES_PER_BLOCK_STEP
    assert entry["total_collectives"] == KE_COLLECTIVES_PER_BLOCK_STEP * steps
    (prog,) = entry["programs"]
    assert prog["collective_counts"] == {"all_reduce": steps,
                                         "all_gather": steps}
    assert prog["step_collectives"] == [KE_COLLECTIVES_PER_BLOCK_STEP] * steps
    assert prog["collective_labels"] == {"matvec": 2 * steps}
    assert prog["f64_downcasts"] == {}
    assert prog["isfinite_sites"] >= 1
    # the probe: a whole filtered solve enters restarts + 2 stages
    (solve,) = entry["probes"]
    assert solve["extra"]["converged"] and solve["extra"]["fused"]
    assert solve["stage_entries"]["dist"] == contracts.ke_dispatch_budget(
        solve["extra"]["n_restart"])


def test_golden_profile_band_sweep(audit_report):
    """The distributed TT1 sweep: gather(panel) + all_reduce(coupling) +
    gather(Z) = 3 collectives a panel, 7 panels at n=64, w=8."""
    entry = _entry_of(audit_report, "dist/band_sweep_program")
    n_panels = 7                       # _n_panels(n=64, w=8)
    assert sbr._n_panels(64, 8) == n_panels
    assert entry["max_collectives_per_step"] == TT1_COLLECTIVES_PER_PANEL
    assert entry["total_collectives"] == TT1_COLLECTIVES_PER_PANEL * n_panels
    (sweep,) = entry["programs"]
    assert sweep["collective_counts"] == {"all_gather": 2 * n_panels,
                                          "all_reduce": n_panels}
    # the panel's gather, then 3 a panel, the last panel's 2 after it
    assert sweep["step_collectives"] == [1] + [3] * (n_panels - 1) + [2]
    assert sweep["kernel_calls"] == {"house_panel": n_panels}
    assert sweep["f64_downcasts"] == {}


def test_golden_tt3_collective_structure(audit_report):
    """Distributed TT3 is 1 + iters collectives: the lam all_gather, then
    one Z all_gather a round."""
    spec = AuditSpec()
    entry = _entry_of(audit_report, "dist/tt3_program")
    assert entry["total_collectives"] == tt3_dist_collectives(spec.tt3_iters)
    assert entry["max_collectives_per_step"] == 1
    (prog,) = entry["programs"]
    assert prog["collective_counts"] == {"all_gather": 1 + spec.tt3_iters}
    assert prog["kernel_calls"] == {"bisect_sturm": 1,
                                    "invit": 2 * spec.tt3_iters}


def test_golden_kernel_and_stage_counts(audit_report):
    """The main-path entries count what the port's schedule code says."""
    spec = AuditSpec()
    n_panels = sbr._n_panels(spec.n, spec.w)
    n_pass = len(sbr._executed_passes(spec.n, spec.w))
    rtb = _entry_of(audit_report, "core/reduce_to_band")
    assert rtb["kernel_calls"] == {"house_panel": n_panels,
                                   "syr2k": n_panels}
    assert rtb["stage_entries"] == {"sbr": 1}
    assert _entry_of(audit_report, "core/band_chase")["kernel_calls"] == {
        "chase_pass": n_pass}
    assert _entry_of(audit_report, "core/apply_q2")["kernel_calls"] == {
        "replay_pass": n_pass}
    for e in audit_report["entries"]:
        if e["name"].startswith("kernels/"):
            assert sum(e["kernel_calls"].values()) == 1, e["name"]
    sent = _entry_of(audit_report, "resilience/stage_sentinels")
    assert sent["host_reads"] == 0 and sent["isfinite_sites"] >= 2
    # below fp64 the buckets demote only what they declare, and run the
    # reduced instances
    tt = _entry_of(audit_report, "serve/solve_batched_TT_fast")
    assert {"house_panel_bf16", "syr2k_bf16", "chase_pass_bf16",
            "replay_pass_bf16"} <= set(tt["kernel_calls"])
    for p in tt["programs"]:
        assert set(p["f64_downcasts"]) <= {"float64->bfloat16",
                                           "float64->float32"}
    for name in ("TD", "TT", "KE", "KI"):
        warm = _entry_of(audit_report, f"serve/solve_batched_{name}")[
            "programs"][1]
        assert warm["name"] == "warm" and warm["extra"]["cache_hit"]
        assert warm["extra"]["programs_built"] == 0
        assert warm["f64_downcasts"] == {}


def test_crosscheck_model_vs_counted(audit_report):
    """Every cross-check agreed, and the exact ones are exact (TT2/TT4
    steps, KE's collectives and stage entries, TT1's per panel)."""
    checks = {(c["stage"], c["field"]): c for c in audit_report["crosscheck"]}
    assert all(c["ok"] for c in checks.values()), [
        k for k, c in checks.items() if not c["ok"]]
    for key in [("TT2", "loop_steps"), ("TT4", "loop_steps"),
                ("KE", "dispatches"), ("KE", "collectives_per_block_step"),
                ("KE", "collectives_per_restart_segment"),
                ("TT1", "collectives_per_panel")]:
        assert key in checks and checks[key]["relation"] == "exact"
    assert checks[("TT1", "collectives")]["relation"] == "rel<=0.35"
    assert checks[("TT3", "loop_steps")]["relation"] == "rel<=0.15"
    drift = {d["stage"]: d for d in audit_report["dispatch_drift"]}
    assert drift["TT1"]["counted_launches"] == 2 * sbr._n_panels(64, 8)
    assert drift["TT1"]["model_dispatches"] == 2


# --------------------------------------------------------------------------
# parity with the reference's numbers
# --------------------------------------------------------------------------

def _reference_module():
    return ast.parse((REFERENCE / "contracts.py").read_text())


def _reference_literals(tree):
    out = {}
    for node in tree.body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  and len(node.targets) == 1 else
                  node.target if isinstance(node, ast.AnnAssign) else None)
        if isinstance(target, ast.Name) and node.value is not None:
            try:
                out[target.id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_constants_match_the_reference():
    ref = _reference_literals(_reference_module())
    for name in ("TT1_COLLECTIVES_PER_PANEL", "KE_COLLECTIVES_PER_BLOCK_STEP",
                 "SENTINEL_EXTRA_DISPATCHES"):
        assert getattr(contracts, name) == ref[name], name
    registry = _reference_literals(ast.parse(
        (REFERENCE / "registry.py").read_text()))
    # torch's names, without the reference's PRNG key dtype
    want = tuple(d for d in registry["DEFAULT_ALLOWED_DTYPES"]
                 if d != "key<fry>")
    assert contracts.DEFAULT_ALLOWED_DTYPES == want
    assert contracts.MIXED_ALLOWED_DTYPES == want + ("float32",)
    assert contracts.FAST_ALLOWED_DTYPES == want + ("float32", "bfloat16")


def test_audit_spec_matches_the_reference():
    tree = _reference_module()
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "AuditSpec")
    ref = {n.target.id: ast.literal_eval(n.value) for n in cls.body
           if isinstance(n, ast.AnnAssign)}
    assert AuditSpec().as_json_dict() == ref


@pytest.mark.parametrize("name", ["ke_dispatch_budget",
                                  "lanczos_block_dispatch_budget",
                                  "lanczos_single_dispatch_budget",
                                  "tt3_dist_collectives"])
def test_budget_functions_match_the_reference(name):
    """The reference's budget function, compiled from its source alone
    (pure arithmetic), against the port's over a range of arguments."""
    tree = _reference_module()
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    fn.returns = None
    for a in fn.args.args:
        a.annotation = None
    ns: dict = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), name, "exec"), ns)
    for k in range(0, 200):
        assert getattr(contracts, name)(k) == ns[name](k), (name, k)


# --------------------------------------------------------------------------
# the dispatch hooks against the reference's
# --------------------------------------------------------------------------

def _spectrum_matrix(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-1.0, 1.0, n) ** 3
    C = (Q * lam) @ Q.T
    return 0.5 * (C + C.T)


class _CountingMatvec:
    """Callable op counting its Python-level calls."""

    def __init__(self, C):
        self.C = C
        self.calls = 0

    def __call__(self, v):
        self.calls += 1
        return self.C @ v


def test_lanczos_dispatch_count_per_restart():
    """The port's restart loop enters two stages a restart (segment and
    restart math), within the reference's budgets, and counts as the
    reference does on the same start: per restart, and in total where
    both stop at the same restart."""
    n, s, m = 96, 4, 24
    C = _spectrum_matrix(n, 7)
    v0 = np.random.default_rng(8).standard_normal(n)
    tl.reset_dispatch_count()
    res = tl.lanczos_solve(_CountingMatvec(torch.from_numpy(C)), s,
                           which="SA", m=m, v0=torch.from_numpy(v0),
                           max_restarts=200)
    assert res.converged
    k = res.n_restart
    got = tl.dispatch_count()
    assert got == 2 * k
    assert got <= contracts.lanczos_single_dispatch_budget(k)
    assert got <= k * (m + 4)
    assert res.n_matvec >= m
    jl.reset_dispatch_count()
    jres = jl.lanczos_solve(_CountingMatvec(jnp.asarray(C)), s, which="SA",
                            m=m, v0=jnp.asarray(v0), max_restarts=200)
    assert jres.converged
    assert jl.dispatch_count() == 2 * jres.n_restart
    if jres.n_restart == k:
        assert got == jl.dispatch_count()


def test_lanczos_dispatch_budget_block_and_filtered():
    """p=4 with the Chebyshev filter: two stages a restart plus the probe
    and the filter, within ``lanczos_block_dispatch_budget``; the same as
    the reference's from the same start block and probe."""
    n, s, p = 96, 4, 4
    C = _spectrum_matrix(n, 9)
    X0 = np.random.default_rng(10).standard_normal((n, p))
    probe = np.array(jax.random.normal(jax.random.fold_in(KEY, 2), (n,),
                                       jnp.float64))
    tl.reset_dispatch_count()
    res = tl.lanczos_solve(_CountingMatvec(torch.from_numpy(C)), s,
                           which="SA", n=n, p=p, filter_degree=8,
                           v0=torch.from_numpy(X0),
                           probe_v0=torch.from_numpy(probe),
                           max_restarts=200)
    assert res.converged
    k = res.n_restart
    got = tl.dispatch_count()
    assert got == 2 * k + 2 == contracts.lanczos_block_dispatch_budget(k)
    jl.reset_dispatch_count()
    jres = jl.lanczos_solve(_CountingMatvec(jnp.asarray(C)), s, which="SA",
                            n=n, p=p, filter_degree=8, key=KEY,
                            v0=jnp.asarray(X0), max_restarts=200)
    assert jres.converged
    assert jl.dispatch_count() == 2 * jres.n_restart + 2
    if jres.n_restart == k:
        assert got == jl.dispatch_count()


def test_reduce_to_band_is_one_sweep_of_two_kernels_a_panel():
    """The port's TT1 enters one sweep (``sbr.dispatch_count``) that calls
    ``house_panel`` and ``syr2k`` once a panel, and its band is the
    reference's."""
    n, w = 96, 8
    M = np.random.default_rng(11).standard_normal((n, n))
    C = 0.5 * (M + M.T)
    n_panels = len(range(0, n - w - 1, w))
    assert sbr._n_panels(n, w) == n_panels
    sbr.reset_dispatch_count()
    with _launches.recording() as rec:
        band = sbr.reduce_to_band(torch.from_numpy(C), w=w, n_chunks=1)
    assert sbr.dispatch_count() == 1
    assert rec.calls == {"house_panel": n_panels, "syr2k": n_panels}
    want = jsbr.reduce_to_band(jnp.asarray(C), w=w, n_chunks=1)
    np.testing.assert_allclose(band.Wb.numpy(), np.asarray(want.Wb),
                               atol=1e-11)
