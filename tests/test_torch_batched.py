"""The port's batched solves (``repro_torch.core.batched``) and its
fixed-trip Lanczos driver against the JAX reference, on the CPU.

The same stacks of pencils (``md_like``/``dft_like`` at n=32, s=3, batch
4, as ``tests/test_eigenserve.py``) go through
``repro.core.batched.solve_batched`` and the port's; the random starts the
reference draws per pencil (``split(PRNGKey(20120520), batch)``: TD2's
block, the Lanczos block, and the refinement's guard block from
``fold_in(key, 7)``) are passed in. On the CPU the program's pieces run
eagerly, the same code the card captures in CUDA graphs.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import batched as jb
from repro.core import solve as j_solve
from repro.core import lanczos as jl
from repro.core import operators as jo
from repro.core import refinement as jr
from repro.core.cholesky import cholesky_upper as j_chol
from repro.core.residuals import accuracy_report
from repro.core.standard_form import to_standard_two_trsm as j_gs2
from repro.data.problems import dft_like, md_like
from repro_torch.core import batched as tb
from repro_torch.core import lanczos as tl
from repro_torch.core import operators as to
from repro_torch.core import refinement as tr
from repro_torch.core import solve

N, S, BATCH = 32, 3, 4
KEY = jax.random.PRNGKey(20120520)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _stacks(gen, seed=100, k=BATCH):
    probs = [gen(N, key=jax.random.PRNGKey(seed + i)) for i in range(k)]
    return probs, (np.stack([np.array(p.A) for p in probs]),
                   np.stack([np.array(p.B) for p in probs]))


def _starts(k=BATCH, s=S, p=1, guard=0):
    """What the reference's batched pipelines draw per pencil."""
    keys = jax.random.split(KEY, k)
    out = {"x0": np.stack([np.array(jax.random.normal(kk, (N, s),
                                                      jnp.float64))
                           for kk in keys]),
           "v0": np.stack([np.array(jax.random.normal(kk, (N, p),
                                                      jnp.float64))
                           for kk in keys])}
    if guard:
        out["guard0"] = np.stack([np.array(jax.random.normal(
            jax.random.fold_in(kk, 7), (N, guard), jnp.float64))
            for kk in keys])
    return {name: _t(v) for name, v in out.items()}


def _pair(gen, variant, precision="fp64", seed=100, **kw):
    probs, (A, B) = _stacks(gen, seed)
    ref = jb.solve_batched(jnp.asarray(A), jnp.asarray(B), S,
                           variant=variant, precision=precision, **kw)
    guard = tr.default_guard(S, N) if precision != "fp64" else 0
    res = tb.solve_batched(_t(A), _t(B), S, variant=variant,
                           precision=precision, device="cpu", **kw,
                           **_starts(guard=guard, p=kw.get("p", 1)))
    return probs, ref, res


def _accuracy(p, X, lam, bar=1e-9):
    acc = accuracy_report(p.A, p.B, jnp.asarray(X), jnp.asarray(lam))
    assert float(acc.relative_residual) < bar
    assert float(acc.b_orthogonality) < bar


CASES = [(md_like, "TD"), (md_like, "TT"), (md_like, "KE"), (md_like, "KI"),
         (dft_like, "TD"), (dft_like, "TT")]


@pytest.mark.parametrize("gen,variant", CASES,
                         ids=[f"{g.__name__}_{v}" for g, v in CASES])
def test_solve_batched_matches_reference(gen, variant):
    # the MD inverse-pair trick for the Krylov variants, as the reference's
    # tests: the direct smallest end converges too slowly to serve
    invert = variant in ("KE", "KI")
    probs, ref, res = _pair(gen, variant, band_width=4, invert=invert,
                            max_restarts=300)
    assert res.evals.shape == (BATCH, S) and res.X.shape == (BATCH, N, S)
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(ref.evals),
                               rtol=1e-10, atol=1e-10)
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    assert res.healthy.all() and np.asarray(ref.healthy).all()
    X, X_ref = res.X.numpy(), np.asarray(ref.X)
    for i, p in enumerate(probs):
        sign = np.where(np.sum(X[i] * X_ref[i], axis=0) < 0, -1.0, 1.0)
        _accuracy(p, X[i] * sign, res.evals[i].numpy())
        np.testing.assert_allclose(res.evals[i].numpy(),
                                   np.asarray(p.exact_evals[:S]),
                                   rtol=1e-7, atol=1e-9)
    assert res.info["n_unconverged"] == res.info["n_unhealthy"] == 0
    assert res.info["path"] == "eager" and "warnings" not in res.info
    json.dumps(res.info)


# the MD inverse pair; DFT's top end (its bottom is clustered: at n=32 a
# Krylov bucket there runs out of restarts in both packages)
BLOCK_CASES = [(md_like, "KE", "smallest", True),
               (md_like, "KI", "smallest", True),
               (dft_like, "KE", "largest", False),
               (dft_like, "KI", "largest", False)]


@pytest.mark.parametrize("gen,variant,which,invert", BLOCK_CASES,
                         ids=[f"{g.__name__}_{v}" for g, v, _, _ in
                              BLOCK_CASES])
def test_solve_batched_filter_and_block_match_reference(gen, variant, which,
                                                        invert):
    """The Krylov buckets with a Chebyshev start filter and a block of two:
    the probe's ``eigh`` split, its start (the block's first column by
    default, as the reference) and the block lanes, against the reference
    from the same draws."""
    probs, ref, res = _pair(gen, variant, which=which, invert=invert,
                            max_restarts=300, p=2, filter_degree=4)
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(ref.evals),
                               rtol=1e-10, atol=1e-10)
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    assert res.converged.all() and res.healthy.all()
    for i, p in enumerate(probs):
        _accuracy(p, res.X[i].numpy(), res.evals[i].numpy())
    assert res.info["graphs"] == 5
    assert res.info["graph_replays"]["krylov_filter"] == 1
    assert res.info["cache_key"][8:10] == [2, 4]


DEMOTED = [("TT", "mixed"), ("KE", "mixed"), ("TD", "fast"), ("KI", "fast")]


@pytest.mark.parametrize("variant,precision", DEMOTED,
                         ids=[f"{v}_{p}" for v, p in DEMOTED])
def test_solve_batched_demoted_matches_reference(variant, precision):
    invert = variant in ("KE", "KI")
    probs, ref, res = _pair(md_like, variant, precision=precision,
                            band_width=4, invert=invert, max_restarts=300)
    ev, ev_ref = res.evals.numpy(), np.asarray(ref.evals)
    assert np.abs(ev - ev_ref).max() <= 1e-9 * np.abs(ev_ref).max()
    assert res.info["refine_steps"] == {"mixed": 8, "fast": 16}[precision]
    for i, p in enumerate(probs):
        _accuracy(p, res.X[i].numpy(), ev[i])
    # the refinement's pieces: a step in a phase, a refactor, the end
    assert {"refine_step", "refine_refactor", "refine_end"} <= set(
        res.info["graph_replays"])
    assert res.info["graph_replays"]["refine_end"] == 1


def test_solve_batched_parity_with_single_solve():
    """Pencil i of a batched TD bucket == the port's solve on it alone,
    from the same start block."""
    _, (A, B) = _stacks(dft_like)
    starts = _starts()
    res = tb.solve_batched(_t(A), _t(B), S, variant="TD", device="cpu",
                           x0=starts["x0"])
    for i in range(BATCH):
        one = solve(_t(A[i]), _t(B[i]), S, variant="TD",
                    x0=starts["x0"][i], device="cpu")
        np.testing.assert_allclose(res.evals[i].numpy(), one.evals.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_pipeline_cache_bucket_reuse():
    """Same (n, s, variant, which) bucket -> the same pipeline; another
    shape -> a new entry; the key is the reference's with torch's dtype
    name."""
    before = tb.cache_stats()
    fn1, key1 = tb.get_pipeline(N, S, "TD", "smallest")
    fn2, key2 = tb.get_pipeline(N, S, "TD", "smallest")
    assert fn1 is fn2 and key1 == key2
    fn3, key3 = tb.get_pipeline(N + 8, S, "TD", "smallest")
    assert fn3 is not fn1 and key3 != key1
    after = tb.cache_stats()
    assert after["hits"] >= before["hits"] + 1
    assert after["entries"] >= before["entries"] + 1
    for variant in tb.BATCHED_VARIANTS:
        for prec in ("fp64", "mixed", "fast"):
            k = dict(variant=variant, which="largest", band_width=4,
                     invert=True, p=2, filter_degree=4, precision=prec)
            assert tb.pipeline_cache_key(N, S, **k) == tuple(
                jb.pipeline_cache_key(N, S, **k))
    with pytest.raises(ValueError, match="variant"):
        tb.get_pipeline(N, S, "auto", "smallest")


def test_solve_batched_cold_warm_cache_hit():
    """Cold call: cache_hit False and the build time reported apart from
    the execution wall; warm call: cache_hit True, compile_s 0, and the
    same results (the default starts are drawn from a fresh generator
    of the same seed every call)."""
    tb.clear_pipeline_cache()
    _, (A, B) = _stacks(md_like, seed=300)
    r1 = tb.solve_batched(_t(A), _t(B), S, variant="TD", device="cpu")
    assert r1.info["cache_hit"] is False
    assert r1.info["compile_s"] > 0.0
    assert r1.info["wall_s"] > 0.0 and r1.info["pencils_per_s"] > 0.0
    r2 = tb.solve_batched(_t(A), _t(B), S, variant="TD", device="cpu")
    assert r2.info["cache_hit"] is True
    assert r2.info["compile_s"] == 0.0
    assert torch.equal(r1.evals, r2.evals) and torch.equal(r1.X, r2.X)
    stats = tb.cache_stats()
    assert stats["entries"] == 1 and stats["exec_entries"] == 1
    assert r1.info["graphs"] == 1
    assert r1.info["graph_replays"] == {"direct": 1}


def test_solve_batched_surfaces_unconverged():
    """A restart budget of one is reported per pencil, as the reference's,
    with the batch-level warning; a healthy budget reports none."""
    _, ref, res = _pair(md_like, "KE", seed=400, max_restarts=1)
    n_unconv = res.info["n_unconverged"]
    assert n_unconv == int((~res.converged).sum()) > 0
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    assert any("restart budget" in w for w in res.info["warnings"])
    assert res.info["restarts"] == 1
    _, ref, ok = _pair(md_like, "KE", seed=400, invert=True,
                       max_restarts=300)
    assert ok.info["n_unconverged"] == 0 and "warnings" not in ok.info
    assert ok.info["restarts"] == ok.info["graph_replays"]["krylov_restart"]


def test_program_warm_up_runs_every_piece():
    """The capture's warm-up runs every piece of a bucket, the Krylov
    segment too when its loop is done after one restart, and leaves the
    results of a plain run; once captured, a piece without a graph
    raises instead of running eagerly."""
    _, (A, B) = _stacks(md_like, seed=400)
    pipe, _ = tb.get_pipeline(N, S, "KE", "smallest", max_restarts=1,
                              precision="mixed")
    prog = pipe.build(BATCH, torch.device("cpu"), False)
    draws = prog.draw(_starts(guard=tr.default_guard(S, N)), None)
    prog.load(_t(A), _t(B), draws)
    prog.run()
    assert set(prog._pieces) - prog.ran == {"krylov_segment"}
    lam, X = prog.lam.clone(), prog.X.clone()
    prog.load(_t(A), _t(B), draws)
    prog.run(warm=True)
    assert prog.ran == set(prog._pieces)
    assert prog.replays["krylov_segment"] == 1 and prog.restarts == 2
    assert torch.equal(prog.lam, lam) and torch.equal(prog.X, X)
    prog.captured = True
    with pytest.raises(RuntimeError, match="has no graph"):
        prog.run()


def test_batched_surfaces_unhealthy_pencils():
    """A non-SPD B in one lane (a NaN) flips that lane's healthy flag only,
    with the batch-level warning, as the reference's drill."""
    probs = [md_like(N, key=jax.random.PRNGKey(70 + i)) for i in range(3)]
    A = np.stack([np.array(p.A) for p in probs])
    B = np.stack([np.array(p.B) for p in probs])
    B[1, 0, 0] = np.nan
    ref = jb.solve_batched(jnp.asarray(A), jnp.asarray(B), S, variant="TD")
    res = tb.solve_batched(_t(A), _t(B), S, variant="TD", device="cpu")
    healthy = res.healthy.tolist()
    assert healthy == [True, False, True]
    assert healthy == np.asarray(ref.healthy).tolist()
    assert res.info["n_unhealthy"] == 1
    assert any("non-finite" in w.lower() for w in res.info["warnings"])
    for i in (0, 2):
        _accuracy(probs[i], res.X[i].numpy(), res.evals[i].numpy())


JIT_CASES = [(md_like, True, 0), (md_like, True, 4), (dft_like, False, 0),
             (dft_like, False, 4)]


@pytest.mark.parametrize("gen,invert,filter_degree", JIT_CASES,
                         ids=[f"{g.__name__}_inv{i}_f{f}"
                              for g, i, f in JIT_CASES])
def test_lanczos_solve_jit_matches_reference(gen, invert, filter_degree):
    """The fixed-trip driver on one pencil's largest end (the MD inverse
    pair, the DFT top): the same restart count and verdicts (or, at the
    eps * |theta| floor, a restart apart: ROADMAP.md §3, counts at the
    rounding floor), and Ritz values within 1e-10 max|theta|."""
    n, s, m = 64, 4, 20
    p = gen(n)
    A, B = (p.B, p.A) if invert else (p.A, p.B)
    C = j_gs2(A, j_chol(B))
    v0 = np.array(jax.random.normal(KEY, (n, 1), jnp.float64))
    ref = jl.lanczos_solve_jit(jo.ExplicitC(C), jnp.asarray(v0), s, m,
                               which="LA", max_restarts=300,
                               filter_degree=filter_degree)
    res = tl.lanczos_solve_jit(to.ExplicitC(_t(C)), _t(v0), s, m,
                               which="LA", max_restarts=300,
                               filter_degree=filter_degree)
    ev, q, k, conv, healthy = res
    assert bool(conv) == bool(ref[3]) and bool(healthy) == bool(ref[4])
    assert bool(conv)
    assert abs(int(k) - int(ref[2])) <= 1
    theta = np.asarray(ref[0])
    assert np.abs(ev.numpy() - theta).max() <= 1e-10 * np.abs(theta).max()
    # orthonormal Ritz vectors of C spanning the reference's
    Q, Q_ref = q.numpy(), np.asarray(ref[1])
    assert np.abs(Q.T @ Q - np.eye(s)).max() <= 1e-12
    assert np.abs(np.abs(Q.T @ Q_ref) - np.eye(s)).max() <= 1e-8


def test_lanczos_solve_jit_retires_at_the_budget():
    """Out of restarts: converged False, healthy True, k the budget."""
    n, s, m = 48, 4, 12
    p = md_like(n)
    C = j_gs2(p.A, j_chol(p.B))
    v0 = np.array(jax.random.normal(KEY, (n, 1), jnp.float64))
    ref = jl.lanczos_solve_jit(jo.ExplicitC(C), jnp.asarray(v0), s, m,
                               max_restarts=2)
    _, _, k, conv, healthy = tl.lanczos_solve_jit(
        to.ExplicitC(_t(C)), _t(v0), s, m, max_restarts=2)
    assert (int(k), bool(conv), bool(healthy)) == (
        int(ref[2]), bool(ref[3]), bool(ref[4])) == (2, False, True)


@pytest.mark.parametrize("which", ["smallest", "largest"])
def test_fixed_refinement_matches_reference(which):
    """The capture-safe fixed refinement (its shift a 0-d tensor, its LU
    ``lu_factor_ex``) against the reference's, from the same guards."""
    n, s, steps = 40, 3, 5
    p = md_like(n)
    lam = np.asarray(p.exact_evals)
    lam = lam[:s] if which == "smallest" else lam[-s:]
    rng = np.random.default_rng(3)
    ref0 = j_solve(p.A, p.B, s, variant="TD", which=which)
    X = np.array(ref0.X) + 1e-5 * rng.standard_normal((n, s))
    guard = tr.default_guard(s, n)
    gkey = jax.random.PRNGKey(1203)
    G = np.array(jax.random.normal(gkey, (n, guard), jnp.float64))
    lam_r, X_r = jr.refine_eigenpairs_fixed(p.A, p.B, jnp.asarray(lam),
                                            jnp.asarray(X), which=which,
                                            steps=steps, guard=guard,
                                            key=gkey)
    lam_t, X_t = tr.refine_eigenpairs_fixed(_t(p.A), _t(p.B), _t(lam),
                                            _t(X), which=which, steps=steps,
                                            guard=guard, guard0=_t(G))
    ref_lam = np.asarray(lam_r)
    assert np.abs(lam_t.numpy() - ref_lam).max() <= 1e-12 * np.abs(
        ref_lam).max()
    # the same residual as the reference's after the same steps (the
    # largest end's wide spread contracts slowly: not yet at 1e-12)
    acc_t = accuracy_report(p.A, p.B, jnp.asarray(X_t.numpy()),
                            jnp.asarray(lam_t.numpy()))
    acc_r = accuracy_report(p.A, p.B, X_r, lam_r)
    for name in ("relative_residual", "b_orthogonality"):
        t_, r_ = float(getattr(acc_t, name)), float(getattr(acc_r, name))
        assert abs(t_ - r_) <= 1e-3 * r_ + 1e-14, (name, t_, r_)
    if which == "smallest":
        _accuracy(p, X_t.numpy(), lam_t.numpy(), bar=1e-12)
    assert tr.fixed_refactors(steps) == (True, False, True, False, True)
    # the shift: the reference's float arithmetic, bit for bit
    lo, hi = float(lam.min()), float(lam.max())
    scale = max(abs(lo), abs(hi))
    margin = max(0.05 * (hi - lo) + 0.01 * scale, 1e-6 * (1.0 + scale))
    assert float(tr.sigma_fixed(_t(lam), "smallest")) == lo - margin
    assert float(tr.sigma_fixed(_t(lam), "largest")) == hi + margin


def test_solve_batched_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (A, B) = _stacks(md_like)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.solve_batched(_t(A), _t(B), S)
    with pytest.raises(ValueError, match="stacks"):
        tb.solve_batched(_t(A[0]), _t(B[0]), S, device="cpu")
