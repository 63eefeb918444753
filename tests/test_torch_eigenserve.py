"""The port's serving engine (``repro_torch.serve.eigen_engine``) and its
CLI (``repro_torch.launch.eigenserve``) against the JAX engine, on the CPU.

The same pencils (the JAX generators' ``md_like``/``dft_like`` at n=32-64,
s=3, with the keys of ``tests/test_eigenserve.py`` and
``tests/test_resilience.py``) go as numpy arrays through
``repro.serve.eigen_engine.EigenEngine`` and the port's engine on
``device="cpu"``. Each test holds the port to the reference's outcome: the
same path, batch and bucket per uid, the same summary counts, router
choice, quarantine count and dead letters, and every converged pencil's
eigenvalues within 1e-9·max|λ| of the JAX engine's and within the
reference's own bar of the exact spectrum. The random starts differ (the
reference's threefry key against the port's ``torch.Generator``), so only
converged results are compared by value.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.problems import dft_like, md_like
from repro.serve.eigen_engine import EigenEngine as JEngine
from repro_torch.core import batched as tb
from repro_torch.launch import eigenserve
from repro_torch.resilience.faults import nonspd_pencil
from repro_torch.serve.eigen_engine import EigenEngine

S = 3
PARITY = 1e-9            # |lambda_port - lambda_jax| / max|lambda|
EXACT = dict(rtol=1e-7, atol=1e-9)   # the reference tests' exact-spectrum bar


def _pencils(gen, n, k, seed=100):
    return [gen(n, key=jax.random.PRNGKey(seed + i)) for i in range(k)]


def _np(p):
    return np.array(p.A, dtype=np.float64), np.array(p.B, dtype=np.float64)


def _engines(**kw):
    return JEngine(**kw), EigenEngine(device="cpu", **kw)


def _submit(engines, A, B, s=S, **kw):
    """Submit one numpy pencil to both engines; they hand out one uid."""
    jeng, teng = engines
    uid = jeng.submit(jnp.asarray(A), jnp.asarray(B), s, **kw)
    assert teng.submit(A, B, s, **kw) == uid
    return uid


def _drain(engines, flush=True):
    return [{r.uid: r for r in eng.run_until_drained(flush=flush)}
            for eng in engines]


def _counts(summary):
    """The summary without its latencies."""
    out = {k: v for k, v in summary.items() if k != "buckets"}
    out["buckets"] = {k: b["count"] for k, b in summary["buckets"].items()}
    return out


def _assert_parity(engines, exact=None):
    """The port's engine retired every uid as the JAX engine did; each
    converged pencil on the JAX engine's eigenvalues (and on ``exact[uid]``
    where given). Returns the port's done requests by uid."""
    jeng, teng = engines
    jdone = {r.uid: r for r in jeng.done}
    tdone = {r.uid: r for r in teng.done}
    assert sorted(tdone) == sorted(jdone)
    for uid, jr in jdone.items():
        tr = tdone[uid]
        for key in ("path", "batch", "bucket", "variant", "converged"):
            assert tr.info.get(key) == jr.info.get(key), (uid, key)
        assert tr.info["latency_s"] >= 0.0
        assert isinstance(tr.info["warnings"], list)
        json.dumps(tr.info)
        assert tr.evals.shape == np.asarray(jr.evals).shape
        if tr.info.get("converged", True):
            jl = np.asarray(jr.evals)
            scale = float(np.max(np.abs(jl)))
            assert float(np.max(np.abs(tr.evals - jl))) <= PARITY * scale
            if exact is not None:
                np.testing.assert_allclose(tr.evals, exact[uid], **EXACT)
    assert ([(r.uid, r.info["dead_letter"]["reason"])
             for r in teng.dead_letters]
            == [(r.uid, r.info["dead_letter"]["reason"])
                for r in jeng.dead_letters])
    assert _counts(teng.summary()) == _counts(jeng.summary())
    json.dumps(teng.summary())
    return tdone


def test_engine_bucket_dispatch_and_latency():
    probs32 = _pencils(md_like, 32, 2, seed=7)
    probs48 = _pencils(md_like, 48, 2, seed=17)
    engines = _engines(slots=2, bucket_shapes=[32, 48], variant="TD")
    exact = {_submit(engines, *_np(p)): np.asarray(p.exact_evals[:S])
             for p in probs32 + probs48}
    jdone, tdone = _drain(engines)
    assert len(tdone) == 4
    assert engines[1].n_dispatches == 2  # one dispatch per full bucket
    for req in tdone.values():
        assert req.info["path"] == "batched" and req.info["batch"] == 2
    _assert_parity(engines, exact)
    summary = engines[1].summary()
    assert summary["requests"] == 4 and summary["dispatches"] == 2
    for b in summary["buckets"].values():
        assert b["count"] == 2
        assert 0.0 <= b["mean_latency_s"] <= b["p90_latency_s"]


def test_engine_flush_drains_partial_buckets():
    probs = _pencils(md_like, 32, 3, seed=31)
    engines = _engines(slots=4, bucket_shapes=[32], variant="TD")
    exact = {_submit(engines, *_np(p)): np.asarray(p.exact_evals[:S])
             for p in probs}
    for eng in engines:
        eng.tick()                   # bucket not full: nothing dispatches
        assert not eng.done and eng.pending() == 3
    _drain(engines, flush=True)
    done = engines[1].done
    assert len(done) == 3 and done[0].info["batch"] == 3
    _assert_parity(engines, exact)


def test_engine_oversized_goes_through_router():
    """A pencil above max_batched_n falls through to the variant='auto'
    router; the decision lands in req.info and matches the reference's."""
    small = _pencils(md_like, 32, 1, seed=43)[0]
    big = _pencils(md_like, 64, 1, seed=47)[0]
    engines = _engines(slots=1, bucket_shapes=None, max_batched_n=48,
                       variant="TD")
    uid_small = _submit(engines, *_np(small))
    uid_big = _submit(engines, *_np(big))
    jdone, tdone = _drain(engines)
    assert tdone[uid_small].info["path"] == "batched"
    assert tdone[uid_big].info["path"] == "direct"
    router = tdone[uid_big].info["router"]
    assert router["variant"] == jdone[uid_big].info["router"]["variant"]
    assert tdone[uid_big].info["variant"] == router["variant"]
    assert set(tdone[uid_big].info["stage_times"]) == set(
        jdone[uid_big].info["stage_times"])
    _assert_parity(engines, {uid_small: np.asarray(small.exact_evals[:S]),
                             uid_big: np.asarray(big.exact_evals[:S])})


def test_engine_surfaces_unconverged_and_cache_metadata():
    """on_failure='warn' retires unconverged lanes with a warning instead
    of quarantining them."""
    N = 32
    probs = _pencils(md_like, N, 2, seed=500)
    engines = _engines(slots=2, bucket_shapes=[N], variant="KE",
                       max_restarts=1, on_failure="warn")
    for p in probs:
        _submit(engines, *_np(p))
    jdone, tdone = _drain(engines)
    assert len(tdone) == 2
    for req in tdone.values():
        assert "cache_hit" in req.info and "compile_s" in req.info
        assert "dispatch_wall_s" in req.info
        assert not req.info["converged"]
        assert any("restart budget" in w for w in req.info["warnings"])
        assert req.info["health"]["healthy"] is True
    _assert_parity(engines)


def test_two_dispatches_of_one_bucket_keep_their_own_results():
    """The bucket program writes into static buffers that the next
    dispatch overwrites: a retired request holds a copy of its own."""
    tb.clear_pipeline_cache()
    probs = _pencils(dft_like, 32, 4, seed=600)
    eng = EigenEngine(slots=2, bucket_shapes=[32], variant="TD",
                      device="cpu")
    uids = {eng.submit(*_np(p), S): p for p in probs}
    done = {r.uid: r for r in eng.run_until_drained()}
    assert eng.n_dispatches == 2
    hits = [done[u].info["cache_hit"] for u in sorted(done)]
    assert hits == [False, False, True, True]
    (prog,) = tb._EXEC_CACHE.values()
    for uid, p in uids.items():
        req = done[uid]
        np.testing.assert_allclose(req.evals, np.asarray(p.exact_evals[:S]),
                                   **EXACT)
        assert req.A is None and req.B is None
        for buf in (prog.lam, prog.X):
            assert not np.shares_memory(req.evals, buf.numpy())
            assert not np.shares_memory(req.X, buf.numpy())
    # the first dispatch's pencils differ from the second's
    first, second = sorted(done)[:2], sorted(done)[2:]
    assert not np.allclose(done[first[0]].evals, done[second[0]].evals)
    tb.clear_pipeline_cache()


def test_engine_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EigenEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eigenserve.main(["--requests", "2"])
    eng = EigenEngine(device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.generator.device == torch.device("cpu")


def test_engine_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 12"):
        EigenEngine(mesh=object(), device="cpu")
    for argv in (["--mesh", "4x2"], ["--devices", "8"]):
        with pytest.raises(NotImplementedError, match="item 12"):
            eigenserve.main(argv + ["--device", "cpu"])


def test_eigenserve_cli_on_the_cpu(capsys):
    eigenserve.main(["--slots", "2", "--bucket-shapes", "32", "--requests",
                     "4", "--stream", "mixed", "--s", "3", "--variant",
                     "TD", "--oversize-every", "4", "--oversize-n", "48",
                     "--max-batched-n", "32", "--device", "cpu", "--json"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("eigenserve OK")
    payload = json.loads(out[:out.rindex("eigenserve OK")])
    assert payload["device"] == "cpu"
    summary = payload["summary"]
    assert summary["requests"] == 4 and summary["dead_letters"] == 0
    assert summary["buckets"]["direct"]["count"] == 1
    assert payload["max_abs_eval_error"] < 1e-6


# --------------------------------------------------------------------------
# chaos: the engine's quarantine and dead-letter drills
# (tests/test_resilience.py's, against the reference on the same pencils)
# --------------------------------------------------------------------------

@pytest.mark.chaos
def test_engine_quarantines_and_recovers_unconverged_lanes():
    """Lanes that miss the bucket's restart budget are retried
    individually up the ladder and retire healthy."""
    N = 32
    probs = [md_like(N, key=jax.random.PRNGKey(900 + i)) for i in range(2)]
    engines = _engines(slots=2, bucket_shapes=[N], variant="KE",
                       max_restarts=1, on_failure="recover")
    exact = {_submit(engines, *_np(p)): np.asarray(p.exact_evals[:S])
             for p in probs}
    jdone, tdone = _drain(engines)
    assert len(tdone) == len(probs) and not engines[1].dead_letters
    assert engines[1].summary()["quarantined"] == len(probs)
    for uid, req in tdone.items():
        assert req.info["path"] == "quarantine"
        assert req.info["converged"]
        assert req.info["health"]["healthy"] is True
        assert req.info["attempts"] == jdone[uid].info["attempts"]
        assert ([r["action"] for r in req.info["recovery"]]
                == [r["action"] for r in jdone[uid].info["recovery"]])
    _assert_parity(engines, exact)


@pytest.mark.chaos
@pytest.mark.parametrize("variant", ["TD", "TT"])
def test_engine_dead_letters_unrecoverable_lane(variant):
    """A non-SPD pencil poisons its bucket lane; the quarantine retries
    end in a dead letter carrying the diagnosis, the healthy lane
    retires normally — no silent drops either way."""
    N = 32
    good = md_like(N, key=jax.random.PRNGKey(31))
    A_bad, B_bad = nonspd_pencil(N)
    engines = _engines(slots=2, bucket_shapes=[N], variant=variant,
                       on_failure="recover", max_retries=1)
    uid_good = _submit(engines, *_np(good))
    uid_bad = _submit(engines, A_bad, B_bad)
    jdone, tdone = _drain(engines)
    assert set(tdone) == {uid_good}
    assert tdone[uid_good].info["path"] == "batched"
    assert [r.uid for r in engines[1].dead_letters] == [uid_bad]
    dead = engines[1].dead_letters[0]
    assert dead.info["path"] == "dead_letter"
    assert dead.info["health"]["healthy"] is False
    assert dead.info["dead_letter"]["reason"] == "cholesky_breakdown"
    assert dead.A is None and dead.B is None
    json.dumps(dead.info)
    jdead = engines[0].dead_letters[0]
    assert ([r["action"] for r in dead.info["recovery"]]
            == [r["action"] for r in jdead.info["recovery"]])
    assert dead.info["dead_letter"]["stage"] == \
        jdead.info["dead_letter"]["stage"]
    summary = engines[1].summary()
    assert summary["dead_letter_uids"] == [uid_bad]
    assert summary["requests"] == 2
    _assert_parity(engines, {uid_good: np.asarray(good.exact_evals[:S])})
