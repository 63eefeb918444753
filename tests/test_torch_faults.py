"""Fault injection and the single-device chaos drills of the PyTorch port
against the JAX reference (``tests/test_resilience.py``), on the CPU.

The same pencils (the reference's own builders, numpy from a seed) and the
same faults go through both packages: every injected fault must end in a
documented recovery (a rung in ``info['recovery']``) or a diagnosed
``SolverError``, never a silent NaN eigenpair, and the port's diagnosis
(stage, reason) and recovery actions are the reference's. The NaN
positions and the pencils are held to the reference's bit for bit.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import solve as j_solve
from repro.data.problems import md_like
from repro.resilience import SolverError as JSolverError
from repro.resilience import faults as j_faults
from repro_torch.core import solve
from repro_torch.interop import problem_from_numpy
from repro_torch.resilience import faults
from repro_torch.resilience.faults import (ForceNonconverge, NanPoison,
                                           inject, near_breakdown_pencil,
                                           nonspd_pencil,
                                           slow_then_lost_trace)
from repro_torch.resilience.recovery import SolverError, cholesky_shift_taus

N, S = 32, 3
VARIANTS = ("TD", "TT", "KE", "KI")
PRECISIONS = ("fp64", "mixed", "fast")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _md():
    p = md_like(N)
    return p, problem_from_numpy(p.A, p.B, p.exact_evals, p.name,
                                 device="cpu")


def _outcome(fn):
    """("ok", recovery actions) or ("raise", stage, reason, actions)."""
    try:
        res = fn()
    except (SolverError, JSolverError) as err:
        d = err.diagnosis
        return ("raise", d["stage"], d["reason"],
                [r["action"] for r in d["recovery"]])
    return ("ok", [r["action"] for r in res.info["recovery"]])


# ------------------------------------------------- the reference's builders --

@pytest.mark.parametrize("n,seed,min_eig", [(8, 0, -0.1), (32, 3, -1e-8)])
def test_nonspd_pencil_is_the_reference_bit_for_bit(n, seed, min_eig):
    for a, b in zip(nonspd_pencil(n, seed, min_eig),
                    j_faults.nonspd_pencil(n, seed, min_eig)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,cond,seed", [(8, 1e10, 1), (32, 1e6, 5)])
def test_near_breakdown_pencil_is_the_reference_bit_for_bit(n, cond, seed):
    for a, b in zip(near_breakdown_pencil(n, cond, seed),
                    j_faults.near_breakdown_pencil(n, cond, seed)):
        np.testing.assert_array_equal(a, b)


def test_slow_then_lost_trace_is_the_reference():
    assert json.dumps(slow_then_lost_trace()) == json.dumps(
        j_faults.slow_then_lost_trace())


@pytest.mark.parametrize("shape,frac,seed", [((8, 8), 0.01, 0),
                                             ((32, 32), 0.05, 7),
                                             ((100,), 0.3, 3)])
def test_nan_positions_are_the_reference(shape, frac, seed):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape) + 1.0
    ref = j_faults.NanPoison("GS2", frac=frac, seed=seed).apply("GS2", x)
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        got = NanPoison("GS2", frac=frac, seed=seed).apply(
            "GS2", _t(x).to(dt))
        assert got.dtype == dt
        np.testing.assert_array_equal(torch.isnan(got).numpy(),
                                      np.isnan(ref))


# ------------------------------------------------- adversarial pencils --

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_nonspd_b_raises_diagnosed(variant, precision):
    """Indefinite B beyond every shift rung: every variant and precision
    raises the diagnosed SolverError with the exhausted ladder, as the
    reference does."""
    A, B = nonspd_pencil(N)
    with pytest.raises(SolverError) as exc:
        solve(_t(A), _t(B), S, variant=variant, precision=precision,
              on_failure="warn", device="cpu")
    d = exc.value.diagnosis
    assert d["stage"] == "GS1" and d["reason"] == "cholesky_breakdown"
    assert d["hint"]
    shift_rungs = [r for r in d["recovery"] if r["action"] == "cholesky_shift"]
    assert len(shift_rungs) == len(cholesky_shift_taus())
    assert all(r["outcome"] == "failed" for r in shift_rungs)
    json.dumps(d)
    ref = _outcome(lambda: j_solve(jnp.asarray(A), jnp.asarray(B), S,
                                   variant=variant, precision=precision,
                                   on_failure="warn"))
    assert ref == ("raise", d["stage"], d["reason"],
                   [r["action"] for r in d["recovery"]])


@pytest.mark.parametrize("variant", ["TD", "TT"])
def test_roundoff_indefinite_recovers_via_shift(variant):
    A, B = nonspd_pencil(N, min_eig=-1e-8)
    res = solve(_t(A), _t(B), S, variant=variant, on_failure="warn",
                device="cpu")
    assert torch.isfinite(res.evals).all() and torch.isfinite(res.X).all()
    assert res.info["health"]["healthy"] is True
    assert res.info["gs1_shift"] > 0.0
    rungs = [r for r in res.info["recovery"]
             if r["action"] == "cholesky_shift"]
    assert rungs and rungs[-1]["outcome"] == "recovered"
    ref = j_solve(jnp.asarray(A), jnp.asarray(B), S, variant=variant,
                  on_failure="warn")
    assert res.info["recovery"] == ref.info["recovery"]
    assert res.info["gs1_shift"] == ref.info["gs1_shift"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_near_breakdown_no_silent_nan(variant, precision):
    """cond(B) ~ 1e10: a clean solve, a shift rescue or a diagnosed failure,
    never a silent NaN eigenpair; the outcome kind is the reference's."""
    A, B = near_breakdown_pencil(N)
    kw = dict(variant=variant, precision=precision, on_failure="warn",
              max_restarts=80)
    try:
        res = solve(_t(A), _t(B), S, device="cpu", **kw)
    except SolverError as err:
        assert err.diagnosis["reason"] in (
            "cholesky_breakdown", "nonfinite_stage", "nonfinite_output")
        got = ("raise", err.diagnosis["stage"], err.diagnosis["reason"])
    else:
        assert torch.isfinite(res.evals).all() and torch.isfinite(res.X).all()
        assert "health" in res.info and "recovery" in res.info
        json.dumps(res.info)
        got = ("ok",)
    ref = _outcome(lambda: j_solve(jnp.asarray(A), jnp.asarray(B), S, **kw))
    assert got == ref[:len(got)]


# ------------------------------------------------- stage-targeted NaN --

@pytest.mark.parametrize("stage,kwargs", [
    ("GS1", dict(variant="TD")),
    ("GS2", dict(variant="TD")),
    ("TD1", dict(variant="TD")),
    ("TT1", dict(variant="TT")),
    ("KE_iter", dict(variant="KE", invert=True)),
    ("KI_iter", dict(variant="KI", invert=True)),
])
def test_persistent_poison_is_diagnosed(stage, kwargs):
    """A persistent NaN fault at any stage ends in a SolverError naming
    that stage, the reference's diagnosis."""
    p, tp = _md()
    with inject(NanPoison(stage)):
        with pytest.raises(SolverError) as exc:
            solve(tp.A, tp.B, S, on_failure="warn", device="cpu", **kwargs)
    d = exc.value.diagnosis
    assert d["reason"] == "nonfinite_stage" and d["stage"] == stage
    assert d["health"]["healthy"] is False
    assert d["health"]["first_unhealthy_stage"] == stage
    with j_faults.inject(j_faults.NanPoison(stage)):
        ref = _outcome(lambda: j_solve(p.A, p.B, S, on_failure="warn",
                                       **kwargs))
    assert ref == ("raise", stage, "nonfinite_stage", [])


def test_transient_poison_retried_under_recover():
    p, tp = _md()
    with inject(NanPoison("GS2", once=True)):
        res = solve(tp.A, tp.B, S, variant="TD", on_failure="recover",
                    device="cpu")
    assert res.info["health"]["healthy"] is True
    retries = [r for r in res.info["recovery"]
               if r["action"] == "transient_retry"]
    assert retries and retries[-1]["outcome"] == "recovered"
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(
        p.exact_evals[:S]), rtol=1e-7, atol=1e-9)
    json.dumps(res.info)
    with j_faults.inject(j_faults.NanPoison("GS2", once=True)):
        ref = j_solve(p.A, p.B, S, variant="TD", on_failure="recover")
    assert res.info["recovery"] == ref.info["recovery"]


def test_persistent_poison_exhausts_retries():
    p, tp = _md()
    with inject(NanPoison("GS2")):
        with pytest.raises(SolverError) as exc:
            solve(tp.A, tp.B, S, variant="TD", on_failure="recover",
                  max_retries=2, device="cpu")
    trail = exc.value.diagnosis["recovery"]
    assert sum(r["action"] == "transient_retry" for r in trail) == 2
    with j_faults.inject(j_faults.NanPoison("GS2")):
        ref = _outcome(lambda: j_solve(p.A, p.B, S, variant="TD",
                                       on_failure="recover", max_retries=2))
    assert ref == ("raise", "GS2", "nonfinite_stage",
                   [r["action"] for r in trail])


# ------------------------------------------------- forced nonconvergence --

def test_nonconvergence_ladder_falls_back_to_tt():
    p, tp = _md()
    with inject(ForceNonconverge()):
        res = solve(tp.A, tp.B, S, variant="KE", invert=True,
                    on_failure="recover", device="cpu")
    actions = [r["action"] for r in res.info["recovery"]]
    assert "escalate_krylov" in actions and "fallback_variant" in actions
    assert res.info["variant"] == "TT"
    assert res.info.get("converged", True)
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(
        p.exact_evals[:S]), rtol=1e-7, atol=1e-9)
    with j_faults.inject(j_faults.ForceNonconverge()):
        ref = j_solve(p.A, p.B, S, variant="KE", invert=True,
                      on_failure="recover")
    assert actions == [r["action"] for r in ref.info["recovery"]]


def test_nonconvergence_warn_mode_retires_with_warning():
    _, tp = _md()
    with inject(ForceNonconverge()):
        res = solve(tp.A, tp.B, S, variant="KE", invert=True,
                    on_failure="warn", device="cpu")
    assert not res.info["converged"]
    assert any("UNCONVERGED" in w for w in res.info["warnings"])
    assert res.info["recovery"] == []


# ------------------------------------------------- the harness itself --

def test_inject_disarms_on_exit():
    assert faults.active("nan") is None
    with inject(NanPoison("GS1")):
        assert faults.active("nan") is not None
        with pytest.raises(RuntimeError):
            with inject(ForceNonconverge()):
                assert faults.active("nan") is not None
                assert faults.active("nonconverge") is not None
                raise RuntimeError("boom")
        assert faults.active("nonconverge") is None
    assert faults.active("nan") is None


def test_nan_poison_is_deterministic():
    f1 = NanPoison("GS1", seed=7)
    f2 = NanPoison("GS1", seed=7)
    x = torch.ones((8, 8), dtype=torch.float64)
    torch.testing.assert_close(f1.apply("GS1", x), f2.apply("GS1", x),
                               equal_nan=True)
    # an untouched stage passes through by identity
    assert f1.apply("GS2", x) is x


def test_unarmed_seams_pass_inputs_through():
    x = torch.ones((4, 4), dtype=torch.float64)
    assert faults.poison_stage("GS1", x) is x
    assert faults.force_nonconverge(1e-9, 7) == (1e-9, 7)
    with inject(ForceNonconverge(max_restarts_cap=2)):
        assert faults.force_nonconverge(1e-9, 7) == (1e-300, 2)
