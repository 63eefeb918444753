"""Top-level GSYEIG solver: A X = B X Lambda, s << n wanted eigenpairs.

The port carries the paper's TD variant: Cholesky (GS1), standard form by
two triangular solves (GS2), Householder tridiagonalization (TD1), Sturm
bisection and inverse iteration on the CUDA kernels (TD2), the reflector
back-transform (TD3) and U^{-1} (BT1). TT, KE and KI are not ported yet
and raise (ROADMAP.md §1 items 5-6), as do precisions other than fp64.

``which='smallest'|'largest'`` selects the end of the spectrum;
``invert=True`` applies the paper's MD trick (solve the inverse pair
(B, A) for its largest eigenpairs — valid when A is also SPD — and map
back). Every stage is timed to the end of its work on the device
(``stage_times`` keys GS1 GS2 TD1 TD2 TD3 BT1 Tot.).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.tridiag_eig import kernel as _td2_kernels
from repro_torch.resilience.health import (array_finite, chol_health,
                                           host_finite, verdict_from_stages)
from repro_torch.resilience.recovery import (SolverError, cholesky_shift_taus,
                                             rung, validate_on_failure)

from .back_transform import back_transform_generalized
from .cholesky import cholesky_upper, diag_shifted
from .precision import ensure_strong, validate_precision
from .residuals import b_normalize
from .standard_form import to_standard_two_trsm
from .tridiag import apply_q, tridiagonalize
from .tridiag_eig import eigh_tridiag_selected

VARIANTS = ("TD", "TT", "KE", "KI")

#: seed of the default inverse-iteration start block (the reference's key)
SOLVE_SEED = 20120520

_NOT_PORTED = {
    "TT": "ROADMAP.md §1 item 5 (TT pipeline)",
    "KE": "ROADMAP.md §1 item 6 (KE/KI pipeline)",
    "KI": "ROADMAP.md §1 item 6 (KE/KI pipeline)",
    "auto": "ROADMAP.md §1 item 11 (analysis: the variant router)",
}


@dataclass
class GSyEigResult:
    evals: torch.Tensor              # (s,) ascending (original problem)
    X: torch.Tensor                  # (n, s) B-orthonormal eigenvectors
    stage_times: Dict[str, float] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)


def _timed(times: Dict[str, float], key: str, device: torch.device):
    def wrap(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(device)
        times[key] = times.get(key, 0.0) + (time.perf_counter() - t0)
        return out
    return wrap


def _chol_fused(B):
    U = cholesky_upper(B)
    ok, _ = chol_health(U)
    return U, ok


def _gs2_fused(A, U):
    C = to_standard_two_trsm(A, U)
    return C, array_finite(C)


def _check_options(variant: str, which: str, gs1: str, gs2: str,
                   td1: str) -> None:
    if variant in _NOT_PORTED:
        raise NotImplementedError(
            f"variant={variant!r} is not ported yet ({_NOT_PORTED[variant]})")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    for name, value, ported in (("gs1", gs1, "fused"), ("gs2", gs2, "trsm"),
                                ("td1", td1, "unblocked")):
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP.md §1 item 4); "
                f"the port runs {name}={ported!r}")


def _solve_once(A, B, s: int, *, variant: str, which: str, invert: bool,
                gs1: str, gs2: str, td1: str, x0, generator,
                precision: str, on_failure: str, recovery: list,
                device: torch.device) -> GSyEigResult:
    """One attempt of the TD pipeline. Stage verdicts land in
    ``info['_stage_health']`` for ``solve`` to fold into ``info['health']``;
    a breakdown or non-finite stage raises a diagnosed ``SolverError``
    unless ``on_failure == 'ignore'``."""
    validate_precision(precision)
    _check_options(variant, which, gs1, gs2, td1)
    A = ensure_strong(A, device)
    B = ensure_strong(B, device)
    n = A.shape[0]
    if generator is None and x0 is None:
        generator = torch.Generator(device=device).manual_seed(SOLVE_SEED)
    stage_health: Dict[str, bool] = {}
    times: Dict[str, float] = {}
    info: Dict[str, Any] = {"variant": variant, "n": n, "s": s,
                            "invert": invert, "which": which,
                            "precision": precision, "device": str(device)}

    B_orig = B
    if invert:
        A, B = B, A
        which = "largest" if which == "smallest" else "smallest"

    def fail(stage, reason, message, hint):
        stage_health[stage] = False
        raise SolverError(message, stage=stage, reason=reason, hint=hint,
                          recovery=recovery,
                          health=verdict_from_stages(stage_health).as_json_dict())

    # ---- GS1: B = U^T U --------------------------------------------------
    U, gs1_ok = _timed(times, "GS1", device)(_chol_fused, B)
    gs1_ok = bool(gs1_ok)
    if not gs1_ok and on_failure != "ignore":
        if not host_finite(B):
            fail("GS1", "nonfinite_stage",
                 "non-finite B entering GS1 (Cholesky)",
                 "the input pencil itself is corrupted; transient "
                 "corruption is retryable under on_failure='recover'")
        # degradation ladder, rung 1: relative diagonal-shift retries, one
        # rung at a time (three n x n candidates at once would cost 3 n^2
        # of device memory at the paper's sizes)
        for tau in cholesky_shift_taus():
            Ut, ok = _timed(times, "GS1", device)(_chol_fused,
                                                  diag_shifted(B, tau))
            if bool(ok):
                recovery.append(rung("cholesky_shift", "GS1", "recovered",
                                     tau=float(tau)))
                info["gs1_shift"] = float(tau)
                U, gs1_ok = Ut, True
                break
            recovery.append(rung("cholesky_shift", "GS1", "failed",
                                 tau=float(tau)))
        if not gs1_ok:
            fail("GS1", "cholesky_breakdown",
                 "GS1 Cholesky breakdown: B is not SPD (all diagonal-shift "
                 "rungs failed)",
                 "check the B operand — the generalized problem requires B "
                 "symmetric positive definite; shifts up to "
                 f"tau={cholesky_shift_taus()[-1]:g}*max|diag B| did not "
                 "rescue it")
    stage_health["GS1"] = gs1_ok

    # ---- GS2: C = U^{-T} A U^{-1} ----------------------------------------
    C, gs2_ok = _timed(times, "GS2", device)(_gs2_fused, A, U)
    stage_health["GS2"] = bool(gs2_ok)
    if not stage_health["GS2"] and on_failure != "ignore":
        fail("GS2", "nonfinite_stage", "non-finite standard-form C after GS2",
             "non-finite A, or U from a near-breakdown GS1; transient "
             "corruption is retryable under on_failure='recover'")

    # ---- TD1 / TD2 / TD3 -------------------------------------------------
    ks = (torch.arange(s, device=device) if which == "smallest"
          else torch.arange(n - s, n, device=device))
    res = _timed(times, "TD1", device)(tridiagonalize, C)
    del C
    # host sentinel on the (n,)/(n-1,) tridiagonal the TD2 stage reads
    stage_health["TD1"] = host_finite(res.d, res.e)
    if not stage_health["TD1"] and on_failure != "ignore":
        fail("TD1", "nonfinite_stage", "non-finite tridiagonal after TD1",
             "corrupted C entering the reflector sweep (upstream NaN)")
    lam, Z = _timed(times, "TD2", device)(eigh_tridiag_selected, res.d, res.e,
                                         ks, x0=x0, generator=generator)
    Y = _timed(times, "TD3", device)(apply_q, res, Z)
    del res

    # ---- BT1: X = U^{-1} Y -----------------------------------------------
    X = _timed(times, "BT1", device)(back_transform_generalized, U, Y)
    info["_stage_health"] = stage_health
    return _finalize(lam, X, B_orig, invert, times, info)


def _finalize(lam, X, B_orig, invert: bool, times: Dict[str, float],
              info: Dict[str, Any]) -> GSyEigResult:
    """Undo the inverse-pair trick and total the stage timings."""
    if invert:
        lam = 1.0 / lam
        order = torch.argsort(lam)
        lam, X = lam[order], X[:, order]
        # the inverse-pair solve returns A-orthonormal vectors; renormalize
        # each column to unit B-norm for the original problem's metric
        X = b_normalize(X, B_orig)
    times["Tot."] = float(sum(v for k, v in times.items() if k != "Tot."))
    return GSyEigResult(evals=lam, X=X, stage_times=times, info=info)


def solve(A, B, s: int, variant: str = "TD", which: str = "smallest",
          invert: bool = False, gs2: str = "trsm", gs1: str = "fused",
          td1: str = "unblocked", x0: torch.Tensor | None = None,
          generator: torch.Generator | None = None, precision: str = "fp64",
          on_failure: str = "warn", max_retries: int = 2,
          device=None) -> GSyEigResult:
    """GSYEIG with failure containment, on ``device`` (``None`` = the card;
    without CUDA it raises unless ``device="cpu"`` is passed).

    ``x0`` is the (n, s) inverse-iteration start block, in the column
    order of the sorted wanted indices (the reference draws it from
    ``PRNGKey(20120520)``; parity runs pass that block in). Without it the
    block is drawn from ``generator``, by default one seeded with
    ``SOLVE_SEED`` on ``device``.

    ``on_failure``: ``'warn'`` (default) diagnoses failures — a GS1
    breakdown tries the diagonal-shift rungs, any remaining non-finite
    stage or output raises ``SolverError``; ``'recover'`` additionally
    retries transient non-finite failures up to ``max_retries`` times with
    a fresh start block; ``'ignore'`` raises nothing and still records the
    verdict. ``info`` carries ``health``, ``recovery`` and
    ``kernel_launches`` (launches of each TD2 kernel in this call), and
    survives ``json.dumps``.
    """
    validate_on_failure(on_failure)
    dev = resolve_device(device)
    recovery: list = []
    kw: Dict[str, Any] = dict(variant=variant, which=which, invert=invert,
                              gs1=gs1, gs2=gs2, td1=td1, x0=x0,
                              generator=generator, precision=precision)
    launches0 = _td2_kernels.launch_counts()

    def attempt(attempt_kw):
        res = _solve_once(A, B, s, on_failure=on_failure, recovery=recovery,
                          device=dev, **attempt_kw)
        stages = res.info.pop("_stage_health", {})
        # final output sentinel on the (s,)/(n, s) results
        out_ok = host_finite(res.evals, res.X)
        stages["OUT"] = out_ok
        res.info["health"] = verdict_from_stages(stages).as_json_dict()
        res.info["recovery"] = recovery
        if not out_ok and on_failure != "ignore":
            raise SolverError(
                "solver produced non-finite eigenpairs", stage="OUT",
                reason="nonfinite_output",
                hint="every stage sentinel passed but the output is "
                     "corrupt — suspect the back-transform operands; "
                     "transient corruption is retryable under "
                     "on_failure='recover'", recovery=recovery,
                health=res.info["health"])
        return res

    retries = 0
    retry_rung = None
    while True:
        try:
            res = attempt(kw)
            break
        except SolverError as err:
            transient = err.diagnosis["reason"] in ("nonfinite_stage",
                                                    "nonfinite_output")
            if not (on_failure == "recover" and transient
                    and retries < max_retries):
                raise
            retries += 1
            retry_rung = rung("transient_retry", err.diagnosis["stage"],
                              "attempt", attempt=retries)
            recovery.append(retry_rung)
            fresh = torch.Generator(device=dev).manual_seed(
                SOLVE_SEED + 1000 + retries)
            kw = dict(kw, x0=None, generator=fresh)
    if retry_rung is not None:
        retry_rung["outcome"] = "recovered"
    launches1 = _td2_kernels.launch_counts()
    res.info["kernel_launches"] = {k: launches1[k] - launches0[k]
                                   for k in launches1}
    return res
