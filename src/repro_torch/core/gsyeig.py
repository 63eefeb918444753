"""Top-level GSYEIG solver: A X = B X Lambda, s << n wanted eigenpairs.

The port carries the paper's four variants:
  TD — Cholesky (GS1), standard form by two triangular solves (GS2),
       Householder tridiagonalization (TD1), Sturm bisection and inverse
       iteration on the CUDA kernels (TD2), the reflector back-transform
       (TD3) and U^{-1} (BT1);
  TT — GS1, GS2, reduction to a band of width ``band_width`` (TT1: panel
       QR and SYR2K update kernels), the wavefront bulge chase to
       tridiagonal (TT2: one chase kernel launch per bandwidth pass), TD2's
       eigensolver (TT3), the replayed rotations and Q1 (TT4), BT1;
  KE — GS1, GS2, thick-restart block Lanczos on the explicit C (KE_iter),
       BT1;
  KI — GS1, Lanczos on the implicit C = U^{-T} A U^{-1} (no GS2), BT1.
With ``use_kernel=True`` every Krylov matvec runs the one-triangle CUDA
kernel (``kernels/symv``); the default ``False`` is ``torch.matmul`` on the
full matrix, as the reference's default is XLA's dot.

``precision="mixed"`` (fp32) and ``"fast"`` (bf16, fp32 accumulation) run
the GEMM-heavy stages in the compute dtype, as the reference does: C is
demoted before TD1/TT1, TT2 and TT4 run in it (the fp32/bf16 instances of
``house_panel``, ``syr2k``, ``chase_pass`` and ``replay_pass`` on the
card), the tridiagonal goes back to fp64 for TD2/TT3, and the Krylov
operator is demoted (``symm_block``'s fp32/bf16 instances). GS1, GS2,
TD2/TT3, BT1 and all convergence math stay fp64, and fp64 refinement
against the original pencil (``core.refinement``, stage ``RF``) restores
the Table-3 accuracy. The blocked GS1/GS2 stay fp64 at every level; the
blocked TD1 runs in the compute dtype on ``syr2k``'s instance.

Fault injection (``resilience.faults``) hooks in at the reference's seams:
the inputs of GS1, GS2, TD1, TT1 and of the KE/KI operators, and the
Krylov knobs (``force_nonconverge``).

The paper's blocked alternatives (its Table 4) run on the port's block
kernels: ``gs1="blocked"`` the right-looking blocked Cholesky,
``gs2="sygst"`` the blocked DSYGST, both at ``block`` (256, the
reference's default), and ``td1="blocked"`` the dlatrd-style panel
tridiagonalization at a panel of 32 (``trsm``, ``gemm`` and ``syr2k`` on
the card); the defaults are the fused library factorization, the two
triangular solves and the unblocked TD1.

``variant="auto"`` asks the cost model's router
(``analysis.variant_model.choose_variant``, on ``machine``; ``None`` is
the reference's multicore regime, ``MachineParams.h100()`` the card) for
the variant it predicts fastest, and records the decision in
``info['router']``.

``which='smallest'|'largest'`` selects the end of the spectrum;
``invert=True`` applies the paper's MD trick (solve the inverse pair
(B, A) for its largest eigenpairs — valid when A is also SPD — and map
back). Every stage is timed to the end of its work on the device
(``stage_times`` keys GS1 GS2 TD1 TD2 TD3 BT1 Tot. for TD, GS1 GS2 TT1 TT2
TT3 TT4 BT1 Tot. for TT, GS1 GS2 KE_iter BT1 Tot. for KE, GS1 KI_iter BT1
Tot. for KI).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch import kernels as _kernels
from repro_torch.kernels import _launches
from repro_torch.device import resolve_device, synchronize
from repro_torch.resilience import faults
from repro_torch.resilience.health import (array_finite, chol_health,
                                           host_finite, verdict_from_stages)
from repro_torch.resilience.recovery import (SolverError, cholesky_shift_taus,
                                             rung, validate_on_failure)

from .back_transform import back_transform_generalized
from .cholesky import cholesky_blocked, cholesky_upper, diag_shifted
from .lanczos import default_subspace, lanczos_solve
from .operators import ExplicitC, ImplicitC
from .precision import (check_fp32_matmul, compute_dtype, ensure_strong,
                        validate_precision)
from .refinement import REFINE_TOL, refine_eigenpairs
from .residuals import b_normalize
from .sbr import apply_q2, band_chase, default_n_chunks, reduce_to_band
from .standard_form import to_standard_sygst, to_standard_two_trsm
from .tridiag import apply_q, tridiagonalize, tridiagonalize_blocked
from .tridiag_eig import eigh_tridiag_selected

VARIANTS = ("TD", "TT", "KE", "KI")

#: seed of the default start blocks: TD2's inverse iteration, and the
#: Lanczos start block and filter probe (the reference's key)
SOLVE_SEED = 20120520

#: the kernel families of the TT1 sweep, whose launches (of the instance
#: of the compute dtype) ``info['tt1']`` reports
_TT1_KERNELS = ("house_panel", "syr2k")


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


def _chol_blocked_fused(B, block):
    U = cholesky_blocked(B, block)
    ok, _ = chol_health(U)
    return U, ok


def _gs2_trsm_fused(A, U):
    C = to_standard_two_trsm(A, U)
    return C, array_finite(C)


def _gs2_sygst_fused(A, U, block):
    C = to_standard_sygst(A, U, block=block)
    return C, array_finite(C)


def _check_options(variant: str, which: str, gs1: str, gs2: str,
                   td1: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got {which!r}")
    for name, value, known in (("gs1", gs1, ("fused", "blocked")),
                               ("gs2", gs2, ("trsm", "sygst")),
                               ("td1", td1, ("unblocked", "blocked"))):
        if value not in known:
            raise ValueError(f"{name} must be one of {known}, got {value!r}")


def _solve_once(A, B, s: int, *, variant: str, which: str, invert: bool,
                gs1: str, gs2: str, td1: str, band_width: int, block: int,
                m, tol: float,
                max_restarts: int, use_kernel: bool, clustered: bool,
                krylov_block, filter, x0, v0, probe_v0,  # noqa: A002
                generator, precision: str, refine, refine_tol: float,
                refine_max_steps: int, guard0, on_failure: str,
                recovery: list, device: torch.device,
                mesh=None) -> GSyEigResult:
    """One attempt of the pipeline. Stage verdicts land in
    ``info['_stage_health']`` for ``solve`` to fold into ``info['health']``;
    a breakdown or non-finite stage raises a diagnosed ``SolverError``
    unless ``on_failure == 'ignore'``."""
    validate_precision(precision)
    _check_options(variant, which, gs1, gs2, td1)
    cdtype = compute_dtype(precision)
    demoted = precision != "fp64"
    if demoted:
        check_fp32_matmul(precision)
    if refine is None:
        refine = demoted
    A = ensure_strong(A, device)
    B = ensure_strong(B, device)
    n = A.shape[0]
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(SOLVE_SEED)
    stage_health: Dict[str, bool] = {}
    times: Dict[str, float] = {}
    info: Dict[str, Any] = {"variant": variant, "n": n, "s": s,
                            "invert": invert, "which": which,
                            "precision": precision, "device": str(device)}
    # Krylov knobs: block size p (1 on one device, 4 on a mesh) and the
    # start filter degree (16 on a clustered wanted end, else off)
    p = krylov_block if krylov_block is not None else (
        4 if mesh is not None else 1)
    filter_degree = filter if filter is not None else (16 if clustered else 0)
    if variant in ("KE", "KI"):
        info["krylov"] = {"p": int(p), "filter_degree": int(filter_degree)}

    A_orig, B_orig, which_orig = A, B, which
    if invert:
        A, B = B, A
        which = "largest" if which == "smallest" else "smallest"

    def fail(stage, reason, message, hint):
        stage_health[stage] = False
        raise SolverError(message, stage=stage, reason=reason, hint=hint,
                          recovery=recovery,
                          health=verdict_from_stages(stage_health).as_json_dict())

    refine_cfg = (dict(tol=refine_tol, max_steps=refine_max_steps,
                       guard0=guard0) if refine else None)
    if mesh is not None:
        if m is None:
            m = default_subspace(s, n, p)
        elif p > 1 and m % p:
            m = -(-m // p) * p          # block-align a user-supplied m
        lam, X = _solve_on_mesh(
            A, B, s, mesh, variant=variant, which=which, gs2=gs2,
            use_kernel=use_kernel, band_width=band_width, m=m, tol=tol,
            max_restarts=max_restarts, p=p, filter_degree=filter_degree,
            x0=x0, v0=v0, probe_v0=probe_v0, generator=generator,
            precision=precision, times=times, info=info, fail=fail,
            stage_health=stage_health, on_failure=on_failure)
        info["_stage_health"] = stage_health
        return _finalize(lam, X, A_orig, B_orig, which_orig, invert, times,
                         info, refine_cfg, device)

    # ---- GS1: B = U^T U --------------------------------------------------
    B = faults.poison_stage("GS1", B)
    if gs1 == "blocked":
        U, gs1_ok = _timed(times, "GS1", device)(_chol_blocked_fused, B,
                                                 block)
    else:
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

    # ---- GS2: C = U^{-T} A U^{-1} (not for KI) ---------------------------
    C = None
    if variant in ("TD", "TT", "KE"):
        Ag = faults.poison_stage("GS2", A)
        if gs2 == "sygst":
            C, gs2_ok = _timed(times, "GS2", device)(_gs2_sygst_fused, Ag, U,
                                                     block)
        else:
            C, gs2_ok = _timed(times, "GS2", device)(_gs2_trsm_fused, Ag, U)
        del Ag
        stage_health["GS2"] = bool(gs2_ok)
        if not stage_health["GS2"] and on_failure != "ignore":
            fail("GS2", "nonfinite_stage",
                 "non-finite standard-form C after GS2",
                 "non-finite A, or U from a near-breakdown GS1; transient "
                 "corruption is retryable under on_failure='recover'")

    if variant == "TD":
        # ---- TD1 / TD2 / TD3 ---------------------------------------------
        ks = (torch.arange(s, device=device) if which == "smallest"
              else torch.arange(n - s, n, device=device))
        # the reflector stages run in the compute dtype; TD2 in fp64
        C = faults.poison_stage("TD1", C.to(cdtype))
        if td1 == "blocked":
            res = _timed(times, "TD1", device)(tridiagonalize_blocked, C,
                                               panel=32)
        else:
            res = _timed(times, "TD1", device)(tridiagonalize, C)
        del C
        # host sentinel on the (n,)/(n-1,) tridiagonal the TD2 stage reads
        stage_health["TD1"] = host_finite(res.d, res.e)
        if not stage_health["TD1"] and on_failure != "ignore":
            fail("TD1", "nonfinite_stage", "non-finite tridiagonal after TD1",
                 "corrupted C entering the reflector sweep (upstream NaN)")
        lam, Z = _timed(times, "TD2", device)(
            eigh_tridiag_selected, res.d.double(), res.e.double(), ks, x0=x0,
            generator=generator)
        Y = _timed(times, "TD3", device)(apply_q, res, Z.to(cdtype)).double()
        del res
    elif variant == "TT":
        # ---- TT1 / TT2 / TT3 / TT4 ---------------------------------------
        ks = (torch.arange(s, device=device) if which == "smallest"
              else torch.arange(n - s, n, device=device))
        n_chunks = default_n_chunks(n, band_width)
        C = faults.poison_stage("TT1", C.to(cdtype))
        l0 = _kernels.launch_counts()
        band = _timed(times, "TT1", device)(reduce_to_band, C, w=band_width,
                                            n_chunks=n_chunks)
        del C
        l1 = _kernels.launch_counts()
        tt1 = [_launches.instance(k, cdtype) for k in _TT1_KERNELS]
        info["tt1"] = {"n_chunks": int(n_chunks),
                       "kernel_launches": {k: l1[k] - l0[k] for k in tt1}}
        # host sentinel on the (w+1, n) band the chase consumes
        stage_health["TT1"] = host_finite(band.Wb)
        if not stage_health["TT1"] and on_failure != "ignore":
            fail("TT1", "nonfinite_stage",
                 "non-finite band matrix after the TT1 sweep",
                 "corrupted C entering the panel sweep (upstream NaN)")
        chase = _timed(times, "TT2", device)(band_chase, band.Wb, band_width)
        stage_health["TT2"] = host_finite(chase.d, chase.e)
        if not stage_health["TT2"] and on_failure != "ignore":
            fail("TT2", "nonfinite_stage",
                 "non-finite tridiagonal after the TT2 chase",
                 "the rotation wavefront hit non-finite band entries")
        lam, Z = _timed(times, "TT3", device)(
            eigh_tridiag_selected, chase.d.double(), chase.e.double(), ks,
            x0=x0, generator=generator)
        Y = _timed(times, "TT4", device)(
            lambda: band.Q1 @ apply_q2(chase, Z.to(cdtype), band_width))
        Y = Y.double()
        del band, chase
    else:
        # ---- KE_iter / KI_iter: thick-restart block Lanczos --------------
        stage = f"{variant}_iter"
        op = (ExplicitC(faults.poison_stage("KE_iter", C)) if variant == "KE"
              else ImplicitC(faults.poison_stage("KI_iter", A), U))
        del C
        if m is None:
            m = default_subspace(s, n, p)
        elif p > 1 and m % p:
            m = -(-m // p) * p          # block-align a user-supplied m
        tol, max_restarts = faults.force_nonconverge(tol, max_restarts)
        lres = _timed(times, stage, device)(
            lanczos_solve, op, s, which="SA" if which == "smallest" else "LA",
            m=m, tol=tol, max_restarts=max_restarts, use_kernel=use_kernel,
            v0=v0, probe_v0=probe_v0, generator=generator, p=p,
            filter_degree=filter_degree,
            compute_dtype=cdtype if demoted else None)
        del op
        # plain Python only: info must survive json.dumps
        info.update(n_matvec=int(lres.n_matvec),
                    n_restart=int(lres.n_restart),
                    converged=bool(lres.converged),
                    resid_bounds=[float(r) for r in lres.resid_bounds.tolist()])
        stage_health[stage] = bool(lres.healthy)
        if not lres.healthy and on_failure != "ignore":
            fail(stage, "nonfinite_stage",
                 f"{variant} restart state went non-finite after "
                 f"{int(lres.n_restart)} restarts",
                 "NaN/inf in the Lanczos basis — corrupted operator; "
                 "transient corruption is retryable under "
                 "on_failure='recover'")
        if not lres.converged:
            info.setdefault("warnings", []).append(
                f"{variant} retired UNCONVERGED after {int(lres.n_restart)} "
                f"restarts (max_restarts={max_restarts}); eigenpairs are "
                f"the best Ritz approximations at exit")
        # Lanczos returns the wanted end first; sort ascending like TD
        order = torch.argsort(lres.evals)
        lam, Y = lres.evals[order], lres.evecs[:, order]

    # ---- BT1: X = U^{-1} Y -----------------------------------------------
    X = _timed(times, "BT1", device)(back_transform_generalized, U, Y)
    info["_stage_health"] = stage_health
    return _finalize(lam, X, A_orig, B_orig, which_orig, invert, times, info,
                     refine_cfg, device)


def _solve_on_mesh(A, B, s: int, mesh, *, variant: str, which: str,
                   gs2: str, use_kernel: bool, band_width: int, m: int,
                   tol: float, max_restarts: int, p: int, filter_degree: int,
                   x0, v0, probe_v0, generator, precision: str, times: dict,
                   info: dict, fail, stage_health: dict, on_failure: str):
    """The distributed KE or TT (``repro_torch.dist.eigensolver``) on
    ``mesh``, called the same way on every rank; (lam, X) replicated."""
    if variant not in ("KE", "TT"):
        raise NotImplementedError(f"mesh= implements the KE and TT "
                                  f"variants, got {variant}")
    if gs2 != "trsm" or use_kernel:
        raise NotImplementedError(
            "mesh= implements gs2='trsm' without the one-triangle product "
            "kernel (use_kernel=False)")
    from repro_torch.dist.eigensolver import (solve_ke_distributed,
                                              solve_tt_distributed)
    if variant == "KE":
        lam, X, dinfo = solve_ke_distributed(
            mesh, A, B, s, m=m, which=which, tol=tol,
            max_restarts=max_restarts, v0=v0, probe_v0=probe_v0,
            generator=generator, return_info=True, p=p,
            filter_degree=filter_degree, precision=precision)
    else:
        lam, X, dinfo = solve_tt_distributed(
            mesh, A, B, s, which=which, band_width=band_width, x0=x0,
            generator=generator, return_info=True, precision=precision)
    times.update(dinfo.pop("stage_times"))
    info.update(dinfo)
    stage = f"{variant}_dist"
    stage_health[stage] = bool(dinfo.get("healthy", True))
    if not stage_health[stage] and on_failure != "ignore":
        fail(stage, "nonfinite_stage",
             f"distributed {variant} produced a non-finite restart state",
             "probable GS1 breakdown (non-SPD B) or overflow in a demoted "
             "stage; retry with precision='fp64' or check the pencil")
    if not info.get("converged", True):
        info.setdefault("warnings", []).append(
            f"{variant} retired UNCONVERGED after "
            f"{info.get('n_restart', max_restarts)} restarts "
            f"(max_restarts={max_restarts}); eigenpairs are the best Ritz "
            f"approximations at exit")
    return lam, X


def _finalize(lam, X, A_orig, B_orig, which_orig: str, invert: bool,
              times: Dict[str, float], info: Dict[str, Any],
              refine_cfg: Dict[str, Any] | None,
              device: torch.device) -> GSyEigResult:
    """Undo the inverse-pair trick, refine against the original fp64
    pencil when asked (stage ``RF``), and total the stage timings."""
    if invert:
        lam = 1.0 / lam
        order = torch.argsort(lam)
        lam, X = lam[order], X[:, order]
        # the inverse-pair solve returns A-orthonormal vectors; renormalize
        # each column to unit B-norm for the original problem's metric
        X = b_normalize(X, B_orig)
    if refine_cfg is not None:
        lam, X, info["refinement"] = _timed(times, "RF", device)(
            refine_eigenpairs, A_orig, B_orig, lam, X, which=which_orig,
            **refine_cfg)
    times["Tot."] = float(sum(v for k, v in times.items() if k != "Tot."))
    return GSyEigResult(evals=lam, X=X, stage_times=times, info=info)


def solve(A, B, s: int, variant: str = "TD", which: str = "smallest",
          invert: bool = False, gs2: str = "trsm", gs1: str = "fused",
          td1: str = "unblocked", band_width: int = 16, block: int = 256,
          m: int | None = None, tol: float = 0.0,
          max_restarts: int = 500, use_kernel: bool = False,
          clustered: bool = False, krylov_block: int | None = None,
          filter: int | None = None,  # noqa: A002 — the paper-facing name
          x0: torch.Tensor | None = None, v0: torch.Tensor | None = None,
          probe_v0: torch.Tensor | None = None,
          generator: torch.Generator | None = None, precision: str = "fp64",
          refine: bool | None = None, refine_tol: float = REFINE_TOL,
          refine_max_steps: int = 60, guard0: torch.Tensor | None = None,
          on_failure: str = "warn", max_retries: int = 2,
          machine=None, device=None, mesh=None) -> GSyEigResult:
    """GSYEIG with failure containment, on ``device`` (``None`` = the card;
    without CUDA it raises unless ``device="cpu"`` is passed).

    ``mesh`` (a ``DeviceMesh`` of ``repro_torch.dist.make_mesh``, with a
    'model' axis last) runs the distributed KE or TT
    (``repro_torch.dist.eigensolver``), SPMD: every rank of the mesh calls
    ``solve`` with the same A and B and gets the same result. On a mesh
    ``krylov_block`` defaults to 4, ``variant="auto"`` chooses from KE and
    TT, the other variants, ``gs2="sygst"`` and ``use_kernel`` raise
    ``NotImplementedError``, and ``device`` defaults to the mesh's.

    Krylov knobs (KE/KI), with the reference's defaults: ``m`` the
    subspace size (``None`` = ``default_subspace``), ``tol`` the Ritz
    residual tolerance (0 = machine precision), ``max_restarts``,
    ``use_kernel`` (the one-triangle CUDA matvec), ``krylov_block`` the
    block size p (``None`` = 1), ``filter`` the Chebyshev start-filter
    degree (``None`` = 16 when ``clustered``, else off). ``info['krylov']``
    records p and the degree.

    ``variant="auto"`` picks the variant with the least predicted time
    under the cost model on ``machine`` (a ``MachineParams``; ``None`` =
    the reference's default), at the Krylov knobs resolved above and this
    ``precision``; ``info['router']`` holds the decision and the table of
    predicted totals.

    ``gs1="blocked"``, ``gs2="sygst"`` and ``td1="blocked"`` pick the
    blocked stages; ``block`` is the block of the first two (the
    reference's default, 256).

    ``band_width`` is TT's band (the reference's default, 16); with
    ``variant="TT"``, ``info['tt1']`` records the window ladder's
    ``n_chunks`` and the sweep's kernel launches.

    Random starts: ``x0`` is TD2's (and TT3's) (n, s) inverse-iteration
    start block, in the column order of the sorted wanted indices; ``v0``
    the (n, p) Lanczos start block and ``probe_v0`` the filter probe's
    (n,) vector.
    The reference draws them from ``PRNGKey(20120520)``; parity runs pass
    those in. What is not given is drawn from ``generator``, by default one
    seeded with ``SOLVE_SEED`` on ``device``.

    ``precision``: ``'fp64'`` (default), ``'mixed'`` (fp32) or ``'fast'``
    (bf16 with fp32 accumulation) for the GEMM-heavy stages (module
    docstring). ``refine`` (default: on below fp64) runs fp64 refinement
    of the returned pairs against the original pencil until
    ``refine_tol`` (the Table-3 bar), at most ``refine_max_steps`` steps;
    ``guard0`` is its (n, guard) guard block (the reference draws it from
    ``PRNGKey(1203)``; else a seeded draw). ``info['refinement']`` holds
    its steps and trajectories, ``stage_times['RF']`` its time.

    ``on_failure``: ``'warn'`` (default) diagnoses failures — a GS1
    breakdown tries the diagonal-shift rungs, any remaining non-finite
    stage or output raises ``SolverError``, an unconverged KE/KI retires
    with a warning; ``'recover'`` additionally retries transient
    non-finite failures up to ``max_retries`` times with fresh start
    blocks, escalates an unconverged KE/KI to 4x the restarts and a
    degree >= 16 filter, and if that fails too falls back to TT (the
    ``fallback_variant`` rung), and reruns a demoted solve at fp64 when
    its refinement stalls above tolerance (``escalate_precision``);
    ``'ignore'`` raises
    nothing and still records the verdict. ``info`` carries ``health``,
    ``recovery`` and ``kernel_launches`` (launches of every kernel wrapper
    in this call), and survives ``json.dumps``.
    """
    validate_on_failure(on_failure)
    if mesh is not None:
        from repro_torch.dist.mesh import mesh_device
        dev = mesh_device(mesh)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device!r} is not the mesh's "
                             f"{mesh.device_type!r}")
    else:
        dev = resolve_device(device)
    router = None
    if variant == "auto":
        from repro_torch.analysis.variant_model import (DISTRIBUTED_VARIANTS,
                                                        choose_variant)
        # any mesh (even 1 x 1) narrows the candidates to KE and TT
        choice = choose_variant(
            int(A.shape[0]), s, band_width=band_width, m=m,
            clustered=clustered, machine=machine,
            mesh_shape=tuple(mesh.shape) if mesh is not None else None,
            allow=DISTRIBUTED_VARIANTS if mesh is not None else None,
            krylov_block=krylov_block if krylov_block is not None else (
                4 if mesh is not None else 1),
            filter_degree=(filter if filter is not None
                           else 16 if clustered else 0),
            precision=precision)
        variant = choice.variant
        router = choice.as_json_dict()
    recovery: list = []
    kw: Dict[str, Any] = dict(
        variant=variant, which=which, invert=invert, gs1=gs1, gs2=gs2,
        td1=td1, band_width=band_width, block=block, m=m, tol=tol,
        max_restarts=max_restarts,
        use_kernel=use_kernel, clustered=clustered,
        krylov_block=krylov_block, filter=filter, x0=x0, v0=v0,
        probe_v0=probe_v0, generator=generator, precision=precision,
        refine=refine, refine_tol=refine_tol,
        refine_max_steps=refine_max_steps, guard0=guard0)
    launches0 = _kernels.launch_counts()

    def attempt(attempt_kw):
        res = _solve_once(A, B, s, on_failure=on_failure, recovery=recovery,
                          device=dev, mesh=mesh, **attempt_kw)
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
            kw = dict(kw, x0=None, v0=None, probe_v0=None, generator=fresh)
    if retry_rung is not None:
        retry_rung["outcome"] = "recovered"

    # --- ladder: unconverged Krylov -> escalate -> TT fallback -----------
    if on_failure == "recover" and not res.info.get("converged", True):
        resolved = res.info["variant"]
        fd = int(res.info["krylov"]["filter_degree"])
        esc_restarts = int(max_restarts) * 4
        esc_filter = max(16, fd)
        r = rung("escalate_krylov", f"{resolved}_iter", "attempt",
                 max_restarts=esc_restarts, filter_degree=esc_filter)
        recovery.append(r)
        res2 = attempt(dict(kw, max_restarts=esc_restarts, filter=esc_filter))
        if res2.info["converged"]:
            r["outcome"] = "recovered"
            res = res2
        else:
            r["outcome"] = "failed"
            fb = rung("fallback_variant", f"{resolved}_iter", "attempt",
                      variant="TT")
            recovery.append(fb)
            res = attempt(dict(kw, variant="TT"))
            fb["outcome"] = ("recovered"
                             if res.info.get("converged", True) else "failed")

    # --- ladder: demoted refinement stalled above tol -> fp64 rerun ------
    rinfo = res.info.get("refinement")
    if (on_failure == "recover" and precision != "fp64" and rinfo
            and not rinfo["converged"] and rinfo["stalled"]):
        r = rung("escalate_precision", "RF", "attempt",
                 from_precision=precision, to_precision="fp64")
        recovery.append(r)
        res = attempt(dict(kw, variant=res.info["variant"],
                           precision="fp64", refine=True))
        r["outcome"] = ("recovered" if res.info["refinement"]["converged"]
                        else "failed")
    launches1 = _kernels.launch_counts()
    res.info["kernel_launches"] = {k: launches1[k] - launches0[k]
                                   for k in launches1}
    if router is not None:
        res.info["router"] = router
    return res
