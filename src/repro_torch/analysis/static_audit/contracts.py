"""The port's budget contracts: every entry point of the reference's audit,
registered (``repro.analysis.static_audit.contracts`` in torch).

The named constants and budget functions keep the reference's names and
values (``tests/test_torch_audit.py`` reads the reference's with ``ast``
and holds these to them). ``register_all`` registers one entry per
reference entry, 28 in all, each RUN at the small :class:`AuditSpec` on
the device asked for (``profile`` says what is counted). The contracts are
structural (kernel calls of a stage, collectives a panel or a block step,
stage entries, the dtype policy), so the small spec proves the invariants
the production shapes rely on.

Each number of a contract comes from a reference constant or from the
port's own schedule code (``sbr._n_panels``, ``sbr._executed_passes``,
``tridiag_eig.kernel.LAUNCHES_PER_ROUND``, ...), cited beside it; none is
measured and pinned.

Constants with no counterpart here, and why:

* ``TT1_FUSED_MAX_DISPATCHES`` (3) and ``TT1_STEPWISE_DISPATCHES_PER_PANEL``
  (4) count the fused JAX programs of the TT1 sweep against its per-panel
  baseline. The port's sweep is one host loop that queues two kernels a
  panel: its entry counts 1 sweep entered (``sbr.dispatch_count``) and
  ``2 x _n_panels`` kernel calls.
* ``KE_HLO_ALL_REDUCE_MAX``, ``KE_HLO_ALL_GATHER_MAX`` and
  ``TT3_HLO_ALL_GATHER_MAX`` count collectives in the lowered StableHLO
  text (a loop body once). There is no lowered text; the port's contracts
  count every collective as it runs.
* ``make_mesh_2dev``: the mesh entries run inside the ranks of a world
  that ``launch/audit.py`` spawns (``dist.launcher.run_local``), on the
  mesh it builds.
"""
from __future__ import annotations

import dataclasses
import inspect
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from .profile import mark_step
from .registry import (AuditEntry, BudgetContract, DEFAULT_ALLOWED_DTYPES,
                       ProgramSpec, register)

# ------------------------------------------------------------------------
# published budget constants: the reference's names and values
# ------------------------------------------------------------------------

#: collectives ONE panel of the distributed TT1 sweep runs: all_gather
#: (panel) + all_reduce (coupling) + all_gather (Z)
#: (``dist/sharded_la.py::band_sweep``)
TT1_COLLECTIVES_PER_PANEL = 3
#: the block Lanczos of the distributed KE: collectives a p-column block
#: step of the tile product (one all_reduce + one all_gather,
#: ``dist/eigensolver.py::_fused_block_matvec``)
KE_COLLECTIVES_PER_BLOCK_STEP = 2
#: host reads and stage entries the health sentinels may ADD to a path:
#: pinned to 0, every stage-boundary verdict is a device tensor computed
#: inside a stage that runs anyway (``resilience.health``). The audit holds
#: both sides: ``min_isfinite_sites`` proves the sentinel is present, this
#: constant that it is free.
SENTINEL_EXTRA_DISPATCHES = 0

#: dtypes the mixed-precision (fp32 compute) pipelines may mention on top
#: of the fp64 set: the demoted stages and the fp32 LU of the refinement
MIXED_ALLOWED_DTYPES: Tuple[str, ...] = DEFAULT_ALLOWED_DTYPES + ("float32",)
#: the fast (bf16 storage / fp32 accumulation) pipelines also carry
#: bfloat16 operands
FAST_ALLOWED_DTYPES: Tuple[str, ...] = MIXED_ALLOWED_DTYPES + ("bfloat16",)


def ke_dispatch_budget(n_restart: int) -> int:
    """Stage entries of the fused distributed Krylov stage: one per thick
    restart, plus its prep (bounds probe and Chebyshev filter) and the
    final Ritz extraction (``dist.eigensolver.dispatch_count``)."""
    return n_restart + 2


def lanczos_block_dispatch_budget(n_restart: int) -> int:
    """Stage entries of a block Krylov solve: a segment and a restart
    each restart, plus two for the probe and the filter (or the fixed-trip
    loop's first segment and its start)."""
    return 2 * n_restart + 2


def lanczos_single_dispatch_budget(n_restart: int) -> int:
    """The reference's budget of its legacy per-stage local loop:
    segment, restart math and convergence check each restart, plus
    startup and finish."""
    return 3 * n_restart + 4


def tt3_dist_collectives(iters: int) -> int:
    """Collective total of the spectrum-partitioned TT3: ONE lam
    all_gather + one Z all_gather per inverse-iteration round."""
    return 1 + iters


# ------------------------------------------------------------------------
# canonical audit spec
# ------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """The shapes every contract is run at: the reference's. Small on
    purpose, since the contracts are structural."""
    n: int = 64
    s: int = 4
    w: int = 8
    p: int = 4            # Lanczos block size
    m: int = 24           # Lanczos subspace
    kb: int = 12          # Chebyshev bound-probe steps
    filter_degree: int = 8
    tt3_iters: int = 3    # inverse-iteration rounds
    tt3_max_iters: int = 80
    batch: int = 2        # solve_batched bucket batch
    dtype_name: str = "float64"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def as_json_dict(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------------
# inputs: the same values on every device, from numpy seeds
# ------------------------------------------------------------------------

def _normal(shape, seed: int, device) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(device)


def _sym(n: int, seed: int, device) -> torch.Tensor:
    M = _normal((n, n), seed, device)
    return 0.5 * (M + M.mT)


def _spd(n: int, seed: int, device) -> torch.Tensor:
    M = _normal((n, n), seed, device) / n ** 0.5
    return M @ M.mT + torch.eye(n, dtype=torch.float64, device=device)


def _rotations(g: int, seed: int, device) -> torch.Tensor:
    th = _normal((g,), seed, device)
    return torch.stack([torch.cos(th), torch.sin(th)], dim=1)


def _band(spec: AuditSpec, device) -> torch.Tensor:
    from repro_torch.core.band_storage import pack_band
    return pack_band(_sym(spec.n, 11, device), spec.w, symmetrize=True)


def _default(fn, name: str):
    return inspect.signature(fn).parameters[name].default


# ------------------------------------------------------------------------
# the entries' programs
# ------------------------------------------------------------------------

def _build_reduce_to_band(spec: AuditSpec, device):
    from repro_torch.core.sbr import default_n_chunks, reduce_to_band
    n, w = spec.n, spec.w
    return [ProgramSpec(name="reduce_to_band", fn=reduce_to_band,
                        args=(_sym(n, 10, device),),
                        kwargs=dict(w=w, n_chunks=default_n_chunks(n, w)))]


def _build_band_chase(spec: AuditSpec, device):
    from repro_torch.core.sbr import band_chase
    return [ProgramSpec(name="band_chase", fn=band_chase,
                        args=(_band(spec, device), spec.w))]


def _build_apply_q2(spec: AuditSpec, device):
    from repro_torch.core.sbr import apply_q2, band_chase
    chase = band_chase(_band(spec, device), spec.w)
    Z = _normal((spec.n, spec.s), 12, device)
    return [ProgramSpec(name="apply_q2", fn=apply_q2,
                        args=(chase, Z, spec.w))]


def _build_tridiag_eig_batched(spec: AuditSpec, device):
    from repro_torch.core.tridiag_eig import eigh_tridiag_selected
    n, s = spec.n, spec.s
    return [ProgramSpec(name="tridiag_eig_batched", fn=eigh_tridiag_selected,
                        args=(_normal((n,), 13, device),
                              _normal((n - 1,), 14, device),
                              torch.arange(s, device=device)),
                        kwargs=dict(x0=_normal((n, s), 15, device)))]


def _build_lanczos_solve_jit(spec: AuditSpec, device):
    from repro_torch.core.lanczos import lanczos_solve_jit
    from repro_torch.core.operators import ExplicitC
    n, s, m, p = spec.n, spec.s, spec.m, spec.p
    return [ProgramSpec(
        name="lanczos_solve_jit", fn=lanczos_solve_jit,
        args=(ExplicitC(_sym(n, 16, device)), _normal((n, p), 17, device),
              s, m),
        kwargs=dict(which="SA", max_restarts=LANCZOS_JIT_RESTARTS, p=p,
                    use_kernel=True))]


#: the restart budget of the audited fixed-trip Krylov programs (the
#: reference's ``max_restarts=8`` of both its Krylov entries)
LANCZOS_JIT_RESTARTS = 8


def _pencils(n: int, batch: int, device):
    from repro_torch.data.problems import md_like
    probs = [md_like(n, seed=700 + i, device="cpu") for i in range(batch)]
    return (torch.stack([q.A for q in probs]).to(device),
            torch.stack([q.B for q in probs]).to(device))


def _bucket_call(A, B, s, kw):
    """One ``solve_batched`` call and the cache's counts around it."""
    from repro_torch.core import batched
    before = batched.cache_stats()
    res = batched.solve_batched(A, B, s, **kw)
    return res, before, batched.cache_stats()


def _bucket_summary(out) -> dict:
    res, before, after = out
    info = res.info
    return {"cache_hit": bool(info["cache_hit"]),
            "pipelines_built": after["misses"] - before["misses"],
            "programs_built": after["exec_entries"] - before["exec_entries"],
            "path": info["path"], "graphs": info["graphs"],
            "graph_replays": dict(info["graph_replays"]),
            "graph_launches": {k: dict(v) for k, v
                               in info["graph_launches"].items()},
            "healthy": bool(res.healthy.all())}


def _build_solve_batched(spec: AuditSpec, device, variant: str,
                         precision: str = "fp64"):
    # the reference's bucket: n/2, band width 4, the block size p for the
    # Krylov variants, 8 restarts
    A, B = _pencils(spec.n // 2, spec.batch, device)
    krylov = variant in ("KE", "KI")
    kw = dict(variant=variant, which="smallest", invert=krylov,
              band_width=4, p=spec.p if krylov else 1,
              max_restarts=LANCZOS_JIT_RESTARTS, precision=precision,
              use_kernel=True, device=device)
    return [ProgramSpec(name=name, fn=_bucket_call, args=(A, B, spec.s, kw),
                        summarize=_bucket_summary)
            for name in ("cold", "warm")]


def _marked(matvec):
    """The block-step product with a step mark before it."""
    def marked(X):
        mark_step()
        return matvec(X)
    return marked


def _row_blocks(tl, M: torch.Tensor, n: int) -> torch.Tensor:
    r0, r1 = tl.rows(n)
    return M[r0:r1].contiguous()


def _build_band_sweep(spec: AuditSpec, device, mesh):
    from repro_torch.dist.mesh import tiling
    from repro_torch.dist.sharded_la import band_sweep
    tl = tiling(mesh)
    n, w = spec.n, spec.w
    C = _sym(n, 18, device)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    return [ProgramSpec(name="band_sweep", fn=band_sweep,
                        args=(tl, _row_blocks(tl, C, n),
                              _row_blocks(tl, eye, n), n, w),
                        step_on="house_panel")]


def _ke_matvec(spec: AuditSpec, device, mesh):
    from repro_torch.dist.eigensolver import _fused_block_matvec
    from repro_torch.dist.mesh import tiling
    tl = tiling(mesh)
    n = spec.n
    C = _sym(n, 19, device)
    r0, r1 = tl.rows(n)
    c0, c1 = tl.cols(n)
    return _marked(_fused_block_matvec(tl, C[r0:r1, c0:c1].contiguous(), n))


def _ke_solve(mesh, A, B, s, kw):
    from repro_torch.dist.eigensolver import solve_ke_distributed
    return solve_ke_distributed(mesh, A, B, s, return_info=True, **kw)


def _build_ke_restart(spec: AuditSpec, device, mesh):
    from repro_torch.core.lanczos import _qr_posdiag, restart_schedule
    from repro_torch.data.problems import md_like
    from repro_torch.dist.eigensolver import ke_restart_program
    n, s, p, m = spec.n, spec.s, spec.p, spec.m
    keep = restart_schedule(s, m, p)[0]
    V = torch.zeros((n, m + p), dtype=torch.float64, device=device)
    V[:, :p] = _qr_posdiag(_normal((n, p), 20, device))[0]
    T = torch.zeros((m + p, m + p), dtype=torch.float64, device=device)
    md = md_like(n, seed=21, device="cpu")
    # the probe: a whole fused KE solve (filtered), whose stage entries the
    # cost-model cross-check holds to ``ke_dispatch_budget``
    solve_kw = dict(m=m, p=p, filter_degree=spec.filter_degree, invert=True,
                    v0=_normal((n, p), 22, device))
    return [
        ProgramSpec(name="ke_restart_program", fn=ke_restart_program,
                    args=(_ke_matvec(spec, device, mesh), V, T, 0, 1e-9),
                    kwargs=dict(s=s, keep=keep, m=m, p=p, which="LA")),
        ProgramSpec(name="solve_ke_distributed", fn=_ke_solve,
                    args=(mesh, md.A.to(device), md.B.to(device), s,
                          solve_kw),
                    summarize=lambda out: {
                        "n_restart": out[2]["n_restart"],
                        "converged": out[2]["converged"],
                        "fused": out[2]["fused"]},
                    budgeted=False),
    ]


def _build_ke_prep(spec: AuditSpec, device, mesh):
    from repro_torch.dist.eigensolver import ke_prep_program
    return [ProgramSpec(name="ke_prep_program", fn=ke_prep_program,
                        args=(_ke_matvec(spec, device, mesh),
                              _normal((spec.n, spec.p), 23, device), spec.kb,
                              spec.filter_degree, spec.s, "LA"))]


def _build_tt3(spec: AuditSpec, device, mesh):
    from repro_torch.dist.eigensolver import dist_tridiag_eig
    n, s = spec.n, spec.s
    return [ProgramSpec(name="dist_tridiag_eig", fn=dist_tridiag_eig,
                        args=(mesh, _normal((n,), 24, device),
                              _normal((n - 1,), 25, device),
                              torch.arange(s, device=device)),
                        kwargs=dict(x0=_normal((n, s), 26, device),
                                    max_iters=spec.tt3_max_iters,
                                    iters=spec.tt3_iters),
                        step_on="invit")]


def _build_stage_sentinels(spec: AuditSpec, device):
    """GS1 (Cholesky and its health verdict) and GS2 (the two-TRSM
    congruence and its finiteness verdict), the stage functions
    ``gsyeig.solve`` runs: each verdict a device tensor."""
    from repro_torch.core.cholesky import cholesky_upper
    from repro_torch.core.gsyeig import _chol_fused, _gs2_trsm_fused
    n = spec.n
    B = _spd(n, 27, device)
    return [ProgramSpec(name="gs1_chol_sentinel", fn=_chol_fused, args=(B,)),
            ProgramSpec(name="gs2_trsm_sentinel", fn=_gs2_trsm_fused,
                        args=(_sym(n, 28, device), cholesky_upper(B)))]


def _build_kernel_gemm(spec: AuditSpec, device):
    from repro_torch.kernels.gemm.ops import gemm
    return [ProgramSpec(name="gemm", fn=gemm,
                        args=(_normal((96, 64), 30, device),
                              _normal((64, 96), 31, device)))]


def _build_kernel_symv(spec: AuditSpec, device):
    from repro_torch.kernels.symv.ops import symv
    n = spec.n
    return [ProgramSpec(name="symv", fn=symv,
                        args=(_sym(n, 32, device), _normal((n,), 33, device)))]


def _build_kernel_syr2k(spec: AuditSpec, device):
    from repro_torch.kernels.syr2k.ops import syr2k
    n, k = spec.n, spec.w
    return [ProgramSpec(name="syr2k", fn=syr2k,
                        args=(_sym(n, 34, device), _normal((n, k), 35, device),
                              _normal((n, k), 36, device)))]


def _build_kernel_trsm(spec: AuditSpec, device):
    from repro_torch.core.cholesky import cholesky_upper
    from repro_torch.kernels.trsm.ops import trsm
    n, s = spec.n, spec.s
    return [ProgramSpec(name="trsm", fn=trsm,
                        args=(cholesky_upper(_spd(n, 37, device)),
                              _normal((n, s), 38, device)))]


def _build_kernel_band_mv(spec: AuditSpec, device):
    from repro_torch.kernels.band_mv.ops import band_mv
    n, w = spec.n, spec.w
    return [ProgramSpec(name="band_mv", fn=band_mv,
                        args=(_normal((n, w + 1), 39, device),
                              _normal((n,), 40, device), w))]


def _build_kernel_rot_apply(spec: AuditSpec, device):
    from repro_torch.kernels.rot_apply.ops import rot_apply
    G, L = 8, spec.n
    return [ProgramSpec(name="rot_apply", fn=rot_apply,
                        args=(_normal((G, 2, L), 41, device),
                              _rotations(G, 42, device)))]


def _build_kernel_house_panel(spec: AuditSpec, device):
    from repro_torch.kernels.house_panel.ops import house_panel
    n, w = spec.n, spec.w
    return [ProgramSpec(name="house_panel", fn=house_panel,
                        args=(_normal((n, w), 43, device), w))]


def _build_kernel_tridiag_eig(spec: AuditSpec, device):
    from repro_torch.kernels.tridiag_eig.ops import bisect_sturm
    n, s = spec.n, spec.s
    return [ProgramSpec(name="bisect_sturm", fn=bisect_sturm,
                        args=(_normal((n,), 44, device),
                              _normal((n - 1,), 45, device),
                              torch.arange(s, device=device)))]


# ------------------------------------------------------------------------
# registration
# ------------------------------------------------------------------------

_NO_COMM = dict(exact_collectives=0)


def register_all(spec: Optional[AuditSpec] = None,
                 device=None) -> AuditSpec:
    """Populate the registry for ``spec`` on ``device`` (the card unless
    ``device="cpu"``; idempotent: re-registering replaces). The mesh
    entries are registered too; they run only on a mesh
    (``registry.check_entry(.., mesh=)``), on its device.

    Every entry is tagged ``quick`` except the ten ``serve/solve_batched_*``
    buckets (each builds and, on the card, captures a program)."""
    from repro_torch.core.precision import declared_downcasts
    from repro_torch.core.sbr import _executed_passes, _n_panels
    from repro_torch.core.tridiag_eig import inverse_iteration
    from repro_torch.device import resolve_device
    from repro_torch.kernels.tridiag_eig.kernel import LAUNCHES_PER_ROUND

    spec = spec or AuditSpec()
    device = resolve_device(device)
    n, w, s = spec.n, spec.w, spec.s
    n_panels = _n_panels(n, w)                   # sbr.py:75
    n_passes = len(_executed_passes(n, w))       # sbr.py:166

    def add(name, make, contract, tags, *extra, mesh=False):
        register(AuditEntry(name=name,
                            build=partial(make, spec, device, *extra),
                            contract=contract, needs_mesh=mesh, tags=tags,
                            device=str(device)))

    # the reference's TT1 budget is TT1_FUSED_MAX_DISPATCHES (3) programs;
    # the port's sweep is ONE entry of a host loop that queues a panel QR
    # and a SYR2K per panel
    add("core/reduce_to_band", _build_reduce_to_band, BudgetContract(
        exact_stage_entries={"sbr": 1},
        exact_kernel_calls={"house_panel": n_panels, "syr2k": n_panels},
        **_NO_COMM,
        notes="TT1: one sweep entered, house_panel + syr2k a panel"),
        ("core", "quick"))
    add("core/band_chase", _build_band_chase, BudgetContract(
        exact_kernel_calls={"chase_pass": n_passes}, **_NO_COMM,
        notes="TT2: one chase_pass launch a bandwidth pass (the "
              "reference's one program)"), ("core", "quick"))
    add("core/apply_q2", _build_apply_q2, BudgetContract(
        exact_kernel_calls={"replay_pass": n_passes}, **_NO_COMM,
        notes="TT4: one replay_pass launch a recorded pass (sbr.py:206-228)"),
        ("core", "quick"))
    # TT3/TD2: one bisection launch, then the port's inverse-iteration
    # rounds (``inverse_iteration``'s default), two launches a round
    invit_rounds = _default(inverse_iteration, "iters")
    add("core/tridiag_eig_batched", _build_tridiag_eig_batched,
        BudgetContract(
            exact_kernel_calls={"bisect_sturm": 1,
                                "invit": LAUNCHES_PER_ROUND * invit_rounds},
            **_NO_COMM,
            notes="TT3/TD2: bisect_sturm, then the solve and the "
                  "Gram-Schmidt launch a round"), ("core", "quick"))
    add("core/lanczos_solve_jit", _build_lanczos_solve_jit, BudgetContract(
        max_stage_entries={
            "lanczos": lanczos_block_dispatch_budget(LANCZOS_JIT_RESTARTS)},
        min_isfinite_sites=1,
        sentinel_extra_dispatches=SENTINEL_EXTRA_DISPATCHES, **_NO_COMM,
        notes="fixed-trip Krylov loop: its pieces (what core.batched "
              "replays from graphs) within the block budget at 8 "
              "restarts; the restart-health sentinel in the path"),
        ("core", "quick"))

    def bucket(variant: str, precision: str = "fp64") -> BudgetContract:
        low = precision != "fp64"
        return BudgetContract(
            bucket_reuse=True, min_isfinite_sites=1,
            sentinel_extra_dispatches=SENTINEL_EXTRA_DISPATCHES,
            allowed_dtypes={"fp64": DEFAULT_ALLOWED_DTYPES,
                            "mixed": MIXED_ALLOWED_DTYPES,
                            "fast": FAST_ALLOWED_DTYPES}[precision],
            declared_downcasts=declared_downcasts(precision), **_NO_COMM,
            notes=("one cached program per shape bucket: the second call "
                   "builds nothing (the per-pencil output sentinel in the "
                   "path)") + (f"; {precision}: declared demotions only"
                               if low else ""))

    for variant in ("TD", "TT", "KE", "KI"):
        add(f"serve/solve_batched_{variant}", _build_solve_batched,
            bucket(variant), ("serve",), variant)
    for variant, precision in (("TD", "mixed"), ("TT", "mixed"),
                               ("KE", "mixed"), ("KI", "mixed"),
                               ("TT", "fast"), ("KE", "fast")):
        add(f"serve/solve_batched_{variant}_{precision}",
            _build_solve_batched, bucket(variant, precision),
            ("serve", "precision"), variant, precision)

    add("dist/band_sweep_program", _build_band_sweep, BudgetContract(
        max_collectives_per_step=TT1_COLLECTIVES_PER_PANEL,
        exact_collectives=TT1_COLLECTIVES_PER_PANEL * n_panels,
        exact_kernel_calls={"house_panel": n_panels},
        notes="dist TT1: gather(panel) + all_reduce(coupling) + gather(Z) "
              "a panel"), ("dist", "quick"), mesh=True)
    add("dist/ke_restart_program", _build_ke_restart, BudgetContract(
        max_collectives_per_step=KE_COLLECTIVES_PER_BLOCK_STEP,
        exact_collectives=KE_COLLECTIVES_PER_BLOCK_STEP * (spec.m // spec.p),
        min_isfinite_sites=1,
        sentinel_extra_dispatches=SENTINEL_EXTRA_DISPATCHES,
        notes="one thick restart from block 0: all_reduce + all_gather a "
              "p-column block step, m/p steps; the restart-health verdict "
              "in the restart math"), ("dist", "quick"), mesh=True)
    add("dist/ke_prep_program", _build_ke_prep, BudgetContract(
        max_collectives_per_step=KE_COLLECTIVES_PER_BLOCK_STEP,
        max_collectives=KE_COLLECTIVES_PER_BLOCK_STEP
        * (spec.kb + spec.filter_degree + 2),
        notes="bounds probe + Chebyshev filter, two collectives a "
              "product"), ("dist", "quick"), mesh=True)
    add("dist/tt3_program", _build_tt3, BudgetContract(
        max_collectives_per_step=1,
        exact_collectives=tt3_dist_collectives(spec.tt3_iters),
        notes="spectrum-partitioned TT3: 1 lam all_gather + one Z "
              "all_gather a round"), ("dist", "quick"), mesh=True)

    add("resilience/stage_sentinels", _build_stage_sentinels, BudgetContract(
        max_host_reads=0, min_isfinite_sites_per_program=1,
        sentinel_extra_dispatches=SENTINEL_EXTRA_DISPATCHES, **_NO_COMM,
        notes="GS1 Cholesky + GS2 TRSM with their health verdicts: device "
              "tensors, no host read inside the stages"),
        ("resilience", "quick"))

    kernel_entries = {
        "gemm": (_build_kernel_gemm, {"gemm": 1}),
        "symv": (_build_kernel_symv, {"symv": 1}),
        "syr2k": (_build_kernel_syr2k, {"syr2k": 1}),
        # n <= 128: one tile solve, no product update (trsm/ops.py)
        "trsm": (_build_kernel_trsm, {"trsm_tile": 1, "gemm": 0}),
        "band_mv": (_build_kernel_band_mv, {"band_mv": 1}),
        "rot_apply": (_build_kernel_rot_apply, {"rot_apply": 1}),
        "house_panel": (_build_kernel_house_panel, {"house_panel": 1}),
        "tridiag_eig": (_build_kernel_tridiag_eig, {"bisect_sturm": 1}),
    }
    for kname, (make, calls) in kernel_entries.items():
        add(f"kernels/{kname}", make, BudgetContract(
            exact_kernel_calls=calls, **_NO_COMM,
            notes="the ops dispatch launches its kernel once (the plain "
                  "version on the CPU)"), ("kernels", "quick"))
    return spec


__all__ = [
    "AuditSpec", "register_all",
    "MIXED_ALLOWED_DTYPES", "FAST_ALLOWED_DTYPES",
    "TT1_COLLECTIVES_PER_PANEL", "KE_COLLECTIVES_PER_BLOCK_STEP",
    "SENTINEL_EXTRA_DISPATCHES", "ke_dispatch_budget",
    "lanczos_block_dispatch_budget", "lanczos_single_dispatch_budget",
    "tt3_dist_collectives", "LANCZOS_JIT_RESTARTS",
]
