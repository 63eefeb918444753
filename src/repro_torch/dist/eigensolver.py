"""Distributed KE and TT pipelines on a (rows x 'model') device mesh.

The reference's ``repro.dist.eigensolver`` as SPMD code on
``torch.distributed``: every rank calls a solver with the same replicated
A and B and returns the same replicated result. Stage for stage:

KE (``solve_ke_distributed``):
  GS1  U = chol(B) on row blocks              (``sharded_la.chol_rows``)
  GS2  C = U^{-T} A U^{-1}                    (two ``trsm_left_t_rows``)
  KE1  block Lanczos: the operand in (rows x 'model') tiles, each (n, p)
       block step one tile product with TWO collectives (the all-reduce
       over 'model', the all-gather over the rows that doubles as the
       broadcast of the replicated basis); the restart math replicated,
       and its two verdicts all-reduced over the mesh once a restart (one
       more collective, counted apart as ``verdict``), so that every rank
       takes the same branch. When n does not tile the mesh, the replicated
       ``core.lanczos.lanczos_solve``.
  BT1  X = U^{-1} Y                           (``trsm_left_rows``)

TT (``solve_tt_distributed``):
  GS1/GS2 as above, then
  TT1  dense -> band, ``sharded_la.band_sweep`` on row blocks (the
       ``house_panel`` kernel replicated a panel), padded to the row-block
       multiple with an identity block (``dist_reduce_to_band``);
  TT2  the band packed from gathered band rows, the ``chase_pass`` chase
       replicated;
  TT3  spectrum-partitioned (``dist_tridiag_eig``): each rank bisects its
       slice of the wanted indices with the ``bisect_sturm`` kernel and
       solves its columns with ``invit``'s solve launch; the block is
       gathered every round and goes through ``invit``'s Gram-Schmidt
       launch replicated;
  TT4  Y = Q1 (Q2 Z): ``replay_pass`` on the replicated slab, then the
       row-block product with Q1;
  BT1  as KE.

Random starts come from ``torch.Generator``s (default seeded with
``gsyeig.SOLVE_SEED``): the mesh's first rank draws them and broadcasts,
so every rank starts from the same block on any device. Checkpoints are
written by the first rank only, then a barrier; every rank reads.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch.core.filtering import (chebyshev_filter, estimate_bounds,
                                        filter_interval, probe_steps)
from repro_torch.core.instrument import DispatchCounter
from repro_torch.core.lanczos import (_qr_posdiag, _restart_math,
                                      _segment_impl, default_subspace,
                                      lanczos_solve, restart_schedule)
from repro_torch.core.operators import ExplicitC
from repro_torch.core.precision import (compute_dtype, matmul_acc,
                                        validate_precision)
from repro_torch.core.residuals import b_normalize
from repro_torch.core.sbr import _n_panels, apply_q2, band_chase
from repro_torch.core.tridiag_eig import (TridiagEigResult, _cluster_ids,
                                          _pivmin, _scale,
                                          bisect_eigenvalues,
                                          eigh_tridiag_selected,
                                          normalize_columns)
from repro_torch.device import synchronize
from repro_torch.kernels.house_panel.ops import house_panel
from repro_torch.kernels.tridiag_eig.ops import invit_orth, invit_solve

from . import checkpoint as _ckpt
from .mesh import Tiling, tiling
from .sharded_la import (band_sweep, chol_rows, dist_apply_wy_right,
                         dist_apply_wy_two_sided, trsm_left_rows,
                         trsm_left_t_rows)

#: seed of the default random starts (``gsyeig.SOLVE_SEED``, the
#: reference's PRNGKey(20120520))
START_SEED = 20120520

_dispatch = DispatchCounter()

#: stage entries of the fused distributed KE since the last
#: ``reset_dispatch_count()``: its Chebyshev prep, each thick restart and
#: the final Ritz extraction (the reference's ``dispatch_count``,
#: ``repro/dist/eigensolver.py:431-433``, which forms the Ritz vectors
#: inside its restart program), so a solve of ``n_restart`` restarts with
#: a filter counts ``n_restart + 2``
dispatch_count = _dispatch.count
reset_dispatch_count = _dispatch.reset


def _make_timer(times: Dict[str, float], device: torch.device):
    """Per-stage wall-clock accumulator: each stage ends in a
    ``torch.cuda.synchronize`` on the card."""
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(device)
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0)
        return out
    return timed


def _first_rank_draw(tl: Tiling, shape, generator, dtype) -> torch.Tensor:
    """A normal block of ``shape`` drawn on the mesh's first rank from
    ``generator`` (default seeded with ``START_SEED``) and broadcast."""
    if generator is None:
        generator = torch.Generator(device=tl.device).manual_seed(START_SEED)
    x = torch.randn(shape, generator=generator, dtype=torch.float64,
                    device=tl.device)
    return tl.from_first(x).to(dtype)


def _replicated(tl: Tiling, x, shape, dtype) -> torch.Tensor:
    """A given start block on this rank's device, checked for shape."""
    x = torch.as_tensor(x).to(device=tl.device, dtype=dtype)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"start block must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    return x


def _standard_form(tl: Tiling, A: torch.Tensor, B: torch.Tensor, timed):
    """GS1 + GS2, shared by KE and TT: (U's row block, C replicated) with
    B = U^T U and C = U^{-T} A U^{-1} by two transposed block solves,
    resymmetrized. The transpose between the solves is one gather."""
    n = A.shape[0]
    r0, r1 = tl.rows(n)
    U_loc = timed("GS1", chol_rows, tl, B[r0:r1], n)

    def gs2():
        T1 = tl.gather_rows(trsm_left_t_rows(tl, U_loc, A[r0:r1], n), n)
        Ct = tl.gather_rows(trsm_left_t_rows(
            tl, U_loc, T1.mT[r0:r1].contiguous(), n), n)
        return 0.5 * (Ct + Ct.mT)
    return U_loc, timed("GS2", gs2)


def _back_transform(tl: Tiling, U_loc: torch.Tensor,
                    Y: torch.Tensor) -> torch.Tensor:
    """BT1: the replicated X = U^{-1} Y from U's row blocks."""
    n = Y.shape[0]
    r0, r1 = tl.rows(n)
    return tl.gather_rows(trsm_left_rows(tl, U_loc, Y[r0:r1].contiguous(),
                                         n), n)


def _mesh_tiling(tl: Tiling, n: int) -> bool:
    """Whether n tiles evenly over both mesh dimensions (the fused KE
    layout)."""
    return n % tl.R == 0 and n % tl.cm == 0


def _fused_block_matvec(tl: Tiling, c_tile: torch.Tensor, n: int):
    """W = C X on an (n, p) replicated block from this rank's (rows, cols)
    tile of C: the tile product against its 'model' slice of X, ONE
    all-reduce over 'model' finishing the row block and ONE all-gather over
    the rows rebuilding the replicated block. A bfloat16 tile is promoted
    to the block's float32 for the product (JAX's bf16 x f32 promotion)."""
    c0, c1 = tl.cols(n)

    def matvec(X):
        Xs = X[c0:c1]
        tile = c_tile if c_tile.dtype == X.dtype else c_tile.to(X.dtype)
        Wp = tl.all_reduce(tile @ Xs, tl.model_group, kind="matvec")
        return tl.all_gather(Wp, tl.row_group, kind="matvec")
    return matvec


def ke_restart_program(matvec, V: torch.Tensor, T: torch.Tensor, j0: int,
                       tol_eff: float, *, s: int, keep: int, m: int, p: int,
                       which: str):
    """One thick restart of the fused KE, the reference's per-restart
    program run eagerly: the segment's block steps from block ``j0`` (each
    one ``_fused_block_matvec``, V and T updated in place) and the
    replicated restart math. Returns (V, theta, S, resid, V_restart, T_new,
    converged, healthy); the segment's Ritz vectors are
    ``qr(V[:, :m] @ S[:, :s])``, which the caller forms at exit (the
    reference forms them every restart)."""
    V, T, B_q = _segment_impl(matvec, V, T, j0, p)
    theta, S, resid, V_r, T_new, conv, healthy = _restart_math(
        V, T, B_q, tol_eff, s=s, keep=keep, m=m, p=p, which=which)
    return V, theta, S, resid, V_r, T_new, conv, healthy


def ke_prep_program(matvec, X0: torch.Tensor, kb: int, degree: int, s: int,
                    which: str) -> torch.Tensor:
    """The fused KE's Chebyshev prep: the kb-step bound probe from X0's
    first column, the interval, the degree-``degree`` filter of the (n, p)
    start block and its orthonormalization, every product the fused
    kind."""
    theta, beta_k = estimate_bounds(matvec, X0[:, 0], kb)
    a, b, a0 = filter_interval(theta, beta_k, s, which)
    Q0, _ = _qr_posdiag(chebyshev_filter(matvec, X0, degree, a, b, a0))
    return Q0


def _ritz_vectors(V: torch.Tensor, S: torch.Tensor, m: int,
                  s: int) -> torch.Tensor:
    """The fused KE's exit: the orthonormalized Ritz vectors of the last
    segment's basis, ``qr(V[:, :m] @ S[:, :s])``."""
    return torch.linalg.qr(V[:, :m] @ S[:, :s])[0]


def _verdicts(tl: Tiling, conv: torch.Tensor, healthy: torch.Tensor):
    """(converged, healthy) as every rank of the mesh sees them: the two
    flags all-reduced with MIN, so a rank whose replicated restart math
    disagreed cannot take another branch."""
    import torch.distributed as dist

    flags = torch.stack([conv, healthy]).to(torch.int32)
    flags = tl.all_reduce(flags, tl.mesh_group, kind="verdict",
                          op=dist.ReduceOp.MIN)
    conv_ok, health_ok = (bool(v) for v in flags.tolist())
    return conv_ok, health_ok


def _is_first(tl: Tiling) -> bool:
    import torch.distributed as dist
    return dist.get_rank() == tl.rank_of(0, 0)


def _save(tl: Tiling, stats: dict, directory: str, step: int, tree,
          extra: dict, keep: int) -> None:
    """``checkpoint.save`` on the mesh's first rank, then a barrier; the
    bytes and the wall of save and barrier go to ``stats``."""
    t0 = time.perf_counter()
    if _is_first(tl):
        _ckpt.save(directory, step, tree, extra=extra, keep=keep)
    tl.barrier()
    stats["saves"] += 1
    stats["bytes"] = int(sum(t.numel() * t.element_size()
                             for t in tree.values()))
    stats["save_s"] += time.perf_counter() - t0


def solve_ke_distributed(
    mesh,
    A: torch.Tensor,
    B: torch.Tensor,
    s: int,
    m: Optional[int] = None,
    which: str = "smallest",
    tol: float = 0.0,
    max_restarts: int = 500,
    v0: Optional[torch.Tensor] = None,
    probe_v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    return_info: bool = False,
    p: int = 4,
    filter_degree: int = 0,
    invert: bool = False,
    precision: str = "fp64",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 2,
    resume: bool = False,
    preempt_after: Optional[int] = None,
):
    """s extremal eigenpairs of A X = B X Lambda on a mesh (SPMD).

    The Krylov stage is the block Lanczos with two collectives per (n, p)
    block step (``_fused_block_matvec``). ``filter_degree > 0``
    Chebyshev-filters the start block first (bounds from a probe started
    at its first column, every product the fused kind). ``invert=True``
    solves the inverse pair (B, A) for its largest eigenpairs and maps
    back (the paper's MD trick).

    ``precision`` demotes the Krylov stage only (GS1/GS2/BT1 stay fp64):
    ``mixed`` runs operand, basis and restart math in float32; ``fast``
    keeps the basis float32 and the operand bfloat16 (each product
    promotes the tile to float32). The convergence test asks for no more
    than 8 eps of the operand's dtype; ``gsyeig.solve`` refines.

    ``v0`` is the (n, p) start block and ``probe_v0`` the replicated
    path's (n,) filter probe; what is not given is drawn on the first
    rank from ``generator`` and broadcast.

    Failure containment: ``checkpoint_dir`` persists the post-restart
    (V, T) every ``checkpoint_every`` restarts (``checkpoint.save``,
    ``checkpoint_keep`` newest kept); ``resume=True`` warm-starts from the
    newest one, which any mesh can do since (V, T) are replicated.
    ``preempt_after=k`` raises ``resilience.faults.SimulatedPreemption``
    after the k-th restart of this call has checkpointed. When n does not
    tile the mesh, the replicated Lanczos runs with
    ``checkpoint.lanczos_callback`` (no resume there, as in the reference).

    Returns ``(evals (s,) ascending, X (n, s))``; with ``return_info`` a
    third dict (stage times, ``n_matvec``, ``n_restart``, ``converged``,
    ``resid_bounds`` (the wanted pairs' at exit), ``healthy``, ``p``, ``filter_degree``, ``precision``, ``fused``,
    ``collectives`` by kind, ``resumed_from`` after a resume, and
    ``checkpoint`` with ``checkpoint_dir``).
    """
    validate_precision(precision)
    demoted = precision != "fp64"
    cdtype = compute_dtype(precision)
    tl = tiling(mesh)
    dev = tl.device
    A = torch.as_tensor(A).to(device=dev, dtype=torch.float64)
    B = torch.as_tensor(B).to(device=dev, dtype=torch.float64)
    B_orig = B
    if invert:
        A, B = B, A
        which = "largest" if which == "smallest" else "smallest"
    n = A.shape[0]
    if m is None:
        m = default_subspace(s, n, p)
    if m % p:
        raise ValueError(f"m={m} must be a multiple of p={p}")
    counts0 = dict(tl.counts)
    times: Dict[str, float] = {}
    timed = _make_timer(times, dev)

    U_loc, C = _standard_form(tl, A, B, timed)
    arp_which = "SA" if which == "smallest" else "LA"
    wdtype = torch.float32 if demoted else torch.float64
    keep, _ = restart_schedule(s, m, p)
    divisible = _mesh_tiling(tl, n)
    X0 = (_replicated(tl, v0, (n, p), torch.float64) if v0 is not None
          else _first_rank_draw(tl, (n, p), generator, torch.float64))
    ckpt_stats = {"saves": 0, "bytes": 0, "save_s": 0.0}

    t0 = time.perf_counter()
    healthy = True
    resumed_from = None
    if not divisible:
        # the replicated operator: GS1/GS2/BT1 stay distributed
        callback = None
        if checkpoint_dir is not None:
            def callback(k_restart, V, T, j):
                if k_restart % checkpoint_every == 0:
                    _save(tl, ckpt_stats, checkpoint_dir, k_restart,
                          {"V": V, "T": T}, {"kind": "lanczos", "j": int(j)},
                          checkpoint_keep)
        if probe_v0 is None and filter_degree > 0:
            probe_v0 = _first_rank_draw(tl, (n,), generator, torch.float64)
        res = lanczos_solve(ExplicitC(C), s, which=arp_which, m=m, tol=tol,
                            max_restarts=max_restarts, v0=X0,
                            probe_v0=probe_v0, p=p,
                            filter_degree=filter_degree, callback=callback,
                            compute_dtype=cdtype if demoted else None)
        lam, Y, resid = res.evals, res.evecs, res.resid_bounds
        n_matvec, n_restart = res.n_matvec, res.n_restart
        converged, healthy = res.converged, bool(res.healthy)
    else:
        r0, r1 = tl.rows(n)
        c0, c1 = tl.cols(n)
        c_tile = C[r0:r1, c0:c1].to(cdtype).contiguous()
        del C
        matvec = _fused_block_matvec(tl, c_tile, n)
        X0 = X0.to(wdtype)
        n_matvec = 0
        if filter_degree > 0:
            kb = probe_steps(s, n)
            Q0 = _dispatch(ke_prep_program, matvec, X0, kb, filter_degree, s,
                           arp_which)
            n_matvec += kb + filter_degree * p
        else:
            Q0, _ = _qr_posdiag(X0)
        V = torch.zeros((n, m + p), dtype=wdtype, device=dev)
        V[:, :p] = Q0
        T = torch.zeros((m + p, m + p), dtype=wdtype, device=dev)
        # a demoted operand floors the attainable residual at ~eps ||C||
        eps = float(torch.finfo(cdtype).eps)
        tol_eff = tol if tol > 0.0 else (8.0 * eps if demoted else eps)
        j0 = k0 = 0
        converged = False
        if checkpoint_dir is not None and resume:
            got = _ckpt.load_latest(checkpoint_dir, {"T": T, "V": V})
            if got is not None:
                step, tree, extra = got
                V, T = tree["V"], tree["T"]
                j0 = int(extra.get("j", keep // p))
                k0 = int(step) + 1
                n_matvec = int(extra.get("n_matvec", n_matvec))
                resumed_from = int(step)
        if k0 >= max_restarts:
            raise ValueError(f"the checkpoint is at restart {k0 - 1}; "
                             f"max_restarts={max_restarts} leaves none")
        n_restart = max_restarts
        for k_restart in range(k0, max_restarts):
            V_seg, theta, S, resid, V_r, T_new, conv, healthy_dev = \
                _dispatch(ke_restart_program, matvec, V, T, j0, tol_eff, s=s,
                          keep=keep, m=m, p=p, which=arp_which)
            n_matvec += m - j0 * p
            j0 = keep // p
            conv_ok, health_ok = _verdicts(tl, conv, healthy_dev)
            if (checkpoint_dir is not None
                    and k_restart % checkpoint_every == 0):
                # the POST-restart state the next segment consumes, so a
                # resume replays the same restart arithmetic
                _save(tl, ckpt_stats, checkpoint_dir, k_restart,
                      {"V": V_r, "T": T_new},
                      {"kind": "ke_dist", "j": int(j0),
                       "n_matvec": int(n_matvec)}, checkpoint_keep)
            if preempt_after is not None \
                    and k_restart - k0 + 1 >= preempt_after:
                from repro_torch.resilience.faults import SimulatedPreemption
                raise SimulatedPreemption(k_restart)
            if not health_ok or conv_ok:
                healthy, converged = health_ok, conv_ok and health_ok
                n_restart = k_restart + 1
                break
            V, T = V_r, T_new
        lam, resid = theta[:s], resid[:s]
        Y = _dispatch(_ritz_vectors, V_seg, S, m, s)
    synchronize(dev)
    times["KE_iter"] = time.perf_counter() - t0

    lam, Y = lam.to(torch.float64), Y.to(torch.float64)
    order = torch.argsort(lam)
    lam, Y = lam[order], Y[:, order]
    X = timed("BT1", _back_transform, tl, U_loc, Y)
    if invert:
        lam = 1.0 / lam
        order = torch.argsort(lam)
        lam, X = lam[order], X[:, order]
        X = b_normalize(X, B_orig)
    if not return_info:
        return lam, X
    info = {"stage_times": times, "n_matvec": int(n_matvec),
            "n_restart": int(n_restart), "converged": bool(converged),
            "resid_bounds": [float(r) for r in resid.tolist()],
            "healthy": bool(healthy), "p": int(p),
            "filter_degree": int(filter_degree), "precision": precision,
            "fused": bool(divisible), "mesh": list(mesh.shape),
            "collectives": _delta(tl, counts0)}
    if resumed_from is not None:
        info["resumed_from"] = resumed_from
    if checkpoint_dir is not None:
        info["checkpoint"] = ckpt_stats
    return lam, X, info


def _delta(tl: Tiling, counts0: dict) -> dict:
    return {k: v - counts0.get(k, 0) for k, v in tl.counts.items()
            if v - counts0.get(k, 0)}


# -------------------------------------------------------- TT pipeline -----

def _reduce_to_band_rows(tl: Tiling, C: torch.Tensor, w: int):
    """(W's row block, Q1's row block, n_pad) of the band reduction of the
    replicated C, embedded in ``[[C, 0], [0, I]]`` of the next multiple of
    the row blocks when n is not one: the padding rows carry identity
    reflectors, so the leading (n, n) blocks are C's reduction."""
    n = C.shape[0]
    n_pad = -(-n // tl.R) * tl.R
    r0, r1 = tl.rows(n_pad)
    M = C.new_zeros((r1 - r0, n_pad))
    M[:max(min(r1, n) - r0, 0), :n] = C[r0:min(r1, n)]
    Q = C.new_zeros((r1 - r0, n_pad))
    idx = torch.arange(r0, r1, device=C.device)
    pad = idx >= n
    M[pad, idx[pad]] = 1.0
    Q[torch.arange(r1 - r0, device=C.device), idx] = 1.0
    W_loc, Q_loc = band_sweep(tl, M, Q, n_pad, w)
    return W_loc, Q_loc, n_pad


def dist_reduce_to_band(mesh, C: torch.Tensor, w: int = 8):
    """TT1: (W, Q1) with Q1^T C Q1 = W of bandwidth w, on the mesh's row
    blocks; both returned whole. W is band-masked (off-band entries exactly
    zero), its triangles not averaged."""
    tl = tiling(mesh)
    n = C.shape[0]
    W_loc, Q_loc, n_pad = _reduce_to_band_rows(tl, C, w)
    W = tl.gather_rows(W_loc, n_pad)[:n, :n]
    Q1 = tl.gather_rows(Q_loc, n_pad)[:n, :n]
    return W, Q1


def dist_reduce_to_band_stepwise(mesh, C: torch.Tensor, w: int = 8):
    """The per-panel baseline of ``dist_reduce_to_band``: for each panel
    the replicated ``house_panel`` QR, then ``dist_apply_wy_two_sided`` and
    ``dist_apply_wy_right``, each gathering its result. Returns (W, Q1),
    W band-masked and symmetrized."""
    n = C.shape[0]
    M = C
    Q1 = torch.eye(n, dtype=C.dtype, device=C.device)
    for k in range(_n_panels(n, w)):
        c0 = k * w
        V, T = house_panel(M[:, c0:c0 + w].contiguous(), c0 + w)
        M = dist_apply_wy_two_sided(mesh, M, V, T)
        Q1 = dist_apply_wy_right(mesh, Q1, V, T)
    idx = torch.arange(n, device=C.device)
    M = torch.where(torch.abs(idx[:, None] - idx[None, :]) <= w, M, 0.0)
    return 0.5 * (M + M.mT), Q1


def _band_rows(tl: Tiling, W_loc: torch.Tensor, n: int, n_pad: int,
               w: int) -> torch.Tensor:
    """The packed (w+1, n) band of the leading (n, n) block of W, each
    packed diagonal the average of W's lower and upper one (as
    ``band_storage.pack_band(.., symmetrize=True)``), from the gathered
    (n, 2w+1) band rows of every row block."""
    r0, r1 = tl.rows(n_pad)
    offs = torch.arange(-w, w + 1, device=W_loc.device)
    cols = torch.arange(r0, r1, device=W_loc.device)[:, None] + offs
    ok = (cols >= 0) & (cols < n)
    rows_loc = torch.where(ok, W_loc.gather(1, cols.clamp(0, n_pad - 1)),
                           0.0)
    rows = tl.gather_rows(rows_loc, n_pad)[:n]
    band = rows.new_zeros((w + 1, n))
    band[0] = rows[:, w]
    for d in range(1, min(w, n - 1) + 1):
        band[d, :n - d] = 0.5 * (rows[d:, w - d] + rows[:n - d, w + d])
    return band


def dist_tridiag_eig(mesh, d: torch.Tensor, e: torch.Tensor, ks,
                     x0: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     max_iters: int = 80, iters: int = 3
                     ) -> TridiagEigResult:
    """Selected eigenpairs of tridiag(d, e) with the wanted indices split
    over every rank of the mesh (EleMRRR-style), the distributed
    ``eigh_tridiag_selected`` with the same contract (``ks`` in any order,
    ``x0`` in the column order of the sorted ``ks``).

    Each rank bisects its contiguous slice of the sorted indices
    (``bisect_sturm``); one all-gather assembles ``lam`` for the replicated
    clustering. Each of the ``iters`` rounds solves this rank's columns
    (``invit``'s solve launch), all-gathers the block and runs ``invit``'s
    norms and cluster Gram-Schmidt on it replicated: the per-round gather
    keeps a cluster split across ranks orthogonal. s is padded to the rank
    count with copies of the top index and zero start columns, which solve
    to zero, drop out of every Gram-Schmidt sum and are cut off. Collectives:
    1 + ``iters``.
    """
    tl = tiling(mesh)
    n_dev = mesh.size()
    ks = torch.as_tensor(ks, device=d.device).to(torch.int64)
    n, s = d.shape[0], ks.shape[0]
    s_pad = -(-s // n_dev) * n_dev
    s_loc = s_pad // n_dev
    order = torch.argsort(ks)
    inv = torch.argsort(order)
    ks_sorted = ks[order]
    ks_pad = torch.cat([ks_sorted, ks_sorted[-1:].expand(s_pad - s)])
    X0 = (_replicated(tl, x0, (n, s), d.dtype) if x0 is not None
          else _first_rank_draw(tl, (n, s), generator, d.dtype))
    X = torch.zeros((n, s_pad), dtype=d.dtype, device=d.device)
    X[:, :s] = normalize_columns(X0)
    col0 = (tl.r * tl.cm + tl.c) * s_loc
    lam_loc = bisect_eigenvalues(d, e, ks_pad[col0:col0 + s_loc],
                                 max_iters=max_iters)
    lam = tl.all_gather(lam_loc, tl.mesh_group, kind="tt3")
    cid = _cluster_ids(lam, _scale(d, e))
    piv = _pivmin(d, e)
    for _ in range(iters):
        X_loc = invit_solve(d, e, lam_loc, piv, X[:, col0:col0 + s_loc])
        X = invit_orth(tl.all_gather(X_loc, tl.mesh_group, dim=1,
                                     kind="tt3"), cid)
    return TridiagEigResult(lam=lam[:s][inv], Z=X[:, :s][:, inv])


def solve_tt_distributed(
    mesh,
    A: torch.Tensor,
    B: torch.Tensor,
    s: int,
    which: str = "smallest",
    band_width: int = 8,
    x0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    return_info: bool = False,
    shard_tt3: bool = True,
    precision: str = "fp64",
):
    """s extremal eigenpairs of A X = B X Lambda by the distributed
    two-stage reduction (the paper's TT variant, ELPA2-style), SPMD.

    TT1 and every O(n^3)/O(n^2 s) product and solve run on the mesh's row
    blocks; TT3 is spectrum-partitioned (``dist_tridiag_eig``;
    ``shard_tt3=False`` runs the replicated ``eigh_tridiag_selected``, the
    same eigenvalues bit for bit). TT2 and the TT4 replay are replicated.
    ``precision`` demotes TT1/TT2/TT4 to the compute dtype (the reduced
    ``house_panel``, ``chase_pass`` and ``replay_pass`` instances on the
    card); GS1/GS2, TT3 and BT1 stay fp64. ``x0`` is TT3's (n, s) start
    block in the column order of the sorted wanted indices; without it the
    first rank draws one from ``generator`` and broadcasts it.

    Returns ``(evals (s,) ascending, X (n, s))``; with ``return_info`` a
    third dict (stage times, band width, precision, ``tt3_sharded``,
    ``collectives`` by kind).
    """
    validate_precision(precision)
    cdtype = compute_dtype(precision)
    tl = tiling(mesh)
    dev = tl.device
    A = torch.as_tensor(A).to(device=dev, dtype=torch.float64)
    B = torch.as_tensor(B).to(device=dev, dtype=torch.float64)
    n = A.shape[0]
    w = band_width
    counts0 = dict(tl.counts)
    times: Dict[str, float] = {}
    timed = _make_timer(times, dev)

    U_loc, C = _standard_form(tl, A, B, timed)
    W_loc, Q_loc, n_pad = timed("TT1", _reduce_to_band_rows, tl,
                                C.to(cdtype), w)
    del C
    chase = timed("TT2", lambda: band_chase(
        _band_rows(tl, W_loc, n, n_pad, w), w))
    del W_loc
    ks = (torch.arange(s, device=dev) if which == "smallest"
          else torch.arange(n - s, n, device=dev))
    X0 = (_replicated(tl, x0, (n, s), torch.float64) if x0 is not None
          else _first_rank_draw(tl, (n, s), generator, torch.float64))
    d64, e64 = chase.d.to(torch.float64), chase.e.to(torch.float64)
    if shard_tt3:
        lam, Z = timed("TT3", dist_tridiag_eig, mesh, d64, e64, ks, X0)
    else:
        lam, Z = timed("TT3", eigh_tridiag_selected, d64, e64, ks, X0)
    r0, r1 = tl.rows(n)

    def tt4():
        Y2 = apply_q2(chase, Z.to(cdtype), w)
        return matmul_acc(Q_loc[:r1 - r0, :n], Y2).to(torch.float64)
    Y_loc = timed("TT4", tt4)
    X = timed("BT1", lambda: tl.gather_rows(
        trsm_left_rows(tl, U_loc, Y_loc, n), n))
    if not return_info:
        return lam, X
    info = {"stage_times": times, "band_width": int(w),
            "precision": precision, "tt3_sharded": bool(shard_tt3),
            "mesh": list(mesh.shape), "collectives": _delta(tl, counts0)}
    return lam, X, info


__all__ = ["solve_ke_distributed", "solve_tt_distributed",
           "ke_restart_program", "ke_prep_program",
           "dist_reduce_to_band", "dist_reduce_to_band_stepwise",
           "dist_tridiag_eig", "dispatch_count", "reset_dispatch_count"]
