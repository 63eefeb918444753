"""Flop/bandwidth cost model of the four GSYEIG variants, and the variant
router behind ``solve(variant="auto")`` (``repro.analysis.variant_model``
in torch).

Predicts per-stage times for TD/TT/KE/KI from ``(n, s, band_width,
estimated Lanczos iterations, mesh shape)`` and exposes
``choose_variant(...)``: the hybrid selection between the direct
(reduction) and iterative (Krylov) paths that Imachi & Hoshi
(arXiv:1504.06443) argue for.

Model: every stage is (flops, bytes, collective_bytes, dispatches,
collectives, loop_steps); its time is the roofline ``max(flops / (P *
peak_flops), bytes / (P * mem_bw)) + collective_bytes / link_bw +
dispatches * t_dispatch + collectives * t_collective + loop_steps *
t_loop_step`` with P devices. The cost formulas are the reference's,
term for term (``tests/test_torch_variant_model.py`` holds them to it);
only the machines differ. The default ``MachineParams()`` is the
reference's multicore regime (flop:byte ~5, no latency terms), so the
router decides as the reference does on the same inputs.
``MachineParams.h100()`` is one NVIDIA H100: its fp64 tensor-core peak
and HBM3 rate, and the latency terms fitted to the port's measured MD
stage times. ``MachineParams.from_measurements`` fits a machine to stage
times given as records (``from_artifact`` reads them from a
``BENCH_variant_race.json``-schema file): the reference's
``from_artifact`` fit. The reference's ``from_compiled`` reads XLA's cost
analysis and has no counterpart here.

The qualitative predictions reproduce the paper's Tables: TD1 is
memory-bound (BLAS-2), TT converts it to compute-bound BLAS-3 at the cost
of ~2x the flops, and KE/KI win when the estimated iteration count is
small relative to n (MD-like separated spectra) but lose on clustered
DFT-like spectra that push Lanczos to thousands of iterations.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Sequence

from repro_torch.core.lanczos import default_subspace, restart_schedule
from repro_torch.core.precision import default_refine_steps
from repro_torch.core.refinement import default_guard

#: the unroll of the reference's fused Sturm scans
#: (``repro/kernels/tridiag_eig/ops.py``), which its TT3/TD2 loop-step
#: term divides by; kept so that the model's formulas stay the reference's
_TT3_UNROLL = 16

VARIANTS = ("TD", "TT", "KE", "KI")
#: variants with a distributed implementation (``mesh=`` dispatch targets)
DISTRIBUTED_VARIANTS = ("TT", "KE")

#: relative matmul throughput per compute dtype (fp32 doubles the fp64
#: rate on both the paper's AVX cores and the MXU; bf16 doubles again)
DTYPE_FLOP_SPEEDUP = {"float64": 1.0, "float32": 2.0, "bfloat16": 4.0}
DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2}

#: the GEMM-heavy stages each precision level demotes (mirror of what
#: ``core.gsyeig`` / ``core.batched`` actually cast; everything else —
#: Cholesky/standard form, tridiagonal eigensolve, refinement — is fp64)
DEMOTED_STAGES = ("TD1", "TD3", "TT1", "TT2", "TT4", "KE_iter", "KI_iter")

_PRECISION_DTYPE = {"fp64": "float64", "mixed": "float32",
                    "fast": "bfloat16"}

# One NVIDIA H100 SXM (data sheet, dense; at its 700 W limit): fp64 through
# the tensor cores (DMMA), HBM3, and NVLink 4 in one direction (900 GB/s
# both ways)
H100_FP64_TENSOR_FLOPS = 67e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9
#: the port's MD n=9997, s=100 fp64 stage times in seconds (H100 80GB
#: HBM3, 700.00 W; ``chip_smoke.py``'s 461.3 s run, PERF.md §5's fp64
#: table), and the matvecs of KE and KI there: the records ``h100()``'s
#: fit reads
H100_MD_FP64 = {
    "n": 9997, "s": 100, "n_devices": 1,
    "measured": [
        {"variant": "TD", "stage_times_s": {
            "GS1": 0.0340, "GS2": 0.0769, "TD1": 7.9899, "TD2": 0.0241,
            "TD3": 0.8375, "BT1": 0.0036}},
        {"variant": "TT", "band_width": 16, "stage_times_s": {
            "GS1": 0.0181, "GS2": 0.0770, "TT1": 0.8329, "TT2": 0.6547,
            "TT3": 0.0223, "TT4": 0.0626, "BT1": 0.0038}},
        {"variant": "KE", "n_matvec": 813, "stage_times_s": {
            "GS1": 0.0180, "GS2": 0.0770, "KE_iter": 0.6579,
            "BT1": 0.0036}},
        {"variant": "KI", "n_matvec": 813, "stage_times_s": {
            "GS1": 0.0179, "KI_iter": 1.5529, "BT1": 0.0037}}]}
#: ``MachineParams.from_measurements(H100_MD_FP64, base=<the peaks above>)``
#: (H100 80GB HBM3, 700.00 W; that run): s a modeled loop step, s a
#: dispatch
H100_T_LOOP_STEP = 4.087126477242383e-07
H100_T_DISPATCH = 0.023538055672044776


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Per-device throughput model. Defaults: the paper's multicore regime."""
    peak_flops: float = 500e9      # FLOP/s per device
    mem_bw: float = 100e9          # B/s per device
    link_bw: float = 25e9          # B/s inter-device
    dtype_bytes: int = 8
    t_dispatch: float = 0.0        # s per host->device program dispatch
    t_collective: float = 0.0      # s per cross-device collective launch
    t_loop_step: float = 0.0       # s per sequential while/fori loop step

    @classmethod
    def h100(cls) -> "MachineParams":
        """One NVIDIA H100 80GB HBM3 at its 700 W limit, fp64.

        ``peak_flops`` and ``mem_bw`` are the card's data-sheet peaks, the
        bounds of ``PERF.md`` §6; ``link_bw`` its NVLink (one direction).
        ``t_loop_step`` and ``t_dispatch`` are ``from_measurements``' fit
        (from these peaks) to the port's MD n=9997, s=100 fp64 stage times
        of TD, TT (w=16), KE and KI (``H100_MD_FP64``): a TT2 chase step
        is ~2.0 us on the card (319,612 steps a solve), and TD1's column
        step is host-bound, which the model's single TD1 dispatch prices
        as ``t_dispatch``."""
        return cls(peak_flops=H100_FP64_TENSOR_FLOPS, mem_bw=H100_HBM_BW,
                   link_bw=H100_NVLINK_BW, dtype_bytes=8,
                   t_dispatch=H100_T_DISPATCH, t_loop_step=H100_T_LOOP_STEP)

    @classmethod
    def from_artifact(cls, path: str,
                      base: Optional["MachineParams"] = None,
                      n_fit_iters: int = 12) -> "MachineParams":
        """``from_measurements`` of a ``BENCH_variant_race.json``-schema
        artifact: top-level ``n``/``s``/``n_devices`` plus
        ``races[].measured[]`` records with per-stage wall-clock
        (``stage_times_s``)."""
        with open(path) as f:
            return cls.from_measurements(json.load(f), base=base,
                                         n_fit_iters=n_fit_iters)

    @classmethod
    def from_measurements(cls, art: dict,
                          base: Optional["MachineParams"] = None,
                          n_fit_iters: int = 12) -> "MachineParams":
        """Calibrate effective throughputs from measured stage times.

        ``art`` has the artifact's schema: ``n``, ``s``, ``n_devices``
        and ``races[].measured[]`` (or ``measured[]`` at the top), each
        record a ``variant``, its ``stage_times_s`` and optionally
        ``band_width``, ``krylov_block``, ``filter_degree`` and
        ``n_matvec``. Every measured stage is matched to its modeled
        ``(flops, bytes, dispatches, collectives, loop_steps)`` from
        :func:`stage_costs` (for Krylov stages the *measured*
        ``n_matvec`` replaces the heuristic iteration estimate), then the
        fit recovers the effective ``peak_flops`` / ``mem_bw`` AND the
        three overhead terms:
        (1) against the base roofline, take the median
        residual-per-loop-step over the serial stages as
        ``t_loop_step``, then the median leftover-per-dispatch as
        ``t_dispatch`` and leftover-per-collective as ``t_collective``,
        each clamped nonnegative;
        (2) classify each stage by its currently-dominant roofline term
        and refit each rate as total-work / total-time of its class
        after subtracting the overhead share; iterate (the overheads are
        fit once, not re-entered, so refitted rates cannot erode them).
        """
        base = base or cls()
        n, s = int(art["n"]), int(art["s"])
        p = max(int(art.get("n_devices", 1)), 1)
        samples = []
        for race in art.get("races", [art]):
            for rec in race.get("measured", []):
                v = rec.get("variant")
                if v not in VARIANTS:
                    continue
                kw = {"band_width": int(rec.get("band_width", 8)),
                      "p": int(rec.get("krylov_block", 1)),
                      "filter_degree": int(rec.get("filter_degree", 0))}
                if "n_matvec" in rec:
                    kw["n_iter"] = int(rec["n_matvec"])
                costs = stage_costs(v, n, s, machine=base, **kw)
                for st, t in rec.get("stage_times_s", {}).items():
                    c = costs.get(st)
                    if c is not None and t > 0.0:
                        samples.append((c.flops, c.bytes, c.collective_bytes,
                                        c.dispatches, c.collectives,
                                        c.loop_steps, float(t)))
        if not samples:
            return base
        pf, pm = base.peak_flops, base.mem_bw
        td, tc = base.t_dispatch, base.t_collective
        def _median(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2] if xs else 0.0

        # (1) overhead terms, once, against the BASE roofline (whose
        # terms are microseconds here, so residual ~= wall): robust
        # medians, clamped nonnegative. Fitting overheads before
        # throughput — and not re-entering with the refitted rates —
        # keeps outlier stages from zeroing a term out via an
        # ever-shrinking "effective bandwidth". Order matters: the
        # per-loop-step overhead comes from the serial wavefront stages
        # (thousands of steps, residual ~= wall), then per-dispatch
        # latency from the remaining residuals, then per-collective.
        def _roof(F, B, Cb):
            return (max(F / (p * base.peak_flops), B / (p * base.mem_bw))
                    + (Cb / base.link_bw if p > 1 else 0.0))
        per_step = [(t - _roof(F, B, Cb)) / L
                    for F, B, Cb, D, K, L, t in samples if L > 0.0]
        ts = max(_median(per_step), 0.0) if per_step else base.t_loop_step
        per_disp = [(t - _roof(F, B, Cb) - L * ts) / D
                    for F, B, Cb, D, K, L, t in samples if D > 0.0]
        td = max(_median(per_disp), 0.0) if per_disp else td
        per_coll = [(t - _roof(F, B, Cb) - L * ts - D * td) / K
                    for F, B, Cb, D, K, L, t in samples if K > 0.0 and p > 1]
        tc = max(_median(per_coll), 0.0) if per_coll else 0.0

        for _ in range(n_fit_iters):
            # (2) throughputs on the post-overhead residual
            work = {"f": 0.0, "b": 0.0}
            wall = {"f": 0.0, "b": 0.0}
            for F, B, Cb, D, K, L, t in samples:
                t_lat = L * ts + D * td + (K * tc if p > 1 else 0.0)
                t_eff = max(t - (Cb / base.link_bw if p > 1 else 0.0)
                            - t_lat, 0.05 * t)
                cls_key = "f" if F / pf >= B / pm else "b"
                work[cls_key] += (F if cls_key == "f" else B) / p
                wall[cls_key] += t_eff
            new_pf = work["f"] / wall["f"] if wall["f"] > 0 else pf
            new_pm = work["b"] / wall["b"] if wall["b"] > 0 else pm
            if (abs(new_pf - pf) <= 1e-9 * pf
                    and abs(new_pm - pm) <= 1e-9 * pm):
                break
            pf, pm = new_pf, new_pm
        link_scale = math.sqrt((pf / base.peak_flops) * (pm / base.mem_bw))
        return dataclasses.replace(base, peak_flops=pf, mem_bw=pm,
                                   link_bw=base.link_bw * link_scale,
                                   t_dispatch=td, t_collective=tc,
                                   t_loop_step=ts)


@dataclasses.dataclass(frozen=True)
class StageCost:
    flops: float
    bytes: float
    collective_bytes: float = 0.0
    #: host->device program dispatches the stage's implementation issues
    #: (NOT divided by device count: dispatch latency is serial on the host)
    dispatches: float = 0.0
    #: cross-device collective launches (psum / all_gather) the stage's
    #: distributed implementation issues; each pays a fixed latency on top
    #: of the bandwidth term (only charged on a multi-device mesh)
    collectives: float = 0.0
    #: sequential ``fori_loop``/``while_loop`` trip count of the stage's
    #: implementation (NOT divided by device count: a replicated wavefront
    #: loop is serialized regardless of mesh size, each step paying the
    #: runtime's per-iteration overhead)
    loop_steps: float = 0.0
    #: compute dtype of the stage's dominant contractions; scales the flop
    #: rate by ``DTYPE_FLOP_SPEEDUP`` and the byte traffic by the itemsize
    #: ratio against ``machine.dtype_bytes`` (how the router prices the
    #: mixed-precision variants without re-deriving every byte count)
    compute_dtype: str = "float64"

    def seconds(self, machine: MachineParams, n_devices: int) -> float:
        p = max(int(n_devices), 1)
        speedup = DTYPE_FLOP_SPEEDUP.get(self.compute_dtype, 1.0)
        byte_scale = (DTYPE_BYTES.get(self.compute_dtype, 8)
                      / max(machine.dtype_bytes, 1))
        t_comp = self.flops / (p * machine.peak_flops * speedup)
        t_mem = self.bytes * min(byte_scale, 1.0) / (p * machine.mem_bw)
        t_coll = ((self.collective_bytes * min(byte_scale, 1.0)
                   / machine.link_bw
                   + self.collectives * machine.t_collective)
                  if p > 1 else 0.0)
        return (max(t_comp, t_mem) + t_coll
                + self.dispatches * machine.t_dispatch
                + self.loop_steps * machine.t_loop_step)


def estimate_lanczos_iters(n: int, s: int, m: Optional[int] = None,
                           clustered: bool = False, p: int = 1,
                           filter_degree: int = 0) -> int:
    """Matvec-count heuristic for thick-restart Lanczos on the paper's
    workloads: well-separated MD spectra converge in a few sweeps of the
    restart subspace; clustered DFT valence bands take ~10x longer
    (the paper's Experiment 2 hit ~4k iterations at s=448).

    A Chebyshev-filtered start block (``filter_degree > 0``) damps the
    unwanted end of a clustered spectrum before the first sweep, cutting
    the restart count to roughly a third; the probe + filter matvecs it
    spends up front are added back in. ``p`` is the Lanczos block size —
    it only enters through the p-scaled default subspace (each block step
    still does p matvecs, so the matvec count itself is p-free)."""
    if m is None:
        m = default_subspace(s, n, p)
    per_restart = max(m - s, 1)
    n_restarts = 24 if clustered else 4
    extra = 0
    if filter_degree > 0:
        if clustered:
            n_restarts = max(n_restarts // 3, 4)
        # bounds probe (a short single-vector Lanczos run) + the filter
        # itself (degree matvecs on each of the p start columns)
        extra = min(max(2 * s, 12), n - 1) + filter_degree * p
    return int(min(n * 2, m + n_restarts * per_restart + extra))


def estimate_lanczos_restarts(n_iter: int, s: int, m: int,
                              p: int = 1) -> int:
    """Thick-restart count implied by a matvec budget: the first sweep does
    m matvecs, every later restart extends by ``per_restart`` more (the
    ``core.lanczos.restart_schedule`` the drivers themselves use — for a
    block driver the schedule is p-aligned, so ``per_restart`` is already
    a whole number of p-column block steps)."""
    _, per_restart = restart_schedule(s, m, p)
    return max(1, -(-(max(n_iter - m, 0)) // per_restart) + 1)


def _mesh_devices(mesh_shape: Optional[Sequence[int]]) -> int:
    if not mesh_shape:
        return 1
    p = 1
    for d in mesh_shape:
        p *= int(d)
    return p


def _tridiag_eig_cost(n: int, s: int, b: int, bisect_iters: int = 80,
                      invit_rounds: int = 3,
                      unroll: int = _TT3_UNROLL) -> StageCost:
    """TT3/TD2: Sturm bisection + shifted inverse iteration, modeling the
    fused 'batched' path of ``core.tridiag_eig`` (the default both direct
    pipelines run) instead of the old flat ``60 n s`` placeholder.

    Flops: ``bisect_iters`` interval-halving sweeps at ~5 flops per
    (row, index lane), then per inverse-iteration round the pivoted
    tridiagonal factor+solve (~12 flops per (row, shift)) and the
    cluster-wise MGS (~4 n s per column). Bytes: each sweep streams the
    O(n) diagonals across all lanes; each round streams the O(n s)
    iterate a small number of times. The serial trip count is what the
    measured wall is made of on a host backend: each bisection sweep is
    one Sturm scan of ``ceil(n / unroll)`` steps (the unroll is the
    fused path's whole speedup — it divides this term and only this
    term), and each round pays the three length-n solve scans
    (factor / forward / backward) plus the per-column MGS loop. One
    fused program, hence one dispatch.
    """
    bisect_flops = bisect_iters * 5.0 * n * s
    invit_flops = invit_rounds * (12.0 * n * s + 4.0 * n * s * s)
    bisect_bytes = bisect_iters * (n + s) * b
    invit_bytes = invit_rounds * 6.0 * n * s * b
    loop_steps = (bisect_iters * math.ceil(n / max(unroll, 1))
                  + invit_rounds * (3.0 * n + s))
    return StageCost(bisect_flops + invit_flops,
                     bisect_bytes + invit_bytes, 0.0, 1,
                     0.0, float(loop_steps))


def _chase_loop_steps(n: int, w: int) -> float:
    """Sequential wavefront steps of the TT2 bulge chase (core.sbr).

    One pass per bandwidth ``b = w..2``; a pass's ``fori_loop`` runs
    ``T_pass = g (J - 1) + 1`` steps with ``J = n - b`` columns and sweep
    stagger ``g = 2 + ceil(5 / b)`` — mirrors ``sbr._pass_schedule``.
    """
    total = 0
    for bb in range(int(w), 1, -1):
        J = n - bb
        if J <= 0:
            continue
        g = 2 + -(-5 // bb)
        total += g * (J - 1) + 1
    return float(total)


def _replay_loop_steps(n: int, w: int) -> float:
    """Sequential sweep-replay steps of the TT4 back-transform: each pass
    replays its ``J = n - b`` recorded column sweeps one fused rotation
    batch at a time (``sbr._replay_pass``)."""
    return float(sum(n - bb for bb in range(int(w), 1, -1) if n - bb > 0))


def _refinement_cost(n: int, s: int, b: int, steps: int) -> StageCost:
    """RF: one fp32 LU of the shifted pencil (half-rate vs fp64 — modeled
    by tagging the stage float32 and halving the flop count accordingly)
    plus ``steps`` fp64 correction/Cholesky-QR/Rayleigh-Ritz sweeps over
    the guarded (n, q) slab — see ``core.refinement``. The LU dominates,
    so the whole stage is priced at the fp32 rate; the per-step GEMMs are
    ~10 n^2 q fp64 flops, folded in at 2x to keep the single-dtype tag."""
    q = s + default_guard(s, n)
    n2 = float(n) ** 2
    lu_flops = 2.0 * float(n) ** 3 / 3.0
    step_flops = steps * 10.0 * n2 * q * 2.0   # fp64 work at the fp32 tag
    step_bytes = steps * 6.0 * n2 * b
    return StageCost(lu_flops + step_flops, n2 * b + step_bytes, 0.0,
                     1 + 2.0 * steps, 0.0, 0.0, compute_dtype="float32")


def stage_costs(variant: str, n: int, s: int, band_width: int = 8,
                m: Optional[int] = None, n_iter: Optional[int] = None,
                clustered: bool = False,
                machine: Optional[MachineParams] = None,
                p: int = 1, filter_degree: int = 0,
                precision: str = "fp64",
                ) -> Dict[str, StageCost]:
    """Per-stage (flops, bytes, collective_bytes, dispatches, collectives)
    per variant.

    Flop counts are the standard LAPACK/SBR operation counts; byte counts
    encode each stage's BLAS level (BLAS-2 stages stream the trailing
    matrix once per reflector — the n^3-bytes signature of DSYTRD — while
    BLAS-3 stages touch each operand O(n/block) times, modeled as a small
    constant number of passes). Dispatch counts model the CURRENT
    implementations: every direct stage is a single (or a couple of)
    jitted program(s) — in particular TT1 is the fused one-program panel
    sweep, NOT the old O(n/w)-dispatch host loop — and the distributed
    Krylov driver runs each thick restart (segment + restart math +
    convergence flag) as ONE fused shard_map program, so it pays
    ``restarts + 2`` dispatches total (the +2: bounds-probe/filter prep
    and the final Ritz extraction), not the old 3-per-restart host loop.
    Collective counts charge the communication-avoiding block matvec its
    exact budget: 2 collectives (one psum + one all_gather) per p-column
    block step, so raising ``p`` divides the collective-latency term by p
    while leaving the matvec flops unchanged — the knob that makes
    distributed KE competitive again.
    """
    assert variant in VARIANTS, variant
    machine = machine or MachineParams()
    b = machine.dtype_bytes
    n3, n2 = float(n) ** 3, float(n) ** 2
    w = band_width
    p_blk = max(int(p), 1)
    if m is None:
        m = default_subspace(s, n, p_blk)
    if n_iter is None:
        n_iter = estimate_lanczos_iters(n, s, m, clustered=clustered,
                                        p=p_blk, filter_degree=filter_degree)
    coll_panel = n2 * b  # O(n w) panel broadcast x (n / w) panels

    costs: Dict[str, StageCost] = {}
    # GS1: blocked Cholesky — BLAS-3
    costs["GS1"] = StageCost(n3 / 3.0, 3 * n2 * b, coll_panel / 2, 1)
    # GS2: two full-matrix TRSMs (the paper's 2n^3 pick) — BLAS-3
    if variant != "KI":
        costs["GS2"] = StageCost(2 * n3, 6 * n2 * b, coll_panel, 2)

    if variant == "TD":
        # TD1: BLAS-2 tridiagonalization — 4/3 n^3 flops but the trailing
        # matrix is streamed once per reflector: ~n^3/3 elements read.
        costs["TD1"] = StageCost(4 * n3 / 3.0, (n3 / 3.0) * b, 0.0, 1)
        costs["TD2"] = _tridiag_eig_cost(n, s, b)
        costs["TD3"] = StageCost(4 * n2 * s, 3 * n2 * b, 0.0, 1)
    elif variant == "TT":
        # TT1: band reduction 4/3 n^3 + explicit Q1 accumulation 2 n^3,
        # all GEMMs (BLAS-3: the trailing matrix streams once per panel,
        # n/w passes — the 1/w factor is what makes TT compute-bound).
        # The whole sweep is ONE fused program + the band repack: 2
        # dispatches, NOT n/w (see core.sbr.reduce_to_band /
        # dist.sharded_la.band_sweep_program). Each panel iteration of the
        # distributed sweep issues exactly 3 collectives — all_gather of
        # the panel (doubling as its broadcast), psum of the (w, w)
        # coupling, all_gather of the Z panel — a count the static auditor
        # cross-checks against the lowered program (the old 2/panel here
        # was model drift, caught by exactly that check).
        costs["TT1"] = StageCost(4 * n3 / 3.0 + 2 * n3,
                                 (n3 / max(w, 1)) * b, coll_panel, 2,
                                 3.0 * n / max(w, 1))
        # TT2: wavefront bulge chasing over packed (w+1, n) band storage —
        # O(n^2 w) flops touching only the O(n w) band. The rotation stream
        # is recorded, NOT accumulated into an (n, n) Q2 (that would cost
        # 3 n^3 sum_{2..w} 1/b extra flops — the unmodeled cost behind the
        # old 19us-predicted / 16s-measured gap); the stream replays onto
        # the thin slab in TT4.
        h_w = sum(1.0 / bb for bb in range(2, max(w, 2) + 1))
        # The chase is ONE dispatched program, but inside it the wavefront
        # schedule is a genuinely sequential fori_loop — ~g n steps per
        # bandwidth pass — and each step pays the runtime's per-iteration
        # overhead. On a host mesh that serial term (~100us x thousands of
        # steps), not the O(n w) byte traffic, is what the measured TT2
        # wall is made of; modeling it as bytes is the fit-distorting
        # outlier behind the old calibration failures.
        costs["TT2"] = StageCost(6 * n2 * w, 6 * n2 * w * b / 8, 0.0, 1,
                                 0.0, _chase_loop_steps(n, w))
        costs["TT3"] = _tridiag_eig_cost(n, s, b)
        # TT4: replay the ~n^2/2 sum 1/b recorded rotations over the (n, s)
        # Ritz slab (6s flops each), then one GEMM against the explicit Q1.
        # The replay shares TT2's serial character: one fused rotation
        # batch per recorded column sweep, ~(w-1) n sequential steps.
        costs["TT4"] = StageCost(
            2 * n2 * s + 2 * n * s * s + 3 * n2 * s * h_w,
            3 * n2 * b + (n2 / 2) * h_w * b, n * s * b, 2,
            0.0, _replay_loop_steps(n, w))
    else:
        # Krylov iteration: each matvec streams the n^2 operand (memory
        # bound); re-orthogonalization adds 8 n m flops per step. KI's
        # implicit operator is two triangular solves + one SYMV. The
        # distributed driver fuses each thick restart (m-step block
        # segment + restart math + convergence flag) into ONE shard_map
        # program — ``restarts + 2`` dispatches total, the +2 being the
        # filter/seed prep and final Ritz-vector extraction — and the
        # communication-avoiding block matvec pays exactly 2 collectives
        # (psum + all_gather) per p-column block step. At O(ms) per
        # dispatch/collective on a host mesh these latency terms, not the
        # flops, decide the race; p divides the collective term.
        mv_flops = (2 * n2 if variant == "KE" else 4 * n2) + 8.0 * n * m
        mv_bytes = (n2 if variant == "KE" else 2 * n2) * b + 2.0 * n * m * b
        n_restart = estimate_lanczos_restarts(n_iter, s, m, p_blk)
        n_block_steps = -(-int(n_iter) // p_blk)
        costs[f"{variant}_iter"] = StageCost(
            n_iter * mv_flops, n_iter * mv_bytes, n_iter * n * b,
            n_restart + 2, 2.0 * n_block_steps)

    # BT1: X = U^{-1} Y, one TRSM on an (n, s) slab
    costs["BT1"] = StageCost(n2 * s, 2 * n2 * b, n * s * b, 1)

    cdtype = _PRECISION_DTYPE.get(precision)
    if cdtype is None:
        raise ValueError(f"precision must be one of "
                         f"{tuple(_PRECISION_DTYPE)}, got {precision!r}")
    if cdtype != "float64":
        # demote exactly the stages the solvers demote, and append the
        # fp64 refinement stage that buys the accuracy back
        for st in DEMOTED_STAGES:
            if st in costs:
                costs[st] = dataclasses.replace(costs[st],
                                                compute_dtype=cdtype)
        costs["RF"] = _refinement_cost(n, s, b,
                                       default_refine_steps(precision))
    return costs


def predict_stage_times(variant: str, n: int, s: int,
                        machine: Optional[MachineParams] = None,
                        mesh_shape: Optional[Sequence[int]] = None,
                        **kw) -> Dict[str, float]:
    """Predicted seconds per stage (plus 'Tot.') for one variant."""
    machine = machine or MachineParams()
    p = _mesh_devices(mesh_shape)
    costs = stage_costs(variant, n, s, machine=machine, **kw)
    times = {k: c.seconds(machine, p) for k, c in costs.items()}
    times["Tot."] = sum(times.values())
    return times


@dataclasses.dataclass(frozen=True)
class VariantChoice:
    variant: str
    predicted_s: float
    table: Dict[str, float]          # variant -> predicted total seconds
    n_devices: int

    def as_json_dict(self) -> dict:
        return {"variant": self.variant,
                "predicted_s": float(self.predicted_s),
                "table": {k: float(v) for k, v in self.table.items()},
                "n_devices": int(self.n_devices)}


def choose_variant(n: int, s: int, band_width: int = 8,
                   m: Optional[int] = None, n_iter: Optional[int] = None,
                   clustered: bool = False,
                   machine: Optional[MachineParams] = None,
                   mesh_shape: Optional[Sequence[int]] = None,
                   allow: Optional[Sequence[str]] = None,
                   krylov_block: int = 1,
                   filter_degree: int = 0,
                   precision: str = "fp64") -> VariantChoice:
    """Pick the fastest variant under the cost model.

    With a multi-device ``mesh_shape`` the candidate set narrows to the
    variants that actually have a distributed implementation (TT, KE);
    ties break toward the earlier entry of ``VARIANTS`` for determinism.
    ``krylov_block`` / ``filter_degree`` describe the Krylov pipelines the
    KE/KI candidates would actually run (block size p divides the
    collective-latency term; a Chebyshev filter cuts the clustered-spectrum
    iteration estimate) — they do not affect the direct variants.
    ``precision`` prices the mixed pipelines: the demoted stages run at
    the reduced-dtype rate and the fp64 refinement stage is added back,
    so the router can decide when demotion actually pays per variant.
    """
    p = _mesh_devices(mesh_shape)
    if allow is None:
        allow = DISTRIBUTED_VARIANTS if p > 1 else VARIANTS
    table: Dict[str, float] = {}
    for v in VARIANTS:
        if v not in allow:
            continue
        kkw = ({"p": krylov_block, "filter_degree": filter_degree}
               if v in ("KE", "KI") else {})
        table[v] = predict_stage_times(
            v, n, s, machine=machine, mesh_shape=mesh_shape,
            band_width=band_width, m=m, n_iter=n_iter,
            clustered=clustered, precision=precision, **kkw)["Tot."]
    best = min(table, key=lambda v: (table[v], VARIANTS.index(v)))
    return VariantChoice(variant=best, predicted_s=table[best], table=table,
                         n_devices=p)
