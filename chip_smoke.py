#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printed as it runs; any failed check exits nonzero:

1. the card (``torch.cuda`` and ``nvidia-smi``), then the build of every
   CUDA source under ``src/repro_torch/csrc`` with ``nvcc`` (sm_90a);
2. each TD2 kernel against its plain PyTorch version on the tridiagonal
   that TD1 makes of the MD pencil at the paper's size (n=9997, the s=100
   smallest; plain on CPU copies, as the wrapper runs it for a CPU tensor)
   and that TT1 + TT2 make of the DFT pencil at the paper's size (n=17243,
   s=448; the plain ``invit`` on the card, where the host would take
   minutes):
   ``bisect_sturm`` bitwise, ``invit`` by residual, orthogonality,
   per-cluster subspace angle and elementwise on singleton clusters, and
   bitwise on repeat; kernel and plain timed in turns (kernel, plain,
   kernel); ``bisect by levels``: the bisection at every m (levels a
   Sturm sweep) a block holds, with the early stop and without it, in
   turns, each bitwise against the plain version, with the kernel's own
   step time at each lane count; the sweep at which the indices stopped
   (min, median, max); the bisection's chain floors (one lane at m=1, and
   the plan's sweeps x n x that one-lane step) and the wrapper against
   m=1 without the stop at the first design's 128 threads a block, in
   turns (checked at most a quarter of it); one ``invit`` call's device
   time by kernel (the solve and the Gram-Schmidt); the ``invit`` solve's
   chain floor (one shift against all s);
3. the one-triangle product (``symm_block`` at p=1 and p=4, ``symv``)
   against its plain version on CPU copies, componentwise within
   gamma_n (|sym(triu A)| |X|), on the MD standard-form C and on a random
   symmetric matrix at the DFT width n=17243 whose strictly lower triangle
   holds 1e6-scale garbage; two runs of each checked bitwise equal; timed
   in turns, beside ``torch.matmul`` on the full matrix (the library call
   that computes the same function), with the kernel's TB/s on the
   triangle; on the MD C, ``symm_block`` at p=1 under each compiled width
   of X a pass in turns, the wrapper's host time a call, ``torch.sum``
   over A (the card's read rate on those bytes), the device
   time of the tile pass and the slot sum (``torch.profiler``), and the
   rounding error of ``symm_block`` and ``torch.matmul`` against an
   extended-precision reference;
3b. the TT kernels against their plain versions on CPU copies:
   ``house_panel`` through both its paths (the plan's: the active rows in
   one cluster's distributed shared memory; the cooperative kernel) on
   the first panel of the MD standard-form C (``C[:, :16]``, row_start
   16), on the first DFT panel and on a mid-ladder MD panel (V and T
   entrywise, I - V T V^T orthogonal, bitwise on repeat), the paths in
   turns, and on the first MD panel by part: the wrapper's time a call and
   its host enqueue, each path's device time (``torch.profiler``) and
   timing variants (barriers alone, no cross-CTA sums, the cooperative
   kernel without barriers) in turns, and ``torch.geqrf`` on the same
   rows; ``syr2k`` on the first window
   (n=9997, k=16) within gamma_{2k+1} (|C| + |V||W|^T + |W||V|^T), beside
   ``torch.addmm`` of the concatenated panels; ``rot_apply`` bitwise at
   the chase's wavefront shapes and a replay shape, beside ``torch.matmul``
   of the (G, 2, 2) rotations with the pairs, both timed per call (CUDA
   events) and as device time (``torch.profiler``); the whole TT2 chase
   (``chase_pass``, both paths: the band in one cluster's distributed
   shared memory, and the cooperative kernel) and the TT4 replay
   (``replay_pass``, both paths: the slab's columns in shared memory, and
   the sweep kernel) of the MD band at n=512, w=16 against the plain
   versions on the host CPU; then, at the main path's n=9997, w=16, the
   whole chase, its first and last pass also through the cooperative path
   and the plain version on the card (on the same input), each pass timed,
   and the parts of a step timed apart on those two passes (each path
   whole, its barriers alone, without them; the kernel's timing variants)
   and the replay of all the MD tables onto an (n, 100) slab through both
   paths against the plain version on the card, each pass timed, and by
   part (no table, no chunk barrier, lane 0 alone), and forward onto
   (n, 528), (n, 1056) and (n, n), ``accumulate_q2``'s shape, through
   both paths,
   bitwise against each other; the DFT replay (all the DFT tables from
   phase 2 onto (17243, 448)) through both paths, bitwise against each
   other; the band within
   1e-12 ||W||_2, the slab within 1e-12, and band, tables and slab
   bitwise;
3c. the BLAS kernels at the MD shapes, with U = cholesky_upper(B):
   ``gemm`` at (n, n)(n, 100) and (n, n)(n, n) within gamma_k |A||B| of
   its plain version (``torch.matmul`` on the card, also the library
   call); the blocked ``trsm`` (``trsm_tile`` + ``gemm``) at the BT1 shape
   (U X = B, B (n, 100)) and the GS2 shape (U^T X = A) against the plain
   composite on the card, with its backward error ||op(U) X - B||_F /
   (||U||_F ||X||_F) within n eps, its launches per call (ceil(n/128)
   tiles, and per update the launches ``gemm_kernel.plan`` gives: two
   where K is split), beside ``torch.linalg.solve_triangular``;
   ``trsm_tile`` alone on U's first (128, 128) tile with n RHS columns;
   the products the blocked stages launch, at their MD shapes, each
   within gamma_(k+1) (|C| + |A||B|) of its plain version and timed in
   turns beside ``addmm_``: a BT1 update (128 x 100, K = n - 128, A read
   in place from U), a GS2 sygst update (128 x 256, K = n - 256, A
   transposed) and the first GS1 SYRK update (n - 256 square, K = 256,
   into a view); max|S - S^T| of the SYRK-shaped product; two runs of
   ``gemm`` at (n^2, 100) and of the BT1 ``trsm`` checked bitwise equal;
   the DMMA instructions in ``libgemm.so`` (``cuobjdump -sass``, checked
   > 0, "not measured" without cuobjdump);
   ``band_mv`` on the MD band (TT1 at w=16, ``to_band_mv_layout``) against
   its plain version and ``unpack_band(Wb) @ x``, within gamma_(2w+1)
   |A||x|; in both layouts (contiguous, and the transposed view) bitwise
   on repeat, against the direct kernel and across layouts, with the
   wrapper's time a call, host enqueue and device time, beside an empty
   kernel's on the same grid (the floor of one launch);
4. the main paths, each with every launch count set to 0 just before and
   read just after: ``solve(A, B, 100, variant="TD")`` on the MD pencil;
   ``solve(A, B, 100, variant="KE"|"KI", invert=True, use_kernel=True)``
   and KE with ``krylov_block=4`` (their ``symm_block`` launches printed
   beside ``n_matvec``; then KE p=4 on ``torch.matmul`` for its counts,
   and one KE solve under ``torch.profiler``: wall, host enqueue and
   device time by kernel); ``solve(A, B, 100, variant="TT",
   band_width=16)`` (624 ``house_panel`` and ``syr2k`` launches, 15 of
   ``chase_pass`` and ``replay_pass``, 6 of ``invit``; the plans the
   ``chase_pass``, ``replay_pass`` and ``house_panel`` launches take at
   each level) and TT and TD on
   the DFT pencil at the paper's size (n=17243, s=448); each held to the
   Table-3 bars (1e-12) and to the
   generator's exact spectrum; the blocked stages (the paper's Table 4):
   ``solve(..., variant="TD", gs1="blocked", gs2="sygst", td1="blocked")``
   and KE with ``gs1="blocked", gs2="sygst"`` on the MD pencil, held to the
   same bars and to the fused TD's eigenvalues within 1e-10 max|lambda|,
   their GS1/GS2/TD1 times printed beside the fused ones, and GS1 blocked
   and GS2 sygst alone: wall clock, host enqueue time and device time by
   kernel (``torch.profiler``); then one call of
   each public entry point that ``solve`` does not reach: ``apply_op(
   ExplicitC(C), x, use_kernel=True)`` on a vector (``symv``),
   ``rot_apply``, ``gemm``, ``trsm`` (the BT1 shape) and ``band_mv``;
3d. the fp32 and bf16 instances (``_fp32``, ``_bf16``) against their
   plain versions on the card, at the MD shapes: ``house_panel`` on the
   first panel (the wrapper's cluster kernel and the cooperative instance
   forced, the older path, in turns, each within the panel's bar and
   bitwise on repeat; each path's device time; the cluster at 16, 8 and 4
   CTAs, its barriers alone and without cross-CTA sums, queued in turns),
   ``syr2k`` on the
   first window (k=16, plain and symmetrized), ``chase_pass`` on the first
   (b=16) and last (b=2) pass of the MD band (the wrapper's cluster kernel
   and the cooperative kernel forced, the older path, in turns, each
   bitwise; the cluster at 16 and 8 CTAs in turns, each whole and with
   its barriers alone, the chain floor), ``replay_pass`` of those two
   tables onto (n, 100) (the wrapper's slab kernel and the sweep kernel
   forced, in turns, each bitwise; no table and lane 0 alone, the chain
   floor; then all 15 passes, slab against sweep, in turns), ``rot_apply``
   at G=1000, L=8, and ``symm_block`` at
   p=1 and p=4 and ``symv`` on C (the plain chase on a host copy, the
   others on the card); bitwise where the plain version rounds
   at the kernel's points, else within the gamma bars stated in
   ``compare_reduced``; each timed beside its bound at 4 or 2 bytes an
   entry and fp32's 67 TFLOP/s, and beside the library call where one
   exists (``torch.addmm``, ``torch.matmul``, ``torch.geqrf``); C in the
   main path's layout (rows padded to 16 bytes, ``padded_copy``), and
   ``syr2k`` and the product also on the odd-lda copy (their narrow
   paths: ``syr2k_tiles``, ``symm_wide`` entry by entry), each path
   checked and repeated bitwise, timed in turns with each other (and
   ``syr2k``'s narrow path also on the padded copy);
4b. the precision levels on the MD pencil at the paper's size: TT, KE and
   KI at ``mixed`` and ``fast`` and TD at ``mixed`` (``on_failure=
   "recover"``), each held to the Table-3 bars on the original pencil and
   the exact spectrum, with its refinement (steps, shifts, residual
   trajectory), recovery rungs and per-instance launch counts (624
   ``house_panel``/``syr2k`` and 15 ``chase_pass``/``replay_pass`` launches
   of the level's instances in TT, every panel and every chase pass on the
   cluster kernels and every replay pass on the slab kernel; the reduced product's and
   ``syr2k``'s launches by load path, the TT ``syr2k`` and the Krylov
   products all on the wide path);
   then a fault drill: a transient NaN in
   GS2's input through TD (n=1000) recovered by ``transient_retry``, with
   ``info`` JSON-clean;
4c. batched buckets and the router: ``solve_batched`` (one CUDA graph
   per piece of a bucket's program) at the serving engine's size limit,
   ``md_like(1024)`` with s=10 and batch 8 through TD, TT (w=16), KE and
   KI (invert, the kernel product) at fp64 and TT and KE at ``mixed``,
   and ``dft_like(1024)`` with s=27 through TD and TT; and TT at MD
   n=9997, s=100, batch 2. Each bucket: every pencil against an eager
   ``solve`` of it at the same level (1e-10 max|lambda| at fp64, 1e-12
   below), the Table-3 bars, converged and healthy, a second call a cache
   hit with compile_s 0, and for TD/TT its launches a replay equal to
   batch x the eager counts; printed: compile_s, the graphs and their
   replays, the warm call's wall and pencils/s against the eager loop's
   (one of each), and the call's span on its stream by CUDA events (idle
   gaps included: ``launch/solve_profile.py --batch`` reads the device
   time). Then
   ``solve(variant="auto", machine=MachineParams.h100())`` at MD
   (invert) and DFT (clustered), each held to the bars; KE and KI at DFT
   once each (clustered, a restart budget; not a check); the predicted
   totals of the four variants beside this run's measured ones; whether
   the MD choice is the measured fastest fp64 variant; and
   ``MachineParams.from_measurements`` of this run's MD fp64 stage times
   beside ``h100()``;
4d. the serving engine (``serve/eigen_engine.py``) at its real size:
   16 ``md_like(1024)`` pencils at s=10 and 16 ``dft_like(1024)`` at s=27,
   interleaved, through ``EigenEngine(slots=8, bucket_shapes=[1024],
   variant="TD")`` with ``tick()`` after each submit (two buckets of two
   dispatches, served from phase 4c's captured TD programs: each
   dispatch's cache_hit and compile_s, requests/s, each bucket's mean and
   p90 latency); the MD paper pencil (invert) in the same engine through
   the router's direct path, its choice beside phase 4's measured fastest
   fp64 variant; every retired pencil on the exact spectrum (1e-10
   max|lambda|) and the Table-3 bars; the quarantine drill (KE,
   ``max_restarts=1``: both lanes quarantined and retired) and the
   dead-letter drill (TT, a non-SPD pencil dead-lettered with
   ``cholesky_breakdown``, the healthy lane retired, every ``info``
   JSON-clean); the launches of all that (the wrappers' counts, set to 0
   before and read after, plus the TD graphs' replayed launches); then
   ``python -m repro_torch.launch.eigenserve`` (16 requests, two TT
   dispatches of 8) in a subprocess, which must exit 0 and print ``eigenserve OK``;
4e. the distribution layer (``repro_torch.dist``) on a (1, 1) NCCL mesh
   in this process (``dist.launcher.run_local``), on phase 4's MD pencil:
   ``solve(variant="KE", invert=True, mesh=)`` (p=4) and
   ``solve(variant="TT", band_width=16, mesh=)`` at fp64 and mixed, each
   held to the Table-3 bars, the exact spectrum and the single-device
   solve of its level (phase 4's KE p=4 and TT, phase 4b's KE and TT
   mixed) within 1e-10 max|lambda|, stage times beside the single-device
   ones, the collectives by kind, at mixed the refinement and the recovery
   rungs (and KE's own mixed attempt under ``on_failure="warn"``, printed,
   not checked), and the TT launches (every panel on
   ``house_panel``, every pass on ``chase_pass``/``replay_pass``, one
   ``bisect_sturm``, six ``invit``); the preemption drill (KE with a
   checkpoint every restart, preempted after 2, resumed from the newest
   checkpoint: the uninterrupted mesh run's eigenvalues within 1e-12
   max|lambda|), the checkpoint's bytes and save time; the process group
   destroyed after;
4f. the audit (``python -m repro_torch.launch.audit``'s ``run_audit``) on
   the card: every non-mesh entry at the ``AuditSpec`` (n=64, s=4, w=8,
   p=4, m=24; the batched buckets at n=32, batch 2, at fp64, mixed and
   fast) and the mesh entries on phase 4e's one-rank NCCL mesh (1, 1),
   whose collective counts the contracts fix at any world size; each
   entry's contract, and its recorded kernel calls against the launch
   counters' deltas instance by instance (every one of the ten kernel
   functions, and the fp32/bf16 instances the buckets reach, launched on
   an audited path); the payload's ``ok``; the cost-model cross-check and
   its dispatch-drift lines (the model's dispatches a stage beside the
   counted launches and stage entries);
4g. the LM serving path (``repro_torch.models``, ``serve/engine.py``,
   ``launch/serve.py``), which runs no kernel of the table (its launches,
   counted from 0, must stay 0): (a) every one of the ten smoke configs
   at fp32 from seeded weights, 8 decode steps on the card against the
   same on the host (1e-4 max|logit|) and decode against prefill on the
   card (2e-3); (b) gemma3-1b at full width (26 layers, d_model 1152,
   vocab 262144, ~1.0e9 parameters drawn on the card from seed 0): a
   16-token fp32 forward against the host (1e-4 max|logit|), then at bf16
   a ``ServeEngine`` of 4 slots and capacity 1024 serving 8 requests of
   32 new tokens with staggered admissions (prompts 8-64 tokens and one
   of 600, past the 512-slot local rings), every token in range; the
   600-token request and one admitted into a freed slot rerun solo in an
   engine of 4 slots, in a process of their own beside the staggered run
   (the same weights, by their checksum, and the same tokens); an int8 KV
   decode against the bf16 cache (the reference's bars: 0.05 max|logit|,
   0.9 greedy agreement); printed, not checked: ms a tick and tokens/s at
   B=4 and prefill-by-decode ms a prompt token (20 and 7 ticks on the
   otherwise idle card), the peak memory, and over 20 ticks under
   ``torch.profiler`` the kernel launches a tick and the device's idle
   share; (c) ``python -m repro_torch.launch.serve --arch gemma3-1b
   --batch 4 --prompt-len 32 --gen 32``, started with the phase in a
   process of its own, which must exit 0 and print ``serve OK``;
5. one JSON line of the kernels (launches on their main path, launches
   in phase 4c's warm calls, in phase 4d, in phase 4e and in phase 4f's
   audit, error against the plain version, times, bound), the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``.

``--md-n`` / ``--dft-n`` / ``--wide-n`` / ``--chase-n`` shrink the
matrices for a quick rehearsal; the defaults are the sizes above.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): fp64 outside the tensor cores,
# fp64 through the tensor cores (DMMA, which cuBLAS reaches: the bound of
# the BLAS-3 kernels gemm, trsm, trsm_tile and of band_mv) and HBM3
# bandwidth
FP64_VECTOR_FLOPS = 34e12
FP64_TENSOR_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 outside the tensor cores: the rate of the reduced (fp32 and bf16)
# instances, which all compute in fp32
FP32_VECTOR_FLOPS = 67e12

TABLE3 = 1e-12           # relative_residual and b_orthogonality bars
EVAL_BAR = 1e-10         # max eigenvalue error / max|lambda| of the spectrum
INVIT_RESID = 1e-12      # ||T z - lam z||_2 / ||T||_1, per column
INVIT_ORTH = 1e-12       # max |Z^T Z - I|
INVIT_SINGLETON = 1e-10  # elementwise kernel vs plain, singleton clusters
INVIT_SUBSPACE = 1e-8    # sin of the largest principal angle per cluster
TIMING_REPS = 20         # launches per timed window of the product

HOUSE_TOL = 1e-12        # V and T entrywise, kernel vs plain (|v| <= 1)
HOUSE_ORTH = 1e-13       # max |Q^T Q - I| / rows for Q = I - V T V^T
CHASE_TOL = 1e-12        # d, e of the chase vs plain, relative to ||W||_2
REPLAY_TOL = 1e-12       # the replayed slab vs plain, entrywise
# blocked trsm and trsm_tile vs their plain versions: max|X_k - X_p| /
# max|X_p|. U = cholesky(B) of the MD pencil is I + N with N strictly upper
# of entries ~0.3/sqrt(n) (data/problems.py), so ||N||_2 < 1 and
# kappa(U) is O(1); two backward-stable solves then differ by ~2 kappa n u
# (~1e-11 at n = 9997 for kappa ~ 5) at most
TRSM_REL = 1e-10
TRSM_BLOCK = 128         # trsm's default block (the tile kernel's largest)
TT_W = 16                # the TT band width of the main path (solve's default)

_ROT = "src/repro_torch/csrc/rot_apply.cu"
SOURCES = {"gemm": "src/repro_torch/csrc/gemm.cu",
           "trsm_tile": "src/repro_torch/csrc/trsm.cu",
           "band_mv": "src/repro_torch/csrc/band_mv.cu",
           "bisect_sturm": "src/repro_torch/csrc/tridiag_eig.cu",
           "invit": "src/repro_torch/csrc/tridiag_eig.cu",
           "symv": "src/repro_torch/csrc/symv.cu",
           "symm_block": "src/repro_torch/csrc/symv.cu",
           "house_panel": "src/repro_torch/csrc/house_panel.cu",
           "syr2k": "src/repro_torch/csrc/syr2k.cu",
           "rot_apply": _ROT, "chase_pass": _ROT, "replay_pass": _ROT}
REPLACES = {"bisect_sturm": "src/repro/kernels/tridiag_eig/kernel.py:74",
            "invit": "src/repro/kernels/tridiag_eig/kernel.py:194",
            "symv": "src/repro/kernels/symv/kernel.py:82",
            "symm_block": "src/repro/kernels/symv/kernel.py:117",
            "house_panel": "src/repro/kernels/house_panel/kernel.py:81",
            "syr2k": "src/repro/kernels/syr2k/kernel.py:34",
            "rot_apply": "src/repro/kernels/rot_apply/kernel.py:37",
            "chase_pass": "src/repro/kernels/rot_apply/kernel.py:37",
            "replay_pass": "src/repro/kernels/rot_apply/kernel.py:37",
            "gemm": "src/repro/kernels/gemm/kernel.py:45",
            "trsm_tile": "src/repro/kernels/trsm/kernel.py:65",
            "band_mv": "src/repro/kernels/band_mv/kernel.py:53"}
KERNEL_ORDER = ("bisect_sturm", "invit", "symv", "symm_block", "house_panel",
                "syr2k", "rot_apply", "chase_pass", "replay_pass", "gemm",
                "trsm_tile", "band_mv") + tuple(
    f"{k}_{sfx}" for sfx in ("fp32", "bf16")
    for k in ("symv", "symm_block", "house_panel", "syr2k", "rot_apply",
              "chase_pass", "replay_pass"))


def _nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_cuda(fn, reps: int = 1):
    """(result of the last call, ms per call) over ``reps`` calls between
    two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _time_host(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _tridiag_matvec(d, e, Z):
    TZ = d[:, None] * Z
    TZ[:-1] += e[:, None] * Z[1:]
    TZ[1:] += e[:, None] * Z[:-1]
    return TZ


def _bound(ops: float, nbytes: float, peak: float = FP64_VECTOR_FLOPS) -> dict:
    """Least time for the work: operations over the fp64 peak (the vector
    rate unless ``peak`` says otherwise), bytes (inputs read once, outputs
    written once) over HBM bandwidth."""
    t_ops = 1e3 * ops / peak
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def compare_td2_kernels(label: str, d, e, s: int, checks: Checks,
                        plain_dev="cpu", seed: int = 20120520) -> dict:
    """Both TD2 kernels against their plain versions on tridiag(d, e), the s
    smallest indices, the plain versions once each, between the kernel's
    two runs (tens of seconds at these sizes): the bisection on CPU
    copies (its row loop of small operations runs faster on the host than
    as launches on the card), ``invit`` on ``plain_dev`` copies (the host
    CPU, or the card where the host would take minutes). Then one
    ``invit`` call's device time by kernel (the solve and the Gram-Schmidt)
    and two runs checked bitwise equal. Returns one row per kernel (error,
    times, bound)."""
    import torch
    from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                              bisect_inputs, normalize_columns,
                                              start_block)
    from repro_torch.kernels.tridiag_eig import kernel, ref

    n = d.shape[0]
    on_card = torch.device(plain_dev).type == "cuda"
    where = "the card" if on_card else "the host CPU"
    timer = _time_cuda if on_card else _time_host
    e2, scal = bisect_inputs(d, e)
    ks = torch.arange(s, device=d.device)
    host = [t.cpu() for t in (d, e2, ks, scal)]
    kernel.bisect_sturm(d, e2, ks, scal)   # warm-up: loads the module
    lam_k, k1 = _time_cuda(lambda: kernel.bisect_sturm(d, e2, ks, scal))
    lam_p, p1 = _time_host(lambda: ref.bisect_sturm_ref(*host))
    _, k2 = _time_cuda(lambda: kernel.bisect_sturm(d, e2, ks, scal))
    bis_err = float(torch.max(torch.abs(lam_k.cpu() - lam_p)))
    print(f"{label} bisect_sturm: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.1f} ms (plain on the host CPU)", flush=True)
    checks.check(f"{label} bisect_sturm bitwise",
                 torch.equal(lam_k.cpu(), lam_p),
                 f"max |kernel - plain| = {bis_err!r}")
    levels_needed = bisect_levels(label, d, e2, ks, scal, lam_p,
                                  (k1 + k2) / 2, checks)
    # Sturm recurrence: sub, div, sub per row and level, for the levels
    # each index takes to its fixed point in this run
    rows = {"bisect_sturm": dict(
        max_abs_err=bis_err, ms=(k1 + k2) / 2, plain_ms=p1, library_ms=None,
        **_bound(levels_needed * n * 3, 8 * (2 * n + 3 + 2 * s)))}

    lam = lam_k
    cid = _cluster_ids(lam, _scale(d, e))
    piv = _pivmin(d, e)
    gen = torch.Generator(device=d.device).manual_seed(seed)
    X0 = normalize_columns(start_block(n, s, gen, d.device))
    args = (d, e, lam, cid, piv, X0)
    plain_in = [t.to(plain_dev) for t in args]
    kernel.invit(*args)                    # warm-up
    profile_stage(f"{label} invit", lambda: kernel.invit(*args))
    Z_k, k1 = _time_cuda(lambda: kernel.invit(*args))
    Z_p, p1 = timer(lambda: ref.invit_ref(*plain_in))
    _, k2 = _time_cuda(lambda: kernel.invit(*args))
    Z_p = Z_p.cpu()
    print(f"{label} invit: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.1f} ms (plain on {where})", flush=True)
    checks.check(f"{label} invit repeats bitwise",
                 bool(torch.equal(kernel.invit(*args), Z_k)),
                 "two runs of the kernel")
    td2_chain_floors(label, d, e, lam, piv, X0)

    ea = torch.abs(e)
    zero = ea.new_zeros(1)
    tnorm = float(torch.max(torch.abs(d) + torch.cat([zero, ea])
                            + torch.cat([ea, zero])))
    R = _tridiag_matvec(d, e, Z_k) - Z_k * lam[None, :]
    resid = float(torch.max(torch.linalg.vector_norm(R, dim=0))) / tnorm
    eye = torch.eye(s, dtype=Z_k.dtype, device=Z_k.device)
    orth = float(torch.max(torch.abs(Z_k.mT @ Z_k - eye)))
    checks.check(f"{label} invit residual", resid <= INVIT_RESID,
                 f"max ||T z - lam z||_2 / ||T||_1 = {resid!r}")
    checks.check(f"{label} invit orthogonality", orth <= INVIT_ORTH,
                 f"max |Z^T Z - I| = {orth!r}")

    Zk = Z_k.cpu()
    sign = torch.where(torch.sum(Zk * Z_p, 0) < 0, -1.0, 1.0).to(Zk.dtype)
    diff = torch.abs(Zk - Z_p * sign[None, :])
    cid_c = cid.cpu().long()
    sizes = torch.bincount(cid_c)
    single = sizes[cid_c] == 1
    single_err = float(diff[:, single].max()) if bool(single.any()) else 0.0
    sub_err = 0.0
    for c in torch.nonzero(sizes > 1).flatten().tolist():
        cols = cid_c == c
        Ak, Bp = Zk[:, cols], Z_p[:, cols]
        sub_err = max(sub_err, float(torch.linalg.matrix_norm(
            Ak - Bp @ (Bp.mT @ Ak), ord=2)))
    print(f"{label} invit: {int(sizes.numel())} clusters, largest "
          f"{int(sizes.max())}, {int(single.sum())} singletons", flush=True)
    checks.check(f"{label} invit singleton columns vs plain",
                 single_err <= INVIT_SINGLETON,
                 f"max |z_kernel - z_plain| (signs fixed) = {single_err!r}")
    checks.check(f"{label} invit cluster subspaces vs plain",
                 sub_err <= INVIT_SUBSPACE,
                 f"max sin(largest principal angle) = {sub_err!r}")
    # per round: solve ~11 flops per row and lane, norms ~4, the cluster
    # Gram-Schmidt 4n per in-cluster pair plus a renormalization (~4 n s)
    pairs = float(torch.sum(sizes * (sizes - 1) // 2))
    rows["invit"] = dict(
        max_abs_err=float(diff.max()), ms=(k1 + k2) / 2, plain_ms=p1,
        library_ms=None,
        **_bound(3 * (19 * n * s + 4 * n * pairs),
                 8 * (2 * n + 2 * s + 2 * n * s)))
    return rows


def bisect_levels(label: str, d, e2, ks, scal, lam_p, wrapper_ms: float,
                  checks: Checks) -> int:
    """``bisect_sturm`` at each m (bisection levels a Sturm sweep) that a
    block holds at the plan's indices a block, with the early stop and
    without, in turns (AB BA), through ``bisect_launch`` (no launch
    counted); every variant bitwise against the plain version. Without the
    stop each variant runs ceil(80/m) sweeps of n steps, so its time gives
    the kernel's own step time at the threads an SM runs (teams x 2^m).
    Then the sweep at which the indices stopped under the plan, and the
    bisection's chain floors: one lane alone at m=1 (80 n dependent Sturm
    steps) against all s, and the plan's sweeps x n x that one-lane step.
    The wrapper is timed in turns against m=1 without the stop at 64
    indices a block (the first design's 128 threads a block) and checked
    at most a quarter of it. Returns the levels the indices took to their
    fixed points (the m=1 sweeps, summed)."""
    import torch
    from repro_torch.kernels.tridiag_eig import kernel

    n, s = d.shape[0], ks.shape[0]
    sms = kernel.sm_count(d.device.index)
    plan = kernel.bisect_plan(n, s, sms)
    flags = {"stop": kernel.STOP, "no stop": 0}
    times, sweeps, bad = {}, {}, []
    for m in range(1, kernel.MAX_LEVELS + 1):
        p = kernel.bisect_plan(n, s, sms, levels=m)
        if p.per_block << m > kernel.MAX_THREADS or -(-s // sms) != \
                p.per_block:
            continue
        ms = {v: [] for v in flags}
        for v in (*flags, *reversed(flags)):
            (lam, sw), t = _time_cuda(lambda: kernel.bisect_launch(
                d, e2, ks, scal, 80, m, p.per_block, flags[v]))
            ms[v].append(t)
            if not torch.equal(lam.cpu(), lam_p):
                bad.append(f"m={m} {v}")
            if v == "stop":
                sweeps[m] = sw.cpu()
        times[m] = {v: sum(t) / len(t) for v, t in ms.items()}
    threads = {m: -(-s // sms) << m for m in times}
    step_ns = {m: 1e6 * times[m]["no stop"] / (-(-80 // m) * n)
               for m in times}
    print(f"{label} bisect by levels (ms: stop / no stop; the kernel's own "
          f"step ns at threads an SM): " +
          "; ".join(f"m={m} {t['stop']:.3f} / {t['no stop']:.3f} "
                    f"({step_ns[m]:.1f} ns at {threads[m]})"
                    for m, t in times.items()), flush=True)
    checks.check(f"{label} bisect by levels bitwise", not bad,
                 f"{len(flags) * len(times)} variants against the plain "
                 f"version"
                 + (f"; differ: {', '.join(bad)}" if bad else ""))
    sw = sweeps[plan.levels].double()
    print(f"{label} bisect sweeps to the fixed point at the plan's m="
          f"{plan.levels} ({plan.per_block} indices a block, {plan.blocks} "
          f"blocks): min {int(sw.min())}, median {float(sw.median()):.0f}, "
          f"max {int(sw.max())} of {-(-80 // plan.levels)}; levels (m=1): "
          f"min {int(sweeps[1].min())}, median "
          f"{float(sweeps[1].double().median()):.0f}, max "
          f"{int(sweeps[1].max())}", flush=True)
    # m=1 without the stop at the first design's 128 threads a block: one
    # index alone (the chain floor), all s in turns with the wrapper
    first = functools.partial(kernel.bisect_launch, d, e2,
                              scal=scal, max_iters=80, levels=1,
                              per_block=64, flags=0)
    one = _time_cuda(lambda: first(ks=ks[:1]))[1]
    one_ns = 1e6 * one / (80 * n)
    calls = {"wrapper": lambda: kernel.bisect_sturm(d, e2, ks, scal),
             "m=1": lambda: first(ks=ks)}
    turns = {v: [] for v in calls}
    for v in (*calls, *reversed(calls)):
        turns[v].append(_time_cuda(calls[v])[1])
    t = {v: sum(x) / 2 for v, x in turns.items()}
    floor = int(sw.max()) * n * one_ns / 1e6
    own = int(sw.max()) * n * step_ns[plan.levels] / 1e6
    print(f"{label} bisect chain floors: one lane at m=1 {one:.3f} ms "
          f"({80 * n} dependent steps, {one_ns:.2f} ns a step); the plan's "
          f"{int(sw.max())} sweeps x {n} steps x {one_ns:.2f} ns = "
          f"{floor:.3f} ms (at the kernel's own step at "
          f"{threads[plan.levels]} threads an SM, {step_ns[plan.levels]:.1f} "
          f"ns: {own:.3f} ms) against its {times[plan.levels]['stop']:.3f} "
          f"ms; in turns: the wrapper {t['wrapper']:.3f} ms (earlier "
          f"{wrapper_ms:.3f}), m=1 without the stop, 128 threads a block, "
          f"{t['m=1']:.3f} ms", flush=True)
    checks.check(f"{label} bisect_sturm at most a quarter of m=1",
                 t["wrapper"] <= 0.25 * t["m=1"],
                 f"{t['wrapper']:.3f} against {t['m=1']:.3f} ms, in turns")
    return int(sweeps[1].sum())


def td2_chain_floors(label: str, d, e, lam, piv, X0) -> None:
    """The dependent-chain floor of the ``invit`` solve: every lane runs its
    own chain (2n dependent steps), so one shift alone takes the least time
    the chain allows; one solve launch at one shift beside all s, through
    the C entry point (no launch counted). The bisection's is in
    ``bisect_levels``."""
    import torch
    from repro_torch.device import current_stream
    from repro_torch.kernels.tridiag_eig import kernel

    n, s = X0.shape
    lib = kernel._lib()
    W = torch.empty((n, s, 4), dtype=torch.float64, device=d.device)

    def solve(k):
        Z = X0[:, :k].contiguous()
        err = lib.tridiag_invit_solve(d.data_ptr(), e.data_ptr(),
                                      lam.data_ptr(), piv.data_ptr(),
                                      Z.data_ptr(), W.data_ptr(), n, k,
                                      current_stream(d.device))
        if err != 0:
            raise RuntimeError(f"tridiag_invit_solve: cudaError {err}")

    solve(s)
    sol = {k: _time_cuda(lambda: solve(k))[1] for k in (1, s)}
    print(f"{label} chain floors (one lane against all {s}): invit solve "
          f"launch {sol[1]:.3f} against {sol[s]:.3f} ms ({2 * n} dependent "
          f"steps, {1e6 * sol[1] / (2 * n):.2f} ns a step)", flush=True)


def gamma_bound(A_h, X_h):
    """gamma_n (|sym(triu A)| |X|) on the host, gamma_n = n u / (1 - n u):
    componentwise, it bounds the error of any order of summation."""
    import torch
    n = A_h.shape[0]
    u = torch.finfo(torch.float64).eps / 2
    absA = torch.triu(A_h.abs())
    absA += torch.triu(A_h.abs(), 1).mT
    return (n * u / (1 - n * u)) * (absA @ X_h.abs())


def compare_product(label: str, A, checks: Checks, seed: int) -> dict:
    """``symm_block`` at p=1 and p=4 and ``symv`` on A against their plain
    versions (CPU copies), componentwise within gamma_n (|sym(triu A)| |X|)
    — a bound on the error of any order of summation — and two runs of
    each checked bitwise equal. Returns one row per case (error, times,
    bound, ``torch.matmul`` time)."""
    import torch
    from repro_torch.kernels.symv import kernel, ref

    n = A.shape[0]
    A_h = A.cpu()
    gen = torch.Generator(device=A.device).manual_seed(seed)
    rows = {}
    for name, p in (("symm_block", 1), ("symm_block", 4), ("symv", 1)):
        if name == "symv":
            X = torch.randn((n,), generator=gen, dtype=torch.float64,
                            device=A.device)
            run = lambda: kernel.symv(A, X)                   # noqa: E731
            plain = lambda: ref.symv_upper_ref(A_h, X_h)      # noqa: E731
        else:
            X = torch.randn((n, p), generator=gen, dtype=torch.float64,
                            device=A.device)
            run = lambda: kernel.symm_block(A, X)             # noqa: E731
            plain = lambda: ref.symm_block_upper_ref(A_h, X_h)  # noqa: E731
        X_h = X.cpu()
        run()                                                 # warm-up
        Y_k, k1 = _time_cuda(run, TIMING_REPS)
        Y_p, p1 = _time_host(plain)
        _, k2 = _time_cuda(run, TIMING_REPS)
        torch.matmul(A, X)
        _, l1 = _time_cuda(lambda: torch.matmul(A, X), TIMING_REPS)
        _, l2 = _time_cuda(lambda: torch.matmul(A, X), TIMING_REPS)
        diff = (Y_k.cpu() - Y_p).abs()
        bound = gamma_bound(A_h, X_h)
        ratio = float(torch.max(diff / bound))
        key = f"{name} p={p}" if name == "symm_block" else name
        # the upper triangle once, X once, Y once; 2 n^2 p flops
        nbytes = 8 * (n * (n + 1) / 2 + 2 * n * p)
        ms = (k1 + k2) / 2
        print(f"{label} {key}: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.1f} ms (plain on the host CPU), "
              f"torch.matmul {l1:.4f} / {l2:.4f} ms; kernel "
              f"{nbytes / ms / 1e9:.3f} TB/s on the triangle, bound "
              f"{HBM_BYTES_PER_S / 1e12:.2f}; least time "
              f"{_bound(2.0 * n * n * p, nbytes)['bound_ms']:.4f} ms",
              flush=True)
        checks.check(f"{label} {key} within gamma_n of plain",
                     bool(torch.all(diff <= bound)),
                     f"max |kernel - plain| / (gamma_n |A||X|) = {ratio!r}, "
                     f"max |kernel - plain| = {float(diff.max())!r}")
        again = run()
        checks.check(f"{label} {key} repeats bitwise",
                     bool(torch.equal(again, Y_k)),
                     f"max |run 1 - run 2| = "
                     f"{float((again - Y_k).abs().max())!r}")
        rows[key] = dict(
            max_abs_err=float(diff.max()), ms=ms,
            plain_ms=p1, library_ms=(l1 + l2) / 2,
            **_bound(2.0 * n * n * p, nbytes))
    return rows


def _symm_block_at_width(A, X, kc: int):
    """``symm_block`` through symv.cu's instance for kc (1, 2 or 4) columns
    of X a pass, whatever p is: the C entry point called directly, so no
    launch is counted and the wrapper keeps the plan's width."""
    import torch
    from repro_torch.device import current_stream
    from repro_torch.kernels.symv import kernel

    n, p = X.shape
    Y = torch.empty((n, p), dtype=torch.float64, device=A.device)
    P = torch.empty(kernel.plan(n, p).scratch, dtype=torch.float64,
                    device=A.device)
    err = kernel._lib().symm_block_upper(
        A.data_ptr(), A.stride(0), X.data_ptr(), X.stride(0), P.data_ptr(),
        Y.data_ptr(), n, p, kc, current_stream(A.device))
    if err != 0:
        raise RuntimeError(f"symm_block_upper at kc={kc}: cudaError {err}")
    return Y


def product_variants(label: str, A, seed: int) -> None:
    """``symm_block`` at p=1 under each compiled width of X a pass (kc;
    the plan takes 1), timed in turns; the wrapper's host time a call,
    without the device; the card's read rate on A (``torch.sum``, a
    yardstick of what a read can reach); and one call's device time by
    kernel (the tile pass and the slot sum) under ``torch.profiler``."""
    import torch
    from repro_torch.kernels.symv import kernel

    n = A.shape[0]
    X = torch.randn((n, 1), dtype=torch.float64, device=A.device,
                    generator=torch.Generator(device=A.device).manual_seed(
                        seed))
    times = {kc: [] for kc in (1, 2, 4)}
    for _ in range(2):
        for kc in times:
            _symm_block_at_width(A, X, kc)
            _, ms = _time_cuda(lambda: _symm_block_at_width(A, X, kc),
                               TIMING_REPS)
            times[kc].append(ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        kernel.symm_block(A, X)
    host = 1e3 * (time.perf_counter() - t0) / TIMING_REPS
    torch.cuda.synchronize()
    # the card's read rate on these bytes: one reduction over all of A
    A.sum()
    _, sum_ms = _time_cuda(lambda: A.sum(), TIMING_REPS)
    print(f"{label} symm_block p=1 by width a pass (ms, in turns; the plan "
          f"takes kc={kernel.plan(n, 1).kc}): " + ", ".join(
              f"kc={k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items())
          + f"; wrapper host time {host:.4f} ms a call; torch.sum over all "
          f"of A {sum_ms:.4f} ms, {8 * n * n / sum_ms / 1e9:.3f} TB/s",
          flush=True)
    profile_stage(f"{label} symm_block p=1", lambda: kernel.symm_block(A, X))


def product_accuracy(label: str, A, seed: int) -> None:
    """The rounding error of ``symm_block`` (p=4, and p=1 a column at a
    time) and of ``torch.matmul`` on sym(triu A), against a reference in
    extended precision (numpy ``longdouble`` on the host), for four
    orthonormal columns: max and rms of |Y - Y_ref| / (|A| |X|). The
    Lanczos restart counts at tol=0 read this rounding."""
    import numpy as np
    import torch
    from repro_torch.kernels.symv import kernel

    n = A.shape[0]
    X = torch.randn((n, 4), dtype=torch.float64, device=A.device,
                    generator=torch.Generator(device=A.device).manual_seed(
                        seed))
    Q, _ = torch.linalg.qr(X)
    S = torch.triu(A)
    S += torch.triu(A, 1).mT
    outs = {"symm_block p=4": kernel.symm_block(A, Q),
            "symm_block p=1": torch.cat([kernel.symm_block(A, Q[:, k:k + 1])
                                         for k in range(4)], 1),
            "torch.matmul": S @ Q}
    S_h = S.cpu().numpy().astype(np.longdouble)
    del S
    Q_h = Q.cpu().numpy().astype(np.longdouble)
    ref = S_h @ Q_h
    scale = np.abs(S_h) @ np.abs(Q_h)
    del S_h
    parts = []
    for name, Y in outs.items():
        rel = np.abs(Y.cpu().numpy().astype(np.longdouble) - ref) / scale
        parts.append(f"{name} max {float(rel.max()):.3e}, rms "
                     f"{float(np.sqrt((rel ** 2).mean())):.3e}")
    print(f"{label} product error / (|A||X|) against longdouble, 4 "
          f"orthonormal columns: " + "; ".join(parts), flush=True)


def _wide_matrix(n: int, seed: int, device):
    """A random symmetric upper triangle with 1e6-scale garbage strictly
    below it, built on the card."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((n, n), generator=gen, dtype=torch.float64, device=device)
    G = torch.randn((n, n), generator=gen, dtype=torch.float64, device=device)
    A.triu_()
    A += G.tril_(-1).mul_(1e6)
    return A


def _house_run(E, row_start: int, plan, mode: int):
    """One launch of ``house_panel``'s kernel on ``plan``'s path in
    ``mode`` (no launch counted); returns (V, T)."""
    import torch
    from repro_torch.kernels.house_panel import kernel
    rows, b = E.shape
    V = torch.empty((rows, b), dtype=E.dtype, device=E.device)
    T = torch.empty((b, b), dtype=E.dtype, device=E.device)
    kernel.house_launch(E, row_start, V, T, plan, mode)
    return V, T


def compare_house_panel(label: str, E, row_start: int, checks: Checks,
                        by_part: bool = False):
    """``house_panel`` on the panel E[row_start:, :] through the wrapper
    (its plan's path, the cluster where the rows fit) and the cooperative
    kernel forced, against its plain version (CPU copy): V and T
    entrywise, I - V T V^T orthogonal, bitwise on repeat; wrapper,
    cooperative kernel and plain in turns. With ``by_part``: the
    wrapper's host enqueue a call, each path's device time
    (``torch.profiler``), the timing variants of the plan's path and the
    cooperative kernel in turns (barriers alone, no cross-CTA sums; the
    cooperative kernel also with no barrier), and ``torch.geqrf`` on the
    same active rows (V and tau, no T: the closest one call). Returns the
    wrapper's row and its checked (V, T)."""
    import torch
    from repro_torch.kernels.house_panel import kernel, ref

    rows, b = E.shape
    E_h = E.cpu()
    plan = kernel.house_plan(max(rows - row_start, 0), b,
                             kernel.cluster_capacity)
    run = {"wrapper": lambda: kernel.house_panel(E, row_start),
           "cooperative": lambda: _house_run(E, row_start,
                                             kernel.COOPERATIVE, kernel.FULL)}
    for fn in run.values():
        fn()                                          # warm-up
    out, ms = {}, {k: [] for k in run}
    (Vp, Tp), p1 = _time_host(lambda: ref.house_panel_ref(E_h, row_start))
    for _ in range(2):
        for k, fn in run.items():
            o, t = _time_cuda(fn, TIMING_REPS)
            out.setdefault(k, []).append(o)
            ms[k].append(t)
    eye = torch.eye(rows, dtype=torch.float64, device=E.device)
    err = 0.0
    for k, ((V, T), (V2, T2)) in out.items():
        e = max(float((V.cpu() - Vp).abs().max()),
                float((T.cpu() - Tp).abs().max()))
        Q = eye.clone()
        Q.addmm_(V @ T, V.mT, alpha=-1.0)
        orth = float((Q.mT @ Q - eye).abs().max())
        del Q
        where = f"{label} house_panel, {k} path"
        checks.check(f"{where} V, T vs plain", e <= HOUSE_TOL,
                     f"max |kernel - plain| = {e!r} (bar {HOUSE_TOL}, "
                     f"|v| <= 1)")
        checks.check(f"{where} Q orthogonal", orth <= HOUSE_ORTH * rows,
                     f"max |Q^T Q - I| = {orth!r} (bar {HOUSE_ORTH} * "
                     f"{rows})")
        checks.check(f"{where} repeats bitwise",
                     bool(torch.equal(V, V2) and torch.equal(T, T2)),
                     f"max |run 1 - run 2| = {float((V - V2).abs().max())!r}")
        if k == "wrapper":
            err = e
    checked = out["wrapper"][0]
    del eye, out
    print(f"{label} house_panel ({rows} x {b}, row_start {row_start}): "
          f"wrapper, plan {plan.path} ({plan.csize} CTAs of {plan.rpc} "
          f"rows, {plan.smem} bytes) {ms['wrapper'][0]:.4f} / "
          f"{ms['wrapper'][1]:.4f} ms, cooperative {ms['cooperative'][0]:.4f}"
          f" / {ms['cooperative'][1]:.4f} ms a call ({TIMING_REPS} in a "
          f"window), plain {p1:.1f} ms (plain on the host CPU)", flush=True)
    library = None
    if by_part:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMING_REPS):
            run["wrapper"]()
        host = 1e3 * (time.perf_counter() - t0) / TIMING_REPS
        torch.cuda.synchronize()
        parts = {f"{k} device (torch.profiler)": _device_ms(fn)
                 for k, fn in run.items()}
        paths = {"plan": plan, "cooperative": kernel.COOPERATIVE}
        variants = [(k, name, mode) for k in paths
                    for name, mode in (("barriers only", kernel.BARRIER_ONLY),
                                       ("no barrier", kernel.NO_BARRIER),
                                       ("no cross-CTA sums", kernel.NO_SUMS))
                    if not (k == "plan" and plan.path == "cluster"
                            and mode == kernel.NO_BARRIER)]
        times = {}
        for _ in range(2):
            for k, name, mode in variants:
                _, t = _time_cuda(lambda: _house_run(E, row_start, paths[k],
                                                     mode), TIMING_REPS)
                times.setdefault(f"{k} {name}", []).append(t)
        # geqrf on the active rows: V and tau of the same reflectors
        A = E[row_start:].clone()
        geqrf = lambda: torch.geqrf(A)  # noqa: E731
        geqrf()
        g = [_time_cuda(geqrf, TIMING_REPS)[1] for _ in range(2)]
        library = sum(g) / 2
        print(f"{label} house_panel by part (ms a launch, in turns): wrapper "
              f"host enqueue a call {host:.4f}; " + "; ".join(
                  f"{k} {_ms(v)}" for k, v in parts.items()) + "; " +
              "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                        for k, v in times.items()) +
              f"; torch.geqrf of the {rows - row_start} x {b} active rows "
              f"{g[0]:.4f} / {g[1]:.4f} (V and tau, no T)", flush=True)
    # E in, V and T out; ~4 rows b^2 flops over the b reflectors
    return dict(max_abs_err=err, ms=sum(ms["wrapper"]) / 2, plain_ms=p1,
                library_ms=library,
                **_bound(4.0 * rows * b * b, 8 * (2 * rows * b + b * b))), \
        checked


def compare_syr2k(label: str, C, V, W, checks: Checks) -> dict:
    """``syr2k`` (alpha = -1) against its plain version on CPU copies,
    componentwise within gamma_{2k+1} (|C| + |V||W|^T + |W||V|^T), beside
    ``torch.addmm`` of the concatenated panels; then the symmetrized launch
    of the TT1 sweep against (R + R^T)/2 of the kernel's own R, bitwise."""
    import torch
    from repro_torch.kernels.syr2k import kernel, ref

    n, k = V.shape
    C_h, V_h, W_h = C.cpu(), V.cpu(), W.cpu()
    out = torch.empty_like(C)
    run = lambda: kernel.syr2k(C, V, W, alpha=-1.0, out=out)  # noqa: E731
    run()                                             # warm-up
    R, k1 = _time_cuda(run, TIMING_REPS)
    R_p, p1 = _time_host(lambda: ref.syr2k_ref(C_h, V_h, W_h, -1.0))
    _, k2 = _time_cuda(run, TIMING_REPS)
    _, p2 = _time_host(lambda: ref.syr2k_ref(C_h, V_h, W_h, -1.0))
    VW, WV = torch.cat([V, W], 1), torch.cat([W, V], 1).mT
    lib = lambda: torch.addmm(C, VW, WV, alpha=-1.0)  # noqa: E731
    lib()
    _, l1 = _time_cuda(lib, TIMING_REPS)
    _, l2 = _time_cuda(lib, TIMING_REPS)
    m = 2 * k + 1
    u = torch.finfo(torch.float64).eps / 2
    diff = (R.cpu() - R_p).abs()
    del R_p
    Va, Wa = V_h.abs(), W_h.abs()
    bound = (m * u / (1 - m * u)) * (C_h.abs() + Va @ Wa.mT + Wa @ Va.mT)
    ratio = float((diff / bound).max())
    ok = bool(torch.all(diff <= bound))
    err = float(diff.max())
    del diff, bound
    print(f"{label} syr2k (n={n}, k={k}): kernel {k1:.4f} / {k2:.4f} ms, "
          f"plain {p1:.1f} / {p2:.1f} ms (plain on the host CPU), "
          f"torch.addmm {l1:.4f} / {l2:.4f} ms", flush=True)
    checks.check(f"{label} syr2k within gamma_(2k+1) of plain", ok,
                 f"max |kernel - plain| / bound = {ratio!r}, "
                 f"max |kernel - plain| = {err!r}")
    S = kernel.syr2k(C, V, W, alpha=-1.0, symmetrize=True)
    checks.check(f"{label} syr2k symmetrized = (R + R^T)/2 bitwise",
                 bool(torch.equal(S, 0.5 * (R + R.mT))),
                 f"max gap {float((S - 0.5 * (R + R.mT)).abs().max())!r}")
    del S, out
    # C read once, out written once, the panels once; 4 k n^2 flops
    return dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(l1 + l2) / 2,
                **_bound(4.0 * k * n * n, 8 * (2.0 * n * n + 2 * n * k)))


def _device_ms(fn, calls: int = TIMING_REPS):
    """Device time a call: the kernels' time under ``torch.profiler``
    (CUPTI) over ``calls`` back-to-back calls, summed, over the calls;
    None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler here at times records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(ev, "device_time_total", 0.0)
                    for ev in prof.key_averages())
        if total:
            return total / 1e3 / calls
    return None


def _queued_ms(fn, calls: int = TIMING_REPS) -> float:
    """Device time a call with the launches queued back to back: the stream
    held by a spin kernel while the host enqueues ``calls`` calls, CUDA
    events around them (each launch's own gap on the card included, the
    host's excluded)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)           # ~3 ms, longer than the enqueue
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f} ms"


def compare_rot_apply(checks: Checks, dev) -> dict:
    """``rot_apply`` bitwise against its plain version at the wavefront
    shapes of the MD chase (b=16 and b=2 lanes) and at a replay shape;
    kernel and the batched ``torch.matmul`` timed per call (CUDA events
    over back-to-back calls: the host's cost a call where it exceeds the
    device's) and as device time (``torch.profiler``)."""
    import torch
    from repro_torch.kernels.rot_apply import kernel, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    row = None
    for G, L in ((1000, 8), (209, 36), (625, 100)):
        pairs = torch.randn((G, 2, L), generator=gen, dtype=torch.float64,
                            device=dev)
        cs = torch.randn((G, 2), generator=gen, dtype=torch.float64,
                         device=dev)
        p_h, cs_h = pairs.cpu(), cs.cpu()
        # the library call of the same function: the (G, 2, 2) rotations
        # [[c, s], [-s, c]] times the (G, 2, L) pairs, one batched GEMM
        c, s = cs[:, 0], cs[:, 1]
        R = torch.stack([torch.stack([c, s], 1), torch.stack([-s, c], 1)], 1)
        run = lambda: kernel.rot_apply(pairs, cs)             # noqa: E731
        plain = lambda: ref.rot_apply_ref(p_h, cs_h)          # noqa: E731
        lib = lambda: torch.matmul(R, pairs)                  # noqa: E731
        run()                                         # warm-up
        lib()
        y, k1 = _time_cuda(run, TIMING_REPS)
        y_p, p1 = _time_host(plain)
        y_l, l1 = _time_cuda(lib, TIMING_REPS)
        _, k2 = _time_cuda(run, TIMING_REPS)
        _, p2 = _time_host(plain)
        _, l2 = _time_cuda(lib, TIMING_REPS)
        kd, ld = _device_ms(run), _device_ms(lib)
        err = float((y.cpu() - y_p).abs().max())
        print(f"rot_apply (G={G}, L={L}): kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.3f} / {p2:.3f} ms (plain on the host CPU), "
              f"torch.matmul {l1:.4f} / {l2:.4f} ms (max |matmul - kernel| "
              f"= {float((y_l - y).abs().max())!r})", flush=True)
        print(f"rot_apply (G={G}, L={L}) device time (torch.profiler, "
              f"{TIMING_REPS} calls): kernel {_ms(kd)}, torch.matmul "
              f"{_ms(ld)}; per call (CUDA events): kernel "
              f"{(k1 + k2) / 2:.5f} ms, torch.matmul {(l1 + l2) / 2:.5f} ms",
              flush=True)
        checks.check(f"rot_apply G={G} L={L} bitwise vs plain",
                     bool(torch.equal(y.cpu(), y_p)),
                     f"max |kernel - plain| = {err!r}")
        if row is None:   # the b=16 wavefront of the MD chase
            row = dict(max_abs_err=err, ms=(k1 + k2) / 2,
                       plain_ms=(p1 + p2) / 2, library_ms=(l1 + l2) / 2,
                       **_bound(6.0 * G * L, 8 * (4.0 * G * L + 2 * G)))
    return row


def _chase_work(n: int, b: int):
    """(rotations, table slots) of the bandwidth-b pass at n."""
    from repro_torch.kernels.rot_apply.schedule import pass_schedule
    _, _, _, J, K0 = pass_schedule(n, b)
    rots = sum((n - 1 - j - b) // b + 1 for j in range(n - b))
    return rots, (J + 1) * (K0 + 1)


def _chase_bound(n: int, w: int, bs, esize: int = 8,
                 peak: float = FP64_VECTOR_FLOPS) -> dict:
    """Bound of the chase passes ``bs``: per rotation the Givens (~6
    flops) and 2b+3 pair rotations of 6 flops; the padded band read and
    written once per pass, the tables written once (``esize`` bytes an
    entry, operations at ``peak``)."""
    from repro_torch.kernels.rot_apply.schedule import P_LEFT
    npad = P_LEFT + n + 3 * w + 8
    ops = nbytes = 0.0
    for b in bs:
        rots, cells = _chase_work(n, b)
        ops += rots * (6 + 6 * (2 * b + 3))
        nbytes += esize * (2.0 * (w + 2) * npad + 2.0 * cells)
    return _bound(ops, nbytes, peak)


def _replay_bound(n: int, cols: int, bs, esize: int = 8,
                  peak: float = FP64_VECTOR_FLOPS) -> dict:
    """Bound of the replay passes ``bs`` onto an (n, cols) slab: 6 flops
    per rotation and column; the tables read once, the slab read and
    written once per pass (``esize`` bytes an entry, operations at
    ``peak``)."""
    ops = nbytes = 0.0
    for b in bs:
        rots, cells = _chase_work(n, b)
        ops += 6.0 * cols * rots
        nbytes += esize * (2.0 * cells + 2.0 * n * cols)
    return _bound(ops, nbytes, peak)


def _per_launch(bound: dict, launches: int) -> dict:
    return {"bound_ms": bound["bound_ms"] / launches,
            "bound_by": bound["bound_by"]}


def compare_replay(label: str, passes, tables, n: int, plain_dev,
                   checks: Checks, dev, cols: int = 100, seed: int = 6,
                   by_part: bool = False) -> dict:
    """TT4's replay of the chase tables onto an (n, cols) slab in reverse,
    one launch per pass, through the wrapper ``replay_pass`` (its plan's
    path, the slab in shared memory where a column fits) and the sweep
    kernel forced, against the plain version on ``plain_dev`` copies
    (None: against the sweep kernel, where the plain version would take
    minutes), in turns; bitwise: the same rotations in the same order, no
    FMA. Then the wrapper pass by pass; with ``by_part``, the plan's
    timing variants over all passes in turns (no table, no barrier between
    chunks, lane 0 alone). Returns the wrapper's row, per launch."""
    import torch
    from repro_torch.kernels.rot_apply import kernel, ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    Z = torch.randn((n, cols), generator=gen, dtype=torch.float64,
                    device=dev)
    plan = kernel.replay_plan(n, cols)
    order = list(zip(reversed(passes), reversed(tables)))

    def wrapper():
        Y = Z.clone()
        for b, CS in order:
            kernel.replay_pass(Y, CS, b, n, True)
        return Y

    def replay(p, mode=kernel.REPLAY_FULL):
        def go():
            Y = Z.clone()
            for b, CS in order:
                kernel.replay_launch(Y, CS, b, n, True, p, mode)
            return Y
        return go

    def replay_p():
        Y = Z.to(plain_dev, copy=True)
        for b, CS in order:
            ref.replay_pass_ref(Y, CS.to(plain_dev), b, n, reverse=True)
        return Y

    old = replay(kernel.SWEEP)
    wrapper()                                         # warm-up
    Yk, k1 = _time_cuda(wrapper)
    Ys, s1 = _time_cuda(old)
    if plain_dev is not None:
        Yp, p1 = _time_cuda(replay_p)
    per = len(passes)
    Yk, Ys = Yk.cpu(), Ys.cpu()
    if plain_dev is None:
        Yp, p1, where = Ys, None, "not run (the sweep kernel is the yardstick)"
    else:
        Yp = Yp.cpu()
        where = "on the card" if torch.device(plain_dev).type == "cuda" \
            else "on the host CPU"
        where = f"{p1:.0f} ms ({where})"
    err = float((Yk - Yp).abs().max())
    print(f"{label} replay ({per} passes onto ({n}, {cols})): wrapper, plan "
          f"{plan.path} ({plan.ctas} CTAs, 2 table slices of {plan.stage} "
          f"bytes) {k1:.3f} ms, sweep kernel {s1:.3f} ms, plain {where}",
          flush=True)
    for name, Y in (("wrapper", Yk), ("sweep path", Ys)):
        if Y is Yp:
            continue
        checks.check(f"{label} replay {name} bitwise vs "
                     f"{'plain' if plain_dev is not None else 'sweep path'}",
                     bool(torch.equal(Y, Yp)),
                     f"max |kernel - plain| = {float((Y - Yp).abs().max())!r}")
    del Ys
    Y = Z.clone()
    each = []
    for b, CS in order:
        _, t = _time_cuda(lambda: kernel.replay_pass(Y, CS, b, n, True))
        each.append((b, t))
    print(f"{label} replay, wrapper ms per pass (b = 2..{passes[0]}): "
          + ", ".join(f"{t:.3f}" for _, t in each), flush=True)
    if by_part:
        variants = {
            "whole": replay(plan),
            "no table (a fixed rotation)": replay(plan, kernel.NO_TABLE),
            "no chunk barrier": replay(plan, kernel.REPLAY_NO_BARRIER),
            "lane 0 alone": replay(plan, kernel.ONE_LANE)}
        times = {}
        for _ in range(2):
            for k, fn in variants.items():
                times.setdefault(k, []).append(_time_cuda(fn)[1])
        chunks = sum(-(-(n - b) // (b - 1)) for b in passes)
        print(f"{label} replay by part ({per} passes, {chunks} chunks; ms, "
              f"in turns; us a chunk): " + "; ".join(
                  f"{k} {v[0]:.3f} / {v[1]:.3f} "
                  f"({1e3 * min(v) / chunks:.3f})" for k, v in times.items()),
              flush=True)
    return dict(max_abs_err=err, ms=k1 / per,
                plain_ms=None if p1 is None else p1 / per, library_ms=None,
                **_per_launch(_replay_bound(n, cols, passes), per))


def replay_widths(label: str, passes, tables, n: int, widths, checks: Checks,
                  dev, seed: int = 16) -> None:
    """``accumulate_q2``'s replay (all passes forward onto an (n, cols)
    slab) at slabs wider than the card: the wrapper (one CTA a column, in
    waves) against the sweep kernel forced, in turns, bitwise."""
    import torch
    from repro_torch.kernels.rot_apply import kernel

    for cols in widths:
        gen = torch.Generator(device=dev).manual_seed(seed)
        Z = torch.randn((n, cols), generator=gen, dtype=torch.float64,
                        device=dev)

        def wrapper():
            Y = Z.clone()
            for b, CS in zip(passes, tables):
                kernel.replay_pass(Y, CS, b, n, False)
            return Y

        def sweep():
            Y = Z.clone()
            for b, CS in zip(passes, tables):
                kernel.replay_launch(Y, CS, b, n, False, kernel.SWEEP,
                                     kernel.REPLAY_FULL)
            return Y

        Yk, k1 = _time_cuda(wrapper)
        Ys, s1 = _time_cuda(sweep)
        checks.check(f"{label} forward replay onto ({n}, {cols}), wrapper "
                     f"bitwise vs sweep path", bool(torch.equal(Yk, Ys)),
                     f"max |wrapper - sweep| = "
                     f"{float((Yk - Ys).abs().max())!r}")
        del Yk, Ys, Z
        torch.cuda.empty_cache()
        plan = kernel.replay_plan(n, cols)
        print(f"{label} forward replay ({len(passes)} passes onto ({n}, "
              f"{cols}), accumulate_q2's shape): wrapper, plan {plan.path} "
              f"({plan.ctas} CTAs) {k1:.3f} ms, sweep kernel {s1:.3f} ms",
              flush=True)


def _chase_agree(label: str, Wk, Wq, tk, tq, norm: float,
                 checks: Checks) -> float:
    """Kernel (Wk, tables tk) against plain (Wq, tq): the band within
    CHASE_TOL ||W||_2, and band and tables bitwise (the same IEEE-rounded
    operations in the same sequential order, no FMA on either side).
    Returns the band's largest gap."""
    import torch
    Wk, Wq = Wk.cpu(), Wq.cpu()
    err = float((Wk - Wq).abs().max())
    gap = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(tk, tq))
    same = torch.equal(Wk, Wq) and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(tk, tq))
    checks.check(f"{label} band vs plain", err <= CHASE_TOL * norm,
                 f"max |kernel - plain| = {err!r} (bar {CHASE_TOL} * "
                 f"||W||_2 = {CHASE_TOL * norm!r})")
    checks.check(f"{label} band and (c, s) tables bitwise vs plain", same,
                 f"largest gap: band {err!r}, tables {gap!r}")
    return err


def compare_chase(label: str, Wb, w: int, checks: Checks, dev):
    """The whole TT2 chase of the band Wb pass by pass (``chase_pass``)
    against its plain version on a CPU copy (kernel, plain, kernel), and
    through the cooperative path; then the replay of its tables
    (``compare_replay``, plain on the host CPU)."""
    import torch
    from repro_torch.core.band_storage import unpack_band
    from repro_torch.core.sbr import _executed_passes
    from repro_torch.kernels.rot_apply import kernel, ref
    from repro_torch.kernels.rot_apply.schedule import padded_band

    n = Wb.shape[1]
    passes = _executed_passes(n, w)
    W0 = padded_band(Wb, w)

    def chase_k():
        Wp = W0.clone()      # clone keeps the strides
        return Wp, [kernel.chase_pass(Wp, b, w, n) for b in passes]

    def chase_c():           # the cooperative path
        Wp = W0.clone()
        return Wp, [kernel.chase_launch(Wp, b, w, n, kernel.COOPERATIVE,
                                        kernel.FULL) for b in passes]

    def chase_p():
        Wp = W0.cpu()
        return Wp, [ref.chase_pass_ref(Wp, b, w, n) for b in passes]

    chase_k()                                         # warm-up
    (Wk, tk), k1 = _time_cuda(chase_k)
    (Wh, th), p1 = _time_host(chase_p)
    _, k2 = _time_cuda(chase_k)
    (Wc, tc), c1 = _time_cuda(chase_c)
    print(f"{label} chase ({len(passes)} passes): kernel {k1:.3f} / "
          f"{k2:.3f} ms (cooperative path {c1:.3f} ms), plain {p1:.0f} ms "
          f"(plain on the host CPU)", flush=True)
    norm = float(torch.linalg.eigvalsh(unpack_band(Wb.cpu())).abs().max())
    _chase_agree(f"{label} chase", Wk, Wh, tk, th, norm, checks)
    _chase_agree(f"{label} chase, cooperative path", Wc, Wh, tc, th, norm,
                 checks)
    compare_replay(label, passes, tk, n, "cpu", checks, dev)


def compare_chase_md(label: str, Wb, w: int, norm: float, checks: Checks,
                     dev) -> dict:
    """At the main path's shapes: the whole chase of Wb, one
    ``chase_pass`` per pass (the wrapper's path: the band in one cluster's
    distributed shared memory), with its first (widest) and last (most
    steps) pass also run by the cooperative path and by the plain version
    on the card on the same input (kernel, plain, kernel, cooperative; the
    plain chase is a host loop of one step per time step, ~47 s a pass
    here, so it runs once); then TT4's replay of all its tables onto an
    (n, 100) slab, plain on the card. ``norm`` is ||W||_2. Returns the
    ``chase_pass`` row (the two compared passes, per launch) and the
    ``replay_pass`` row (all passes, per launch)."""
    from repro_torch.core.sbr import _executed_passes
    from repro_torch.kernels.rot_apply import kernel, ref
    from repro_torch.kernels.rot_apply.schedule import (chase_stagger,
                                                        padded_band,
                                                        pass_schedule)

    n = Wb.shape[1]
    passes = _executed_passes(n, w)
    compared = (passes[0], passes[-1])
    Wp = padded_band(Wb, w)
    tables, k_ms, errs, k_cmp, p_cmp = [], [], [], [], []
    for b in passes:
        if b not in compared:
            CS, ms = _time_cuda(lambda: kernel.chase_pass(Wp, b, w, n))
            tables.append(CS)
            k_ms.append(ms)
            continue
        Wk1, Wk2, Wq1, Wc = (Wp.clone() for _ in range(4))
        CS, k1 = _time_cuda(lambda: kernel.chase_pass(Wk1, b, w, n))
        CSq, p1 = _time_cuda(lambda: ref.chase_pass_ref(Wq1, b, w, n))
        _, k2 = _time_cuda(lambda: kernel.chase_pass(Wk2, b, w, n))
        CSc, c1 = _time_cuda(lambda: kernel.chase_launch(
            Wc, b, w, n, kernel.COOPERATIVE, kernel.FULL))
        plan = kernel.chase_plan(Wp.shape[1], w, b, kernel.cluster_capacity)
        print(f"{label} chase pass b={b}: kernel {k1:.3f} / {k2:.3f} ms "
              f"({plan.path}, {plan.csize} CTAs of {plan.smem} bytes), "
              f"cooperative path {c1:.3f} ms, plain {p1:.0f} ms (plain on "
              f"the card)", flush=True)
        errs.append(_chase_agree(f"{label} chase pass b={b}", Wk1, Wq1,
                                 [CS], [CSq], norm, checks))
        _chase_agree(f"{label} chase pass b={b}, cooperative path", Wc, Wq1,
                     [CSc], [CSq], norm, checks)
        del Wk2, Wq1, Wc, CSq, CSc
        Wp = Wk1
        tables.append(CS)
        k_ms.append(k1)
        k_cmp.append((k1 + k2) / 2)
        p_cmp.append(p1)
    steps = [pass_schedule(n, b, chase_stagger(b))[1] for b in passes]
    print(f"{label} chase, kernel ms per pass (b = {passes[0]}..."
          f"{passes[-1]}): {', '.join(f'{t:.2f}' for t in k_ms)}; total "
          f"{sum(k_ms):.1f} ms over {sum(steps)} steps, "
          f"{1e3 * sum(k_ms) / sum(steps):.3f} us a step", flush=True)
    chase_variants(label, Wb, w)
    per = len(compared)
    replay = compare_replay(label, passes, tables, n, dev, checks, dev,
                            by_part=True)
    # off the main path: Q2 accumulated onto an n-column slab, and slabs of
    # 4 and 8 waves of the card's 132 SMs
    replay_widths(label, passes, tables, n, (528, 1056, n), checks, dev)
    return {"chase_pass": dict(
                max_abs_err=max(errs), ms=sum(k_cmp) / per,
                plain_ms=sum(p_cmp) / per, library_ms=None,
                **_per_launch(_chase_bound(n, w, compared), per)),
            "replay_pass": replay}


def chase_variants(label: str, Wb, w: int) -> None:
    """The parts of a chase step, timed apart on the first and last pass,
    in turns, through the kernel's timing variants (called directly: no
    launch counted; results discarded): the cluster path (the plan's size,
    and 8 CTAs where the band fits) and the cooperative path, each whole,
    with its barriers alone, and without them; the cluster path also with
    its accesses to the previous CTA's columns kept local, with a fixed
    rotation in place of the Givens arithmetic, and without the block
    barrier between its phases. us a step = time / steps."""
    from repro_torch.core.sbr import _executed_passes
    from repro_torch.kernels.rot_apply import kernel
    from repro_torch.kernels.rot_apply.schedule import (chase_stagger,
                                                        padded_band,
                                                        pass_schedule)

    n = Wb.shape[1]
    passes = _executed_passes(n, w)
    W0 = padded_band(Wb, w)
    npad = W0.shape[1]
    modes = (("whole", kernel.FULL), ("barriers only", kernel.BARRIER_ONLY),
             ("no barrier", kernel.NO_BARRIER),
             ("no remote access", kernel.LOCAL_ONLY),
             ("no Givens arithmetic", kernel.NO_GIVENS),
             ("no block barrier", kernel.NO_BLOCK_SYNC))
    cluster_only = (kernel.LOCAL_ONLY, kernel.NO_GIVENS, kernel.NO_BLOCK_SYNC)
    for b in (passes[0], passes[-1]):
        steps = pass_schedule(n, b, chase_stagger(b))[1]
        plans = {"cluster": kernel.chase_plan(npad, w, b,
                                              kernel.cluster_capacity),
                 "cooperative": kernel.COOPERATIVE}
        cpc8, smem8 = kernel.cluster_share(npad, w, b, 8)
        if smem8 <= kernel.SMEM_MAX and kernel.cluster_capacity(8, smem8) > 0:
            plans["cluster of 8"] = kernel.ChasePlan("cluster", 8, cpc8, smem8)
        times = {}
        for _ in range(2):
            for path, plan in plans.items():
                for mname, mode in modes:
                    if (path == "cluster of 8" and mode != kernel.FULL) or (
                            path == "cooperative" and mode in cluster_only):
                        continue
                    Wp = W0.clone()
                    _, ms = _time_cuda(lambda: kernel.chase_launch(
                        Wp, b, w, n, plan, mode))
                    times.setdefault(f"{path} {mname}", []).append(ms)
        print(f"{label} chase pass b={b} by part ({steps} steps; ms, in "
              f"turns; us a step): " + "; ".join(
                  f"{k} {v[0]:.3f} / {v[1]:.3f} "
                  f"({1e3 * min(v) / steps:.3f})" for k, v in times.items()),
              flush=True)


def _gamma(k: int) -> float:
    import torch
    u = torch.finfo(torch.float64).eps / 2
    return k * u / (1 - k * u)


def compare_gemm(label: str, A, B, checks: Checks, reps: int) -> dict:
    """``gemm`` (A B) against its plain version on the card, which is also
    the library call (``torch.matmul``), in turns; componentwise within
    gamma_k |A||B|, the bound each result meets against the exact
    product. ``reps`` launches per timed window."""
    import torch
    from repro_torch.kernels.gemm import kernel, ref

    m, k = A.shape
    n = B.shape[1]
    run = lambda: kernel.gemm(A, B)                     # noqa: E731
    plain = lambda: ref.gemm_ref(A, B)                  # noqa: E731
    run()                                               # warm-up
    plain()
    Y, k1 = _time_cuda(run, reps)
    Yp, p1 = _time_cuda(plain, reps)
    _, k2 = _time_cuda(run, reps)
    _, p2 = _time_cuda(plain, reps)
    diff = (Y - Yp).abs_()
    del Y, Yp
    bound = (A.abs() @ B.abs()).mul_(_gamma(k))
    ok = bool(torch.all(diff <= bound))
    ratio = float((diff / bound).max())
    err = float(diff.max())
    del diff, bound
    print(f"{label} gemm ({m}, {k}) x ({k}, {n}): kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain = torch.matmul {p1:.3f} / {p2:.3f} ms (on the "
          f"card), kernel {2e-9 * m * n * k / ((k1 + k2) / 2):.2f} TFLOP/s",
          flush=True)
    checks.check(f"{label} gemm within gamma_k of plain", ok,
                 f"max |kernel - plain| / (gamma_k |A||B|) = {ratio!r}, "
                 f"max |kernel - plain| = {err!r}")
    return dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(p1 + p2) / 2,
                **_bound(2.0 * m * n * k, 8.0 * (m * k + k * n + m * n),
                         FP64_TENSOR_FLOPS))


def _trsm_backward_error(U, X, B, trans: bool) -> float:
    """||op(U) X - B||_F / (||U||_F ||X||_F), op(U) = U^T with ``trans``."""
    import torch
    R = (U.mT if trans else U) @ X
    R -= B
    return float(torch.linalg.matrix_norm(R)
                 / (torch.linalg.matrix_norm(U) * torch.linalg.matrix_norm(X)))


def compare_trsm(label: str, U, B, trans: bool, checks: Checks) -> dict:
    """The blocked ``trsm`` (one ``trsm_tile`` launch per block row, one
    ``gemm`` per update and its split-K reduce where the planner splits)
    against the plain composite on the card (the same
    schedule on ``trsm_tile_ref`` and the plain product), in turns, beside
    ``torch.linalg.solve_triangular``; checks the launches of one call, the
    two within TRSM_REL, and the backward error within n eps."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.trsm import ops, ref

    n, s = B.shape
    eps = torch.finfo(torch.float64).eps
    kernels.reset_launches()
    ops.trsm(U, B, trans=trans)
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    # a tile a block row; a product an update, two where its K is split
    want = ops.launches(n, s, trans, TRSM_BLOCK)
    checks.check(f"{label} trsm launches per call",
                 {k: got[k] for k in want} == want,
                 f"{json.dumps({k: got[k] for k in want})} (expected "
                 f"{json.dumps(want)})")
    run = lambda: ops.trsm(U, B, trans=trans)                     # noqa: E731
    plain = lambda: ref.trsm_blocked_ref(U, B, trans=trans)       # noqa: E731
    Ul = U.mT if trans else U
    lib = lambda: torch.linalg.solve_triangular(                  # noqa: E731
        Ul, B, upper=not trans)
    plain()                                                       # warm-up
    lib()
    X, k1 = _time_cuda(run)
    Xp, p1 = _time_cuda(plain)
    _, l1 = _time_cuda(lib)
    _, k2 = _time_cuda(run)
    _, p2 = _time_cuda(plain)
    _, l2 = _time_cuda(lib)
    err = float((X - Xp).abs().max())
    rel = err / float(Xp.abs().max())
    del Xp
    be = _trsm_backward_error(U, X, B, trans)
    del X
    print(f"{label} trsm ({'U^T' if trans else 'U'} X = B, B ({n}, {s}), "
          f"block {TRSM_BLOCK}): kernels {k1:.3f} / {k2:.3f} ms, plain "
          f"composite {p1:.1f} / {p2:.1f} ms (on the card), "
          f"torch.linalg.solve_triangular {l1:.3f} / {l2:.3f} ms", flush=True)
    checks.check(f"{label} trsm vs plain composite", rel <= TRSM_REL,
                 f"max |kernel - plain| / max|plain| = {rel!r} (bar "
                 f"{TRSM_REL})")
    checks.check(f"{label} trsm backward error", be <= n * eps,
                 f"||op(U) X - B||_F / (||U||_F ||X||_F) = {be!r} (bar n eps "
                 f"= {n * eps!r})")
    # U's triangle, B and X once; n^2 s flops (n^2/2 multiply-adds a column)
    return dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(l1 + l2) / 2, launches=got["trsm_tile"],
                **_bound(float(n) * n * s, 8.0 * (n * (n + 1) / 2 + 2 * n * s),
                         FP64_TENSOR_FLOPS))


def compare_update(label: str, A, B, C, alpha: float, checks: Checks) -> dict:
    """One stage-shaped product ``C += alpha A B`` in place on the view C
    (A read in place, transposed or not), against the plain version on a
    copy, componentwise within gamma_(k+1) (|C| + |alpha| |A||B|); the
    kernel and the library call (``addmm_`` in place on a copy of C) timed
    in turns on scratch copies."""
    import torch
    from repro_torch.kernels.gemm import kernel, ref

    m, k = A.shape
    n = B.shape[1]
    p = kernel.plan(m, n, k)
    C0 = C.clone()
    want = ref.gemm_accum_ref(C0, A, B, alpha)
    kernel.gemm(A, B, out=C, alpha=alpha, accumulate=True)
    bound = (A.abs() @ B.abs()).mul_(abs(alpha)).add_(C0.abs())
    bound.mul_(_gamma(k + 1))
    diff = (C - want).abs_()
    ok = bool(torch.all(diff <= bound))
    ratio, err = float((diff / bound).max()), float(diff.max())
    del diff, bound, want
    Ck, Cl = C0.clone(), C0.clone()
    run = lambda: kernel.gemm(A, B, out=Ck, alpha=alpha,       # noqa: E731
                              accumulate=True)
    lib = lambda: Cl.addmm_(A, B, alpha=alpha)                 # noqa: E731
    run()
    lib()
    _, k1 = _time_cuda(run, TIMING_REPS)
    _, l1 = _time_cuda(lib, TIMING_REPS)
    _, k2 = _time_cuda(run, TIMING_REPS)
    _, l2 = _time_cuda(lib, TIMING_REPS)
    del Ck, Cl, C0
    tr = ", A transposed" if kernel.layout(A)[0] else ""
    print(f"{label} update ({m} x {n}, K={k}{tr}; "
          f"plan {p.tile}x{p.tile}, {p.splits} split(s), {p.launches} "
          f"launch(es)): kernel {k1:.4f} / {k2:.4f} ms, torch addmm_ "
          f"{l1:.4f} / {l2:.4f} ms, kernel "
          f"{2e-9 * m * n * k / ((k1 + k2) / 2):.2f} TFLOP/s", flush=True)
    checks.check(f"{label} update within gamma_(k+1) of plain", ok,
                 f"max |kernel - plain| / bar = {ratio!r}, max |kernel - "
                 f"plain| = {err!r}")
    return dict(ms=(k1 + k2) / 2, library_ms=(l1 + l2) / 2)


def _dmma_count(lib_path) -> str:
    """The DMMA instructions in a library's SASS (``cuobjdump -sass``), or
    "not measured" where the toolkit has no cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "not measured"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return str(len(re.findall(r"\bDMMA\b", sass)))


def compare_trsm_tile(label: str, Ut, B, checks: Checks) -> dict:
    """``trsm_tile`` (U X = B) on one (b, b) tile against its plain version
    on the card (``trsm_tile_ref``, row by row), in turns, beside
    ``torch.linalg.solve_triangular``. The timed kernel solves in place
    ``TIMING_REPS`` times on one copy of B."""
    import torch
    from repro_torch.kernels.trsm import kernel, ref

    b, s = B.shape
    eps = torch.finfo(torch.float64).eps
    X = kernel.trsm_tile(Ut, B.clone())
    Xt = B.clone()
    run = lambda: kernel.trsm_tile(Ut, Xt)                        # noqa: E731
    plain = lambda: ref.trsm_tile_ref(Ut, B)                      # noqa: E731
    lib = lambda: torch.linalg.solve_triangular(Ut, B, upper=True)  # noqa: E731
    plain()
    lib()
    _, k1 = _time_cuda(run, TIMING_REPS)
    Xp, p1 = _time_cuda(plain)
    _, l1 = _time_cuda(lib, TIMING_REPS)
    _, k2 = _time_cuda(run, TIMING_REPS)
    _, p2 = _time_cuda(plain)
    _, l2 = _time_cuda(lib, TIMING_REPS)
    err = float((X - Xp).abs().max())
    rel = err / float(Xp.abs().max())
    be = _trsm_backward_error(Ut, X, B, False)
    print(f"{label} trsm_tile ({b}, {b}) with {s} RHS columns: kernel "
          f"{k1:.4f} / {k2:.4f} ms, plain {p1:.1f} / {p2:.1f} ms (on the "
          f"card), torch.linalg.solve_triangular {l1:.4f} / {l2:.4f} ms",
          flush=True)
    checks.check(f"{label} trsm_tile vs plain", rel <= TRSM_REL,
                 f"max |kernel - plain| / max|plain| = {rel!r} (bar "
                 f"{TRSM_REL})")
    checks.check(f"{label} trsm_tile backward error", be <= b * eps,
                 f"{be!r} (bar b eps = {b * eps!r})")
    return dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(l1 + l2) / 2,
                **_bound(float(b) * b * s, 8.0 * (b * (b + 1) / 2 + 2 * b * s),
                         FP64_TENSOR_FLOPS))


def _host_ms(fn, calls: int = TIMING_REPS) -> float:
    """The host's enqueue time a call over ``calls`` back-to-back calls
    (host clock, no synchronize inside the window)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def compare_band_mv(label: str, Wb, w: int, checks: Checks, seed: int) -> dict:
    """``band_mv`` on the (n, w+1) layout of the TT band Wb against its
    plain version (the dense product ``band_to_dense(band) @ x``) and
    against ``unpack_band(Wb) @ x``, on the card, componentwise within
    gamma_(2w+1) |A||x| (at most 2w+1 nonzero terms a row); in turns. Then
    for both layouts (the contiguous (n, w+1) array and the transposed
    view of Wb, strides (1, n)): bitwise on repeat and against the direct
    kernel (the first design's, which sums in the same order); the
    wrapper's time a call (CUDA events over back-to-back calls), its host
    enqueue and its device time (``torch.profiler``, and with the launches
    queued back to back); the host's enqueue by piece; and an empty
    kernel's device time and time a call on the same grid and stream, the
    floor one launch cannot beat."""
    import torch
    from repro_torch.core.band_storage import to_band_mv_layout, unpack_band
    from repro_torch.device import current_stream
    from repro_torch.kernels.band_mv import kernel, ref

    n = Wb.shape[1]
    band = to_band_mv_layout(Wb).contiguous()
    gen = torch.Generator(device=Wb.device).manual_seed(seed)
    x = torch.randn((n,), generator=gen, dtype=torch.float64, device=Wb.device)
    run = lambda: kernel.band_mv(band, x, w)                      # noqa: E731
    plain = lambda: ref.band_mv_ref(band, x)                      # noqa: E731
    run()
    plain()
    y, k1 = _time_cuda(run, TIMING_REPS)
    yp, p1 = _time_cuda(plain)
    _, k2 = _time_cuda(run, TIMING_REPS)
    _, p2 = _time_cuda(plain)
    A = unpack_band(Wb)
    yd = A @ x
    bound = _gamma(2 * w + 1) * (A.abs_() @ x.abs())
    del A
    err = float((y - yp).abs().max())
    print(f"{label} band_mv (n={n}, w={w}): kernel {k1 * 1e3:.2f} / "
          f"{k2 * 1e3:.2f} us a call, plain {p1:.2f} / {p2:.2f} ms (dense, "
          f"on the card)", flush=True)
    checks.check(f"{label} band_mv within gamma_(2w+1) of plain",
                 bool(torch.all((y - yp).abs() <= bound)),
                 f"max |kernel - plain| = {err!r}")
    checks.check(f"{label} band_mv within gamma_(2w+1) of unpack_band @ x",
                 bool(torch.all((y - yd).abs() <= bound)),
                 f"max |kernel - dense| = {float((y - yd).abs().max())!r}")
    smem = kernel.band_mv_plan(n, w, 128)
    for name, bd in (("row-major", band), ("transposed view",
                                           to_band_mv_layout(Wb))):
        call = lambda: kernel.band_mv(bd, x, w)                   # noqa: E731
        first, again = call(), call()
        direct = kernel.band_mv_launch(bd, x, w, 128, 0)
        checks.check(f"{label} band_mv {name} repeats bitwise",
                     bool(torch.equal(first, again)), "two calls")
        checks.check(f"{label} band_mv {name} bitwise against the direct "
                     f"kernel", bool(torch.equal(first, direct)),
                     f"max |staged - direct| = "
                     f"{float((first - direct).abs().max())!r}")
        checks.check(f"{label} band_mv {name} layouts agree bitwise",
                     bool(torch.equal(first, y)), "against the row-major "
                     "call")
        direct = functools.partial(kernel.band_mv_launch, bd, x, w, 128, 0)
        print(f"{label} band_mv {name}: a call "
              f"{_time_cuda(call, TIMING_REPS)[1] * 1e3:.2f} us, host "
              f"enqueue {_host_ms(call) * 1e3:.2f} us, device "
              f"{_ms(_device_ms(call))} (torch.profiler) / "
              f"{_queued_ms(call) * 1e3:.2f} us a launch queued; the direct "
              f"kernel {_ms(_device_ms(direct))} / "
              f"{_queued_ms(direct) * 1e3:.2f} us (staged {smem} bytes a "
              f"block of 128 rows)", flush=True)
    empty = functools.partial(kernel.empty_launch, Wb.device, n)
    # the host's cost a call, by piece
    y0 = torch.empty_like(x)
    c_entry = functools.partial(
        kernel._lib().band_mv_fp64, band.data_ptr(), w + 1, 1, x.data_ptr(),
        y0.data_ptr(), n, w, 128, smem, current_stream(Wb.device))
    print(f"{label} band_mv host enqueue a call, by piece: the wrapper "
          f"{_host_ms(run) * 1e3:.2f} us; torch.empty_like(x) "
          f"{_host_ms(lambda: torch.empty_like(x)) * 1e3:.2f} us; the C "
          f"entry through ctypes (its launch included) "
          f"{_host_ms(c_entry) * 1e3:.2f} us; an empty kernel through "
          f"ctypes {_host_ms(empty) * 1e3:.2f} us", flush=True)
    bnd = _bound(2.0 * (2 * w + 1) * n, 8.0 * (n * (w + 1) + 2 * n),
                 FP64_TENSOR_FLOPS)
    print(f"{label} band_mv floors: an empty kernel on its grid "
          f"({-(-n // 128)} blocks of 128), device {_ms(_device_ms(empty))} "
          f"/ {_queued_ms(empty) * 1e3:.2f} us a launch queued, a call "
          f"{_time_cuda(empty, TIMING_REPS)[1] * 1e3:.2f} us, host enqueue "
          f"{_host_ms(empty) * 1e3:.2f} us; byte bound "
          f"{bnd['bound_ms']:.5f} ms", flush=True)
    # the band once, x once, y once; 2 (2w+1) flops a row
    return dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=None, **bnd)


# ---- the reduced (fp32 and bf16) instances ---------------------------------

#: unit roundoff of fp32 (every reduced instance computes in fp32) and of
#: each storage dtype; bytes an entry
U32 = 2.0 ** -24
U_STORE = {"fp32": 2.0 ** -24, "bf16": 2.0 ** -8}
ESIZE = {"fp32": 4, "bf16": 2}


def _gamma32(k: int) -> float:
    return k * U32 / (1 - k * U32)


#: the reduced panel's bar: entry (i, j) of V (rows, b) or T (b, b) within
#: PANEL_C sqrt(rows) u(fp32) max(|x_ij|, ||x_:j|| / sqrt(m)) + 2 u_store
#: |x_ij|, m the matrix's own rows: fp32 sums over the panel's rows in other
#: orders (a column's error, spread over its entries), then one rounding to
#: the storage dtype (one unit of it at most). PANEL_C from readings at
#: 9997 x 16 on the host CPU (the plain panel in fp32 against it in fp64:
#: max ratio 0.019 for V, 0.009 for T at c = 4; the first MD panel at
#: n = 2000: 0.053, 0.020; the card's MD panel against the plain one: 0.017
#: in fp32, and in bf16 up to 1, which a one-unit flip at the store reads
#: by construction); a bf16-computed panel reads 200 to 2400 times the
#: fp32 bar and 18 to 370 times the bf16 one, a V zeroed below its pivots
#: 128 times or more, and compare_reduced checks both on the card's panel
#: every run
PANEL_C = 4.0


def _panel_ratio(got, want, rows: int, us: float) -> float:
    """max over entries of |got - want| / the panel's bar."""
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    col = torch.linalg.vector_norm(want, dim=0, keepdim=True)
    scale = torch.maximum(want.abs(), col / want.shape[0] ** 0.5)
    bar = PANEL_C * rows ** 0.5 * U32 * scale + 2 * us * want.abs()
    return float(((got - want).abs() / bar).max())


def _reduced_dtype(sfx: str):
    import torch
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[sfx]


def _in_turns(run, plain, reps: int = 1):
    """kernel, plain, kernel: (kernel result, plain result, kernel ms
    (mean of two turns), plain ms)."""
    run()                                             # warm-up
    out_k, k1 = _time_cuda(run, reps)
    out_p, p1 = _time_cuda(plain)
    _, k2 = _time_cuda(run, reps)
    return out_k, out_p, (k1 + k2) / 2, p1


def _padded_empty(n: int, dt, dev):
    """An (n, n) output whose rows start on 16-byte boundaries, laid out
    as the reduced working copies are (``padded_copy``)."""
    import torch
    from repro_torch.core.precision import padded_copy
    return padded_copy(torch.empty((n, n), dtype=dt, device=dev), dt)


def _syr2k_at_path(C, V, W, out, sym: bool, path: str):
    """The reduced ``syr2k`` (alpha = -1) through syr2k.cu's C entry on
    ``path`` (``narrow``: ``syr2k_tiles``, any layout; ``wide``:
    ``syr2k_pairs``), whatever the wrapper would take: no launch
    counted."""
    import torch
    from repro_torch.kernels import _launches
    from repro_torch.kernels.syr2k import kernel as sk

    n, k = V.shape
    fn = sk.ENTRY[C.dtype]
    err = getattr(sk._lib(), fn)(
        C.data_ptr(), C.stride(0), V.data_ptr(), V.stride(0), W.data_ptr(),
        W.stride(0), out.data_ptr(), out.stride(0), n, k, -1.0, int(sym),
        _launches.PATH_CODE[path],
        torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} on path {path}: cudaError {err}")
    return out


def _alternating(runs: dict, reps: int = TIMING_REPS, rounds: int = 2):
    """Device ms a call of each of ``runs`` (name -> fn), the calls queued
    back to back (``_queued_ms``: the host's enqueue left out), timed in
    turns, ``rounds`` times over: name -> [ms of each round]."""
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            times[name].append(_queued_ms(fn, reps))
    return times


def _unaligned(M, dt):
    """M in dt with its rows off 16-byte boundaries (the reduced product's
    and ``syr2k``'s narrow path): the contiguous copy where a row of n entries is no
    multiple of 16 bytes (the odd lda of MD, C's own layout), else a view
    one entry into a copy with one more column."""
    import torch
    n = M.shape[1]
    if (n * torch.empty((), dtype=dt).element_size()) % 16:
        return M.to(dt, copy=True)
    big = torch.zeros((M.shape[0], n + 1), dtype=dt, device=M.device)
    view = big[:, 1:]
    view.copy_(M)
    return view


def _turns(times: dict) -> str:
    return ", ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                     for name, ts in times.items())


def reduced_chase(label: str, sfx: str, Wb, w: int, tables: dict,
                  checks: Checks) -> dict:
    """The ``sfx`` chase of the MD band Wb pass by pass through the wrapper
    (its plan's path: the cluster kernel), each pass's table put in
    ``tables`` (b -> table). Its first and last pass also run through the
    cooperative kernel forced (the older path) and the plain chase on a host
    copy, in turns (wrapper, plain, cooperative, wrapper, cooperative), each
    bitwise against the plain version (band and table); then, on those two
    passes, the cluster at 16 and at 8 CTAs, each whole and with its
    barriers alone (``BARRIER_ONLY``: the chain floor of the pass), in
    turns. Returns the row: the wrapper per launch over the two passes,
    with the cooperative kernel's time and the plan's chain floor."""
    import torch
    from repro_torch.core.band_storage import clean_band
    from repro_torch.core.sbr import _executed_passes
    from repro_torch.kernels.rot_apply import kernel as rk
    from repro_torch.kernels.rot_apply import ref as rr
    from repro_torch.kernels.rot_apply.schedule import (chase_stagger,
                                                        padded_band,
                                                        pass_schedule)

    dt = _reduced_dtype(sfx)
    n = Wb.shape[1]
    passes = _executed_passes(n, w)
    compared = (passes[0], passes[-1])
    Wp = padded_band(clean_band(Wb).to(dt), w)
    npad = Wp.shape[1]
    errs, k_ms, c_ms, p_ms, floors = [], [], [], [], []
    for b in passes:
        if b not in compared:
            tables[b] = rk.chase_pass(Wp, b, w, n)
            continue
        plan = rk.chase_plan(
            npad, w, b, lambda c, m: rk.cluster_capacity(c, m, dt), dt)
        checks.check(f"{label} chase_pass_{sfx} b={b} plan is the cluster "
                     f"kernel", plan.path == "cluster", str(plan))
        Wk, Wk2, Wc, Wc2 = (Wp.clone() for _ in range(4))
        Wq = Wp.cpu()

        def coop(W, b=b):
            return rk.chase_launch(W, b, w, n, rk.COOPERATIVE, rk.FULL)

        # the plain chase on a host copy: a host loop of small ops a step,
        # which the host runs faster than the card's launches
        CS, k1 = _time_cuda(lambda: rk.chase_pass(Wk, b, w, n))
        CSq, p1 = _time_host(lambda: rr.chase_pass_lanes_ref(Wq, b, w, n))
        CSc, c1 = _time_cuda(lambda: coop(Wc))
        _, k2 = _time_cuda(lambda: rk.chase_pass(Wk2, b, w, n))
        _, c2 = _time_cuda(lambda: coop(Wc2))
        for path, W, T in (("wrapper (cluster)", Wk, CS),
                           ("cooperative", Wc, CSc)):
            same = torch.equal(W.cpu(), Wq) and torch.equal(T.cpu(), CSq)
            gap = float((W.cpu().float() - Wq.float()).abs().max())
            checks.check(f"{label} chase_pass_{sfx} b={b} {path} band and "
                         f"(c, s) table bitwise vs plain", same,
                         f"max |kernel - plain| = {gap!r}")
            errs.append(gap)
        checks.check(f"{label} chase_pass_{sfx} b={b} repeats bitwise",
                     bool(torch.equal(Wk, Wk2)), "two calls")
        sizes = {}
        for cs in (16, 8):
            cpc, smem = rk.cluster_share(npad, w, b, cs, rk.CHASE_ENTRY[dt])
            if smem <= rk.SMEM_MAX and cpc >= w + 3 and \
                    rk.cluster_capacity(cs, smem, dt) > 0:
                sizes[cs] = rk.ChasePlan("cluster", cs, cpc, smem)
        times = {}
        for _ in range(2):
            for cs, pl in sizes.items():
                for mname, mode in (("whole", rk.FULL),
                                    ("barriers only", rk.BARRIER_ONLY)):
                    W = Wp.clone()
                    _, ms = _time_cuda(lambda: rk.chase_launch(
                        W, b, w, n, pl, mode))
                    times.setdefault(f"{cs} CTAs {mname}", []).append(ms)
        steps = pass_schedule(n, b, chase_stagger(b))[1]
        floor = min(times.get(f"{plan.csize} CTAs barriers only", [0.0]))
        print(f"{label} chase_pass_{sfx} b={b}: wrapper ({plan.path}, "
              f"{plan.csize} CTAs of {plan.smem} bytes) {k1:.3f} / "
              f"{k2:.3f} ms, cooperative kernel (older path) {c1:.3f} / "
              f"{c2:.3f} ms, plain {p1:.0f} ms (on the host CPU); by "
              f"cluster size ({steps} steps; ms, in turns; us a step): "
              + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} "
                          f"({1e3 * min(v) / steps:.3f})"
                          for k, v in times.items()), flush=True)
        k_ms.append((k1 + k2) / 2)
        c_ms.append((c1 + c2) / 2)
        p_ms.append(p1)
        floors.append(floor)
        tables[b] = CS
        Wp = Wk
        del Wk2, Wc, Wc2, Wq, CSq, CSc
    return dict(max_abs_err=max(errs), ms=sum(k_ms) / 2,
                plain_ms=sum(p_ms) / 2, library_ms=None,
                older_path_ms=sum(c_ms) / 2, chain_floor_ms=sum(floors) / 2,
                **_per_launch(_chase_bound(n, w, compared, ESIZE[sfx],
                                           FP32_VECTOR_FLOPS), 2))


def reduced_replay(label: str, sfx: str, n: int, tables: dict, gen, dev,
                   checks: Checks) -> dict:
    """TT4's ``sfx`` replay onto an (n, 100) slab in reverse: the first and
    last pass's tables through the wrapper (its plan's path: the slab
    kernel), the plain version on the card and the sweep kernel forced
    (the older path), in turns (wrapper, plain, sweep, wrapper, sweep), each
    bitwise against the plain version; the slab kernel's timing variants
    on those two passes in turns (no table, lane 0 alone: the chain floor);
    then all the passes (TT4's launches), wrapper against sweep kernel in
    turns, bitwise. Returns the row: the wrapper per launch over the two
    passes, with the sweep kernel's time and the chain floor."""
    import torch
    from repro_torch.kernels.rot_apply import kernel as rk
    from repro_torch.kernels.rot_apply import ref as rr

    dt = _reduced_dtype(sfx)
    bs = sorted(tables)
    compared = (bs[0], bs[-1])
    Zs = torch.randn((n, 100), generator=gen, dtype=torch.float32,
                     device=dev).to(dt)

    def replay(fn, passes=compared):
        # apply_q2's order: passes b = 2..w, each in reverse
        def go():
            Y = Zs.clone()
            for b in passes:
                fn(Y, tables[b], b, n, True)
            return Y
        return go

    def forced(mode=None):
        def fn(Y, CS, b, n_, rev):
            plan = (rk.SWEEP if mode is None
                    else rk.replay_plan(n_, Y.shape[1], True, dt, b))
            rk.replay_launch(Y, CS, b, n_, rev, plan,
                             rk.REPLAY_FULL if mode is None else mode)
        return fn

    wrapper, sweep = replay(rk.replay_pass), replay(forced())
    wrapper()                                         # warm-up
    Y, k1 = _time_cuda(wrapper)
    Yp, p1 = _time_cuda(replay(rr.replay_pass_ref))
    Ys, s1 = _time_cuda(sweep)
    _, k2 = _time_cuda(wrapper)
    _, s2 = _time_cuda(sweep)
    for path, got in (("wrapper (slab)", Y), ("sweep kernel", Ys)):
        checks.check(f"{label} replay_pass_{sfx} {path} bitwise vs plain",
                     bool(torch.equal(got, Yp)),
                     f"max |kernel - plain| = "
                     f"{float((got.float() - Yp.float()).abs().max())!r}")
    err = float((Y.float() - Yp.float()).abs().max())
    plans = {b: rk.replay_plan(n, 100, True, dt, b) for b in compared}
    for b, plan in plans.items():
        checks.check(f"{label} replay_pass_{sfx} b={b} plan is the slab "
                     f"kernel", plan.path == "slab", str(plan))
    times = {}
    for _ in range(2):
        for name, fn in (("whole", wrapper),
                         ("no table (a fixed rotation)",
                          replay(forced(rk.NO_TABLE))),
                         ("lane 0 alone", replay(forced(rk.ONE_LANE)))):
            times.setdefault(name, []).append(_time_cuda(fn)[1])
    every = {}
    for _ in range(2):
        for name, fn in (("wrapper", replay(rk.replay_pass, bs)),
                         ("sweep kernel", replay(forced(), bs))):
            out, ms = _time_cuda(fn)
            every.setdefault(name, []).append(ms)
            every.setdefault(f"{name} out", out)
    checks.check(f"{label} replay_pass_{sfx} all {len(bs)} passes, wrapper "
                 f"bitwise vs sweep kernel",
                 bool(torch.equal(every.pop("wrapper out"),
                                  every.pop("sweep kernel out"))),
                 "the same plain order")
    print(f"{label} replay_pass_{sfx} (passes b={compared[0]} and "
          f"b={compared[1]} onto ({n}, 100)): wrapper ("
          + ", ".join(f"b={b} {p.path}, 2 table slices of {p.stage} bytes, "
                      f"{p.smem} bytes" for b, p in plans.items())
          + f") {k1:.3f} / {k2:.3f} ms, sweep kernel (older path) "
          f"{s1:.3f} / {s2:.3f} ms, plain {p1:.0f} ms (on the card); by "
          f"part (ms, in turns): {_turns(times)}; all {len(bs)} passes "
          f"(ms, in turns): {_turns(every)}", flush=True)
    return dict(max_abs_err=err, ms=(k1 + k2) / 4, plain_ms=p1 / 2,
                library_ms=None, older_path_ms=(s1 + s2) / 4,
                chain_floor_ms=min(times["lane 0 alone"]) / 2,
                **_per_launch(_replay_bound(n, 100, compared, ESIZE[sfx],
                                            FP32_VECTOR_FLOPS), 2))


def reduced_panel(label: str, sfx: str, E, row_start: int, checks: Checks,
                  E64=None):
    """The ``sfx`` panel E[row_start:, :] (the first TT1 panel of the
    padded working copy) through the wrapper (its plan's path: the cluster
    kernel) and the cooperative instance forced (the older path), each
    against the plain version (factored in fp32 on the host, rounded to
    bf16 at the store) within the panel's bar (``PANEL_C``) and bitwise on
    repeat; the bar checked to reject a bf16-computed panel and a V zeroed
    below its pivots. Timed in turns (wrapper, plain, cooperative, wrapper,
    cooperative: CUDA events a call), each path's device time
    (``torch.profiler``), and, queued back to back in turns, the cluster
    kernel at 16, 8 and 4 CTAs (each also held to the bar), its barriers
    alone and without cross-CTA sums, the cooperative instance and, given
    ``E64`` (the same panel in fp64), fp64's wrapper; ``torch.geqrf`` of
    the active rows for fp32 (no bf16 geqrf). Returns the wrapper's row
    and its (V, T)."""
    import torch
    from repro_torch.kernels.house_panel import kernel as hk
    from repro_torch.kernels.house_panel import ops as ho
    from repro_torch.kernels.house_panel import ref as hr

    dt = _reduced_dtype(sfx)
    n, w = E.shape
    active = n - row_start
    es, us = ESIZE[sfx], U_STORE[sfx]
    plan = hk.house_plan(active, w, hk.cluster_capacity, dt)
    checks.check(f"{label} house_panel_{sfx} plans the cluster",
                 plan.path == "cluster", repr(plan))
    run = {"cluster": lambda: hk.house_panel(E, row_start),
           "cooperative": lambda: _house_run(E, row_start, hk.COOPERATIVE,
                                             hk.FULL)}
    for fn in run.values():
        fn()                                          # warm-up
    out = {k: [] for k in run}
    ms = {k: [] for k in run}

    def turn(k):
        o, t = _time_cuda(run[k], TIMING_REPS)
        out[k].append(o)
        ms[k].append(t)

    turn("cluster")
    (Vp, Tp), pms = _time_cuda(lambda: ho.house_panel(E.cpu(), row_start))
    for k in ("cooperative", "cluster", "cooperative"):
        turn(k)
    ratio = {}
    for k, ((V, T), (V2, T2)) in out.items():
        ratio[k] = max(_panel_ratio(V, Vp, n, us), _panel_ratio(T, Tp, n, us))
        checks.check(f"{label} house_panel_{sfx} {k} V, T vs plain",
                     ratio[k] <= 1.0, f"max gap / bar {ratio[k]!r} (c = "
                     f"{PANEL_C}; one unit of {sfx} at the store reads up "
                     f"to 1)")
        checks.check(f"{label} house_panel_{sfx} {k} repeats bitwise",
                     bool(torch.equal(V, V2) and torch.equal(T, T2)),
                     "two turns")
    V, T = out["cluster"][0]
    err = max(float((V.cpu().double() - Vp.double()).abs().max()),
              float((T.cpu().double() - Tp.double()).abs().max()))
    # what the bar must reject: the panel computed in bf16 arithmetic
    # (the plain version without its fp32 upcast), V zeroed below the
    # pivots
    Vc, Tc = hr.house_panel_ref(E.cpu().to(torch.bfloat16), row_start)
    bad_c = min(_panel_ratio(Vc, Vp, n, us), _panel_ratio(Tc, Tp, n, us))
    Vz = V.cpu().clone()
    Vz[row_start + w + 1:] = 0
    bad_z = _panel_ratio(Vz, Vp, n, us)
    del Vc, Tc, Vz
    checks.check(f"{label} house_panel_{sfx} bar rejects a bf16-computed "
                 f"panel and a zeroed V tail", bad_c > 1.0 and bad_z > 1.0,
                 f"min gap / bar {bad_c!r} (bf16-computed V or T), "
                 f"{bad_z!r} (V zeroed below row {row_start + w})")
    device = {k: _device_ms(fn) for k, fn in run.items()}
    # the cluster at each size, the plan's timing variants, in turns
    sizes = {c: hk.cluster_at(active, w, c, dt) for c in (16, 8, 4)}
    for c, p in sizes.items():
        Vs, Ts = _house_run(E, row_start, p, hk.FULL)
        r = max(_panel_ratio(Vs, Vp, n, us), _panel_ratio(Ts, Tp, n, us))
        checks.check(f"{label} house_panel_{sfx} at {c} CTAs vs plain",
                     r <= 1.0, f"max gap / bar {r!r} ({p.rpc} rows, "
                     f"{p.smem} bytes a CTA)")
    queued = _alternating({
        **{f"{c} CTAs ({p.rpc} rows)": (
            lambda p=p: _house_run(E, row_start, p, hk.FULL))
           for c, p in sizes.items()},
        "barriers only": lambda: _house_run(E, row_start, plan,
                                            hk.BARRIER_ONLY),
        "no cross-CTA sums": lambda: _house_run(E, row_start, plan,
                                                hk.NO_SUMS),
        "cooperative": run["cooperative"],
        **({} if E64 is None else {
            "fp64 wrapper": lambda: hk.house_panel(E64, row_start)})})
    lib = None
    if dt == torch.float32:
        act = E[row_start:].contiguous()
        torch.geqrf(act)
        _, lib = _time_cuda(lambda: torch.geqrf(act), TIMING_REPS)
    bound = _bound(4.0 * n * w * w, es * 2.0 * n * w, FP32_VECTOR_FLOPS)
    print(f"{label} house_panel_{sfx} ({n} x {w}, row_start {row_start}; "
          f"plan {plan.path} of {plan.csize} CTAs, {plan.rpc} rows, "
          f"{plan.smem} bytes): a call in turns (CUDA events, "
          f"{TIMING_REPS} in a window) cluster "
          f"{ms['cluster'][0]:.4f} / {ms['cluster'][1]:.4f} ms, cooperative "
          f"{ms['cooperative'][0]:.4f} / {ms['cooperative'][1]:.4f} ms; "
          f"device (torch.profiler) cluster {_ms(device['cluster'])}, "
          f"cooperative {_ms(device['cooperative'])}; plain {pms:.1f} ms "
          f"(host CPU); torch.geqrf "
          f"{'not run (no bf16 geqrf)' if lib is None else f'{lib:.4f} ms'}"
          f"; least time {bound['bound_ms']:.5f} ms ({bound['bound_by']}); "
          f"device ms a call, queued, in turns: {_turns(queued)}",
          flush=True)
    row = dict(max_abs_err=err, ms=sum(ms["cluster"]) / 2, plain_ms=pms,
               library_ms=lib, **bound,
               older_path_ms=sum(ms["cooperative"]) / 2,
               device_ms=device["cluster"])
    return row, (V, T)


def compare_reduced(label: str, C, Wb, w: int, checks: Checks, dev) -> dict:
    """Each fp32 and bf16 instance against its plain version on the card, at
    the MD main path's shapes; returns a row per instance
    (``<kernel>_<fp32|bf16>``).

    Bars: ``syr2k``, ``rot_apply``, ``chase_pass`` and ``replay_pass`` are
    bitwise (their plain versions round at the kernels' points, no FMA on
    either side); ``house_panel`` (``reduced_panel``: the cluster kernel
    and the cooperative instance) within the panel's bar (``PANEL_C``),
    which a bf16-computed panel and a V zeroed below its pivots must fail;
    ``symm_block`` and ``symv`` within
    2 gamma_n(fp32) |sym(triu A)||X| + 2 u_store |Y| (fp32 sums in other
    orders, then one rounding to the storage dtype). Library calls:
    ``torch.addmm`` for ``syr2k``, ``torch.matmul`` for the product and the
    batched ``torch.matmul`` of the (G, 2, 2) rotations for ``rot_apply``,
    in the storage dtype (fp32 with TF32 off, as PyTorch's default is);
    ``torch.geqrf`` of the active rows for the fp32 panel (no bf16
    geqrf)."""
    import torch
    from repro_torch.core.linalg_utils import wy_syr2k_panel
    from repro_torch.core.precision import padded_copy
    from repro_torch.kernels.rot_apply import kernel as rk
    from repro_torch.kernels.rot_apply import ref as rr
    from repro_torch.kernels.symv import kernel as yk
    from repro_torch.kernels.symv import ref as yr
    from repro_torch.kernels.syr2k import kernel as sk
    from repro_torch.kernels.syr2k import ref as sr

    assert not torch.backends.cuda.matmul.allow_tf32
    n = C.shape[0]
    rows = {}
    gen = torch.Generator(device=dev).manual_seed(21)
    for sfx in ("fp32", "bf16"):
        dt = _reduced_dtype(sfx)
        es, us = ESIZE[sfx], U_STORE[sfx]
        # the main path's layout (rows padded to 16 bytes: TT1's working
        # copy, the Krylov operator) and C's own odd-lda layout
        Cd = padded_copy(C, dt)
        Co = _unaligned(C, dt)
        # ---- house_panel: the first TT1 panel, row_start w --------------
        rows[f"house_panel_{sfx}"], (V, T) = reduced_panel(
            label, sfx, Cd[:, :w], w, checks, E64=C[:, :w])
        # ---- syr2k: the first window, (V, Z) of that panel --------------
        Z = wy_syr2k_panel(Cd, V, T)
        out = _padded_empty(n, dt, dev)
        R, Rp, ms, pms = _in_turns(
            lambda: sk.syr2k(Cd, V, Z, alpha=-1.0, out=out),
            lambda: sr.syr2k_reduced_ref(Cd, V, Z, -1.0), TIMING_REPS)
        same = bool(torch.equal(R, Rp))
        err = float((R.float() - Rp.float()).abs().max())
        Sp = sr.syr2k_reduced_ref(Cd, V, Z, -1.0, symmetrize=True)
        S = sk.syr2k(Cd, V, Z, alpha=-1.0, symmetrize=True,
                     out=_padded_empty(n, dt, dev))
        same_sym = bool(torch.equal(S, Sp))
        again = sk.syr2k(Cd, V, Z, alpha=-1.0,
                         out=_padded_empty(n, dt, dev))
        checks.check(f"{label} syr2k_{sfx} repeats bitwise",
                     bool(torch.equal(again, R)), "two calls")
        del again
        # the odd-lda copy: the narrow path, the same bits
        outn = _unaligned(Co, dt)
        paths = {"padded": sk.update_path(Cd, out),
                 "odd lda": sk.update_path(Co, outn)}
        checks.check(f"{label} syr2k_{sfx} paths by layout",
                     paths == {"padded": "wide", "odd lda": "narrow"},
                     json.dumps(paths))
        Rn = sk.syr2k(Co, V, Z, alpha=-1.0, out=outn)
        Sn = sk.syr2k(Co, V, Z, alpha=-1.0, symmetrize=True,
                      out=_unaligned(Co, dt))
        checks.check(f"{label} syr2k_{sfx} narrow path bitwise vs plain",
                     bool(torch.equal(Rn, Rp) and torch.equal(Sn, Sp)),
                     f"max |kernel - plain| = "
                     f"{float((Rn.float() - Rp.float()).abs().max())!r}")
        del Rn, Sn
        # in turns: the wide path, and the narrow path (syr2k_tiles) on the
        # odd-lda copy and on the padded one
        out0 = _padded_empty(n, dt, dev)
        VW, WV = torch.cat([V, Z], 1), torch.cat([Z, V], 1).mT
        # k = 0: the same walk, staging, epilogue and stores with no
        # products, the kernel's data movement alone
        times = _alternating({
            "wide": lambda: sk.syr2k(Cd, V, Z, alpha=-1.0, out=out),
            "wide at k=0": lambda: sk.syr2k(Cd, V[:, :0], Z[:, :0],
                                            alpha=-1.0, out=out0),
            "narrow (odd lda)": lambda: sk.syr2k(Co, V, Z, alpha=-1.0,
                                                 out=outn),
            "narrow (padded)": lambda: _syr2k_at_path(Cd, V, Z, out0,
                                                       False, "narrow"),
            "torch.addmm": lambda: torch.addmm(Co, VW, WV, alpha=-1.0)})
        checks.check(f"{label} syr2k_{sfx} narrow path on the padded copy "
                     f"bitwise", bool(torch.equal(out0, R)),
                     "the same plain version")
        torch.addmm(Co, VW, WV, alpha=-1.0)
        _, lib = _time_cuda(lambda: torch.addmm(Co, VW, WV, alpha=-1.0),
                            TIMING_REPS)
        bound = _bound(4.0 * w * n * n, es * (2.0 * n * n + 2 * n * w),
                       FP32_VECTOR_FLOPS)
        print(f"{label} syr2k_{sfx} (n={n}, k={w}): kernel {ms:.4f} ms "
              f"(padded rows, {paths['padded']} path), plain {pms:.1f} ms "
              f"(on the card), torch.addmm {lib:.4f} ms, least time "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); device "
              f"ms a call, queued, in turns: {_turns(times)}", flush=True)
        checks.check(f"{label} syr2k_{sfx} bitwise vs plain", same,
                     f"max |kernel - plain| = {err!r}")
        checks.check(f"{label} syr2k_{sfx} symmetrized bitwise vs plain",
                     same_sym, "the TT1 sweep's launch")
        rows[f"syr2k_{sfx}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lib, **bound)
        del R, Rp, S, Sp, out, outn, out0, VW, WV, Z
        torch.cuda.empty_cache()
        # ---- chase_pass on the MD band, replay_pass of its tables -------
        tables = {}
        rows[f"chase_pass_{sfx}"] = reduced_chase(label, sfx, Wb, w, tables,
                                                  checks)
        rows[f"replay_pass_{sfx}"] = reduced_replay(label, sfx, n, tables,
                                                    gen, dev, checks)
        del tables
        # ---- rot_apply at the chase's widest wavefront ------------------
        pairs = torch.randn((1000, 2, 8), generator=gen, dtype=torch.float32,
                            device=dev).to(dt)
        th = 6.283185307179586 * torch.rand((1000,), generator=gen,
                                            device=dev)
        cs = torch.stack([torch.cos(th), torch.sin(th)], 1).to(dt)
        Yr, Yq, ms, pms = _in_turns(
            lambda: rk.rot_apply(pairs, cs),
            lambda: rr.rot_apply_ref(pairs.cpu(), cs.cpu()), TIMING_REPS)
        c, s_ = cs[:, 0], cs[:, 1]
        Rm = torch.stack([torch.stack([c, s_], 1),
                          torch.stack([-s_, c], 1)], 1)
        torch.matmul(Rm, pairs)
        _, lib = _time_cuda(lambda: torch.matmul(Rm, pairs), TIMING_REPS)
        print(f"rot_apply_{sfx} (G=1000, L=8): kernel {ms:.4f} ms, plain "
              f"{pms:.3f} ms (on the host CPU), torch.matmul {lib:.4f} ms",
              flush=True)
        checks.check(f"rot_apply_{sfx} G=1000 L=8 bitwise vs plain",
                     bool(torch.equal(Yr.cpu(), Yq)),
                     f"max |kernel - plain| = "
                     f"{float((Yr.cpu().float() - Yq.float()).abs().max())!r}")
        rows[f"rot_apply_{sfx}"] = dict(
            max_abs_err=float((Yr.cpu().float() - Yq.float()).abs().max()),
            ms=ms, plain_ms=pms, library_ms=lib,
            **_bound(6.0 * 1000 * 8, es * (4.0 * 1000 * 8 + 2 * 1000),
                     FP32_VECTOR_FLOPS))
        # ---- symm_block at p = 1 and 4, symv ----------------------------
        absA = torch.triu(Co.abs()).float()
        absA += torch.triu(Co.abs(), 1).mT.float()
        for name, p in (("symm_block", 1), ("symm_block", 4), ("symv", 1)):
            X = torch.randn((n, p), generator=gen, dtype=torch.float32,
                            device=dev).to(dt)
            if name == "symv":
                X = X[:, 0].contiguous()
            key = f"{name} p={p}" if name == "symm_block" else name

            def run(A, X=X, name=name):
                return (yk.symv(A, X) if name == "symv"
                        else yk.symm_block(A, X))

            plain = lambda X=X: yr.symm_block_upper_ref(Co, X)  # noqa: E731
            Yk, Yq, ms, pms = _in_turns(lambda: run(Cd), plain, TIMING_REPS)
            bar = (2 * _gamma32(n) * (absA @ X.float().abs())
                   + 2 * us * Yq.float().abs())
            # the main path's padded copy and the odd-lda copy (the wide
            # and the narrow path)
            outs = {"padded": Yk, "odd lda": run(Co)}
            for case, Y in outs.items():
                gap = (Y.float() - Yq.float()).abs()
                checks.check(f"{label} {key} {sfx} {case} within the gamma "
                             f"bar of plain", bool(torch.all(gap <= bar)),
                             f"max |kernel - plain| = {float(gap.max())!r}, "
                             f"max ratio {float((gap / bar).max())!r}")
                again = run(Cd) if case == "padded" else run(Co)
                checks.check(f"{label} {key} {sfx} {case} repeats bitwise",
                             bool(torch.equal(again, Y)), "two calls")
            times = _alternating({
                "padded": lambda: run(Cd), "odd lda": lambda: run(Co),
                "torch.matmul": lambda X=X: torch.matmul(Co, X)})
            torch.matmul(Co, X)
            _, lib = _time_cuda(lambda X=X: torch.matmul(Co, X),
                                TIMING_REPS)
            bound = _bound(2.0 * n * n * p,
                           es * (n * (n + 1) / 2 + 2 * n * p),
                           FP32_VECTOR_FLOPS)
            paths = {"padded": yk.product_path(Cd),
                     "odd lda": yk.product_path(Co)}
            print(f"{label} {key} {sfx}: kernel {ms:.4f} ms (padded rows, "
                  f"{paths['padded']}), plain {pms:.3f} ms (on the card), "
                  f"torch.matmul {lib:.4f} ms, least time "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
                  f"device ms a call, queued, in turns: {_turns(times)}",
                  flush=True)
            checks.check(f"{label} {key} {sfx} paths by layout",
                         paths == {"padded": "wide", "odd lda": "narrow"},
                         json.dumps(paths))
            if p > 1:
                continue
            gap = (Yk.float() - Yq.float()).abs()
            rows[f"{name}_{sfx}"] = dict(
                max_abs_err=float(gap.max()), ms=ms, plain_ms=pms,
                library_ms=lib, **bound)
        del absA, Cd, Co
        torch.cuda.empty_cache()
    return rows


def run_precision(md, s: int, checks: Checks) -> dict:
    """The mixed and fast levels on the MD pencil at the paper's size: TT,
    KE (invert, p = 1) and KI at both levels, TD at mixed; each through
    ``run_solve`` (the Table-3 bars on the original pencil, the exact
    spectrum, launches) with ``on_failure="recover"`` and the default
    refinement settings, printing the refinement (steps, shifts, residual
    trajectory) and the recovery rungs
    (an ``escalate_precision`` rerun at fp64 is reported). Checks that
    the reduced instances ran: 624 ``house_panel`` and ``syr2k`` and 15
    ``chase_pass`` and ``replay_pass`` launches of the level's instances
    for TT, all 624 panels on the cluster kernel, all 624 ``syr2k`` on the
    wide path, ``symm_block``'s for KE
    and KI, all on the wide path. Returns each solve's launch
    counts (``<label>``) and load-path counts (``<label> paths``)."""
    from repro_torch.core.sbr import _executed_passes, _n_panels

    n = md.A.shape[0]
    out = {}
    cases = [("TT", "mixed", dict(variant="TT", band_width=TT_W)),
             ("TT", "fast", dict(variant="TT", band_width=TT_W)),
             ("KE", "mixed", dict(variant="KE", invert=True,
                                  use_kernel=True)),
             ("KE", "fast", dict(variant="KE", invert=True,
                                 use_kernel=True)),
             ("KI", "mixed", dict(variant="KI", invert=True,
                                  use_kernel=True)),
             ("KI", "fast", dict(variant="KI", invert=True,
                                 use_kernel=True)),
             ("TD", "mixed", dict(variant="TD"))]
    for variant, level, kw in cases:
        label = f"{variant} {level}"
        paths: dict = {}
        res = run_solve(label, md, s, checks, paths=paths, precision=level,
                        on_failure="recover", **kw)
        rinfo = res.info["refinement"]
        rungs = [(r["action"], r["outcome"]) for r in res.info["recovery"]]
        print(f"  refinement: steps {rinfo['steps']}, converged "
              f"{rinfo['converged']}, stalled {rinfo['stalled']}, sigma "
              f"{rinfo['sigma']}, relative_residual "
              f"{[float(f'{x:.3e}') for x in rinfo['relative_residual']]}; "
              f"recovery {rungs}", flush=True)
        sfx = {"mixed": "fp32", "fast": "bf16"}[level]
        counts = res.info["kernel_launches"]
        if variant == "TT":
            n_pass = len(_executed_passes(n, TT_W))
            want = {f"house_panel_{sfx}": _n_panels(n, TT_W),
                    f"syr2k_{sfx}": _n_panels(n, TT_W),
                    f"chase_pass_{sfx}": n_pass,
                    f"replay_pass_{sfx}": n_pass}
            got = {k: counts[k] for k in want}
            checks.check(f"{label} reduced TT launch counts", got == want,
                         f"{json.dumps(got)} (expected {json.dumps(want)})")
            # the padded TT1 working copy: every window on the wide path
            wide = {"wide": paths[f"syr2k_{sfx}_wide"],
                    "narrow": paths[f"syr2k_{sfx}_narrow"]}
            checks.check(f"{label} syr2k_{sfx} on the wide path",
                         wide == {"wide": _n_panels(n, TT_W), "narrow": 0},
                         json.dumps(wide))
            # every panel on the cluster kernel
            panels = {p: paths[f"house_panel_{sfx}_{p}"]
                      for p in ("cluster", "cooperative")}
            checks.check(f"{label} house_panel_{sfx} on the cluster kernel, "
                         f"every panel", panels == {
                             "cluster": _n_panels(n, TT_W),
                             "cooperative": 0}, json.dumps(panels))
            # every pass on the band-on-chip kernels
            on_chip = {f"{k} {p}": paths[f"{k}_{sfx}_{p}"] for k, p in (
                ("chase_pass", "cluster"), ("chase_pass", "cooperative"),
                ("replay_pass", "slab"), ("replay_pass", "sweep"))}
            checks.check(f"{label} chase_pass_{sfx} on the cluster kernel and "
                         f"replay_pass_{sfx} on the slab kernel, every pass",
                         on_chip == {"chase_pass cluster": n_pass,
                                     "chase_pass cooperative": 0,
                                     "replay_pass slab": n_pass,
                                     "replay_pass sweep": 0},
                         json.dumps(on_chip))
        elif variant in ("KE", "KI"):
            checks.check(f"{label} launched symm_block_{sfx}",
                         counts[f"symm_block_{sfx}"] > 0,
                         f"{counts[f'symm_block_{sfx}']} launches (n_matvec "
                         f"{res.info['n_matvec']})")
            # the padded operator: every product on the wide path
            wide = {"wide": paths[f"symm_block_{sfx}_wide"],
                    "narrow": paths[f"symm_block_{sfx}_narrow"]}
            checks.check(f"{label} symm_block_{sfx} on the wide path",
                         wide == {"wide": counts[f"symm_block_{sfx}"],
                                  "narrow": 0}, json.dumps(wide))
        out[f"{label} paths"] = paths
        out[label] = counts
        if variant in ("TT", "KE"):
            # phase 4e holds the mesh solves at this level to these
            out[f"{label} result"] = {"evals": res.evals,
                                      "stage_times": dict(res.stage_times)}
        del res
    return out


def fault_drill(checks: Checks, dev, n: int = 1000) -> None:
    """A transient NaN in GS2's input (``NanPoison("GS2", once=True)``)
    through TD on the card under ``on_failure="recover"``: the retry rung
    recovers, the solve is healthy and its info passes ``json.dumps``."""
    import torch
    from repro_torch.core import solve
    from repro_torch.data.problems import md_like
    from repro_torch.resilience.faults import NanPoison, inject

    prob = md_like(n, device=dev)
    fault = NanPoison("GS2", once=True)
    with inject(fault):
        res = solve(prob.A, prob.B, 10, variant="TD", on_failure="recover")
    torch.cuda.synchronize()
    rungs = res.info["recovery"]
    print(f"fault drill (md n={n}, TD, NanPoison('GS2', once=True)): "
          f"{fault.hits} hit, recovery {json.dumps(rungs)}", flush=True)
    checks.check("fault drill transient_retry recovered",
                 bool(rungs) and rungs[-1]["action"] == "transient_retry"
                 and rungs[-1]["outcome"] == "recovered",
                 json.dumps(rungs))
    checks.check("fault drill healthy", bool(res.info["health"]["healthy"]),
                 json.dumps(res.info["health"]["stages"]))
    err = float((res.evals - prob.exact_evals[:10]).abs().max())
    checks.check("fault drill eigenvalues", err <= EVAL_BAR * float(
        prob.exact_evals.abs().max()), f"max error {err!r}")
    checks.check("fault drill info is JSON-clean", bool(json.dumps(res.info)),
                 f"{len(json.dumps(res.info))} bytes")


def _kernel_name(key: str) -> str:
    """``gemm_dmma`` of ``void (anonymous namespace)::gemm_dmma<2, 16,
    true>(double const*, ...)``: the profiler's kernel name, bare."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    name = name.split("<")[0].split()
    return name[-1].split("::")[-1][:32] if name else key[:32]


def profile_stage(label: str, fn) -> None:
    """One call of a stage: host wall clock to the synchronize and the
    host's enqueue time alone, then the device time by kernel over a
    second call under ``torch.profiler`` (CUPTI); "not measured" where
    the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((getattr(ev, "device_time_total", 0.0) / 1e3, ev.count,
                    _kernel_name(ev.key)) for ev in prof.key_averages()),
                  reverse=True)
    device = sum(r[0] for r in rows)
    top = "; ".join(f"{name} {ms:.2f} ms x{count}"
                    for ms, count, name in rows[:5]) if device else \
        "not measured"
    print(f"{label} profile: wall {1e3 * (t2 - t0):.1f} ms, host enqueue "
          f"{1e3 * (t1 - t0):.1f} ms, device {device:.1f} ms: {top}",
          flush=True)


def print_plans(label: str, n: int, s: int, w: int) -> None:
    """The paths a TT solve at (n, s, w) takes: at each level (fp64,
    ``mixed``'s fp32, ``fast``'s bf16), ``chase_plan`` of each TT2 pass and
    ``replay_plan`` of TT4's (n, s) slab at each pass, counted by path and
    cluster size (with the shared memory a CTA takes); and, at each level,
    ``house_plan`` of each TT1 panel (panel p has n - (p+1) w active rows),
    counted by path and cluster size."""
    from collections import Counter

    import torch
    from repro_torch.core.sbr import _executed_passes, _n_panels
    from repro_torch.kernels.house_panel import kernel as hp
    from repro_torch.kernels.rot_apply import kernel as rk
    from repro_torch.kernels.rot_apply.schedule import P_LEFT

    npad = P_LEFT + n + 3 * w + 8
    for level, dt in (("fp64", torch.float64), ("mixed", torch.float32),
                      ("fast", torch.bfloat16)):
        chase, replay, smem = Counter(), Counter(), []
        for b in _executed_passes(n, w):
            cp = rk.chase_plan(
                npad, w, b,
                lambda c, m, dt=dt: rk.cluster_capacity(c, m, dt), dt)
            chase[f"{cp.path} of {cp.csize}" if cp.csize else cp.path] += 1
            smem.append(cp.smem)
            rp = rk.replay_plan(n, s, True, dt, b)
            replay[f"{rp.path} ({rp.ctas} CTAs, 2 table slices of "
                   f"{rp.stage} bytes, {rp.smem} bytes)"] += 1
        print(f"main path {label} plans at {level}: chase_pass "
              + ", ".join(f"{k} x{v}" for k, v in sorted(chase.items()))
              + f" ({min(smem)}-{max(smem)} bytes a CTA); replay_pass "
              + ", ".join(
                  f"{k} x{v}" for k, v in sorted(replay.items())),
              flush=True)
    for level, dt in (("fp64", torch.float64), ("mixed", torch.float32),
                      ("fast", torch.bfloat16)):
        panels, smem = Counter(), []
        for p in range(_n_panels(n, w)):
            plan = hp.house_plan(max(n - (p + 1) * w, 0), w,
                                 hp.cluster_capacity, dt)
            panels[f"{plan.path} of {plan.csize}" if plan.csize
                   else plan.path] += 1
            smem.append(plan.smem)
        print(f"main path {label} plans at {level}: house_panel over "
              f"{sum(panels.values())} panels: " + ", ".join(
                  f"{k} x{v}" for k, v in sorted(panels.items()))
              + f" ({min(smem)}-{max(smem)} bytes a CTA)", flush=True)


def run_solve(label: str, prob, s: int, checks: Checks,
              paths: dict | None = None, **kw):
    """One main-path solve with every launch count set to 0 just before and
    read just after; returns the result (its ``info["kernel_launches"]``
    checked equal to the counts read). The reduced product's and
    ``syr2k``'s launches by load path are printed and, where ``paths`` is given, put in it."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import accuracy_report, solve

    n = prob.A.shape[0]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = solve(prob.A, prob.B, s, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    by_path = kernels.path_counts()
    if paths is not None:
        paths.update(by_path)
    print(f"main path {label}: solve({prob.name} n={n}, s={s}, "
          f"{', '.join(f'{k}={v!r}' for k, v in kw.items())}) {wall:.2f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print("  stage_times_s: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_times.items()}), flush=True)
    if "n_matvec" in res.info:
        print(f"  n_matvec {res.info['n_matvec']}, n_restart "
              f"{res.info['n_restart']}, krylov "
              f"{json.dumps(res.info['krylov'])}", flush=True)
        checks.check(f"{label} converged", bool(res.info["converged"]),
                     f"max resid bound {max(res.info['resid_bounds'])!r}")
    print(f"  launches: {json.dumps(launches)}", flush=True)
    print("  launches by load path: " + json.dumps(
        {k: v for k, v in by_path.items() if v}), flush=True)
    if "tt1" in res.info:
        print(f"  tt1: {json.dumps(res.info['tt1'])}", flush=True)
    acc = accuracy_report(prob.A, prob.B, res.X, res.evals)
    rr, bo = float(acc.relative_residual), float(acc.b_orthogonality)
    checks.check(f"{label} relative_residual", rr <= TABLE3,
                 f"{rr!r} (bar {TABLE3})")
    checks.check(f"{label} b_orthogonality", bo <= TABLE3,
                 f"{bo!r} (bar {TABLE3})")
    exact = prob.exact_evals
    err = float(torch.max(torch.abs(res.evals - exact[:s])))
    scale = float(torch.max(torch.abs(exact)))
    checks.check(f"{label} eigenvalues vs exact spectrum",
                 err <= EVAL_BAR * scale,
                 f"max error {err!r}, bar {EVAL_BAR} * max|lambda| = "
                 f"{EVAL_BAR * scale!r}")
    finite = bool(torch.isfinite(res.X).all() and torch.isfinite(res.evals).all())
    checks.check(f"{label} output shape and finite",
                 finite and tuple(res.X.shape) == (n, s),
                 f"X {tuple(res.X.shape)}, evals {tuple(res.evals.shape)}")
    checks.check(f"{label} health", bool(res.info["health"]["healthy"]),
                 json.dumps(res.info["health"]["stages"]))
    checks.check(f"{label} info is JSON-clean", bool(json.dumps(res.info)),
                 f"{len(json.dumps(res.info))} bytes")
    checks.check(f"{label} info kernel_launches",
                 res.info["kernel_launches"] == launches,
                 json.dumps(res.info["kernel_launches"]))
    return res


# ---- phase 4c: batched buckets and the router --------------------------------

BUCKET_N = 1024          # the serving engine's max_batched_n (its buckets)
BUCKET_BATCH = 8
BUCKET_MD_S = 10         # s/n ~ 1%: the MD ratio (100 / 9997)
BUCKET_DFT_S = 27        # s/n ~ 2.6%: the DFT ratio (448 / 17243)
#: restart budgets of KE and KI at the DFT paper size (never run there
#: before; a run that does not converge within its budget is reported)
DFT_KRYLOV_RESTARTS = {"KE": 40, "KI": 12}


def _bucket_stacks(gen, n: int, batch: int, seed0: int, dev):
    import torch
    probs = [gen(n, seed=seed0 + i, device=dev) for i in range(batch)]
    return (probs, torch.stack([p.A for p in probs]),
            torch.stack([p.B for p in probs]))


def run_bucket(label: str, probs, A, B, s: int, checks: Checks,
               cached: bool = False, **kw) -> dict:
    """One bucket through ``solve_batched`` on the card, cold then warm:
    each pencil against an eager ``solve`` of it at the same level (the
    gap within 1e-10 max|lambda| at fp64, the Table-3 scale 1e-12
    max|lambda| below), the Table-3 bars, converged and healthy, the
    warm call a cache hit with compile_s 0 and (TD/TT) batch x the eager
    launches in its graphs; then the eager loop (whose solves are the
    comparison) and the warm call timed one after the other, and the
    call's span by CUDA events around it (idle gaps included) beside its
    wall. The pipeline cache is emptied after the
    bucket unless ``cached`` (phase 4d serves from the programs left)."""
    import torch
    from repro_torch.core import accuracy_report, batched, solve

    batch, n = A.shape[0], A.shape[1]
    precision = kw.get("precision", "fp64")
    variant = kw["variant"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cold = batched.solve_batched(A, B, s, **kw)
    warm = batched.solve_batched(A, B, s, **kw)
    info = warm.info
    ekw = {k: v for k, v in kw.items() if k != "refine_steps"}

    def loop(keep=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in probs:
            one = solve(p.A, p.B, s, **ekw)
            if keep is not None:
                keep.append(one)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def call():
        return batched.solve_batched(A, B, s, **kw).info["wall_s"]

    # the eager loop, then the warm call; the loop's results are the
    # comparison
    eager: list = []
    walls = [loop(eager), call()]
    checks.check(f"{label} runs as CUDA graphs", info["path"] ==
                 "cuda_graphs" and cold.info["cache_hit"] is False and
                 cold.info["compile_s"] > 0.0,
                 f"path {info['path']}, graphs {info['graphs']}, cold "
                 f"compile_s {cold.info['compile_s']:.3f}")
    checks.check(f"{label} warm call is a cache hit", info["cache_hit"] is
                 True and info["compile_s"] == 0.0,
                 f"cache_hit {info['cache_hit']}, compile_s "
                 f"{info['compile_s']}")
    checks.check(f"{label} converged and healthy",
                 bool(warm.converged.all() and warm.healthy.all()),
                 f"converged {warm.converged.tolist()}, healthy "
                 f"{warm.healthy.tolist()}")
    bar = EVAL_BAR if precision == "fp64" else TABLE3
    gaps, rr, bo = [], [], []
    for i, (p, one) in enumerate(zip(probs, eager)):
        scale = float(p.exact_evals.abs().max())
        gaps.append(float((warm.evals[i] - one.evals).abs().max()) / scale)
        acc = accuracy_report(p.A, p.B, warm.X[i], warm.evals[i])
        rr.append(float(acc.relative_residual))
        bo.append(float(acc.b_orthogonality))
    checks.check(f"{label} eigenvalues vs eager solves", max(gaps) <= bar,
                 f"max gap / max|lambda| {max(gaps)!r} (bar {bar})")
    checks.check(f"{label} Table-3 bars", max(rr) <= TABLE3 and
                 max(bo) <= TABLE3, f"max relative_residual {max(rr)!r}, "
                 f"max b_orthogonality {max(bo)!r} (bar {TABLE3})")
    if variant in ("TD", "TT"):
        want = {k: sum(one.info["kernel_launches"][k] for one in eager)
                for k in info["kernel_launches"]}
        checks.check(f"{label} launches a replay = batch x eager",
                     info["kernel_launches"] == want,
                     json.dumps({k: v for k, v in want.items() if v}))
    else:
        checks.check(f"{label} kernels ran in the graphs",
                     sum(info["kernel_launches"].values()) > 0,
                     f"restarts {info['restarts']}, per replay "
                     f"{json.dumps(info['graph_launches'])}")
    del eager
    loop_s, call_s = walls
    _, span_ms = _time_cuda(lambda: batched.solve_batched(A, B, s, **kw))
    row = {"compile_s": cold.info["compile_s"], "graphs": info["graphs"],
           "wall_s": call_s, "pencils_per_s": batch / call_s,
           "eager_pencils_per_s": batch / loop_s,
           "span_ms": span_ms, "restarts": info.get("restarts"),
           "launches": info["kernel_launches"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"bucket {label} (n={n}, s={s}, batch={batch}): compile_s "
          f"{row['compile_s']:.3f}, graphs {row['graphs']} "
          f"({', '.join(f'{k} x{v}' for k, v in info['graph_replays'].items())}), "
          f"warm wall {1e3 * call_s:.2f} ms = {row['pencils_per_s']:.2f} "
          f"pencils/s; eager loop {1e3 * loop_s:.2f} ms = "
          f"{row['eager_pencils_per_s']:.2f} pencils/s; the call's "
          f"span {span_ms:.2f} ms (CUDA events, idle gaps included); peak "
          f"memory "
          f"{row['peak_gib']:.2f} GiB", flush=True)
    if not cached:
        batched.clear_pipeline_cache()
    return row


def run_buckets(md_paper, checks: Checks, dev) -> dict:
    """Phase 4c's buckets at the engine's size limit (MD and DFT at their
    s/n ratios, batch 8), and TT at the MD paper size, batch 2. The TD
    buckets run last and their programs stay in the pipeline cache, where
    phase 4d's engine finds them."""
    import torch
    from repro_torch.core import batched
    from repro_torch.data.problems import dft_like, md_like

    batched.clear_pipeline_cache()
    rows = {}
    md = _bucket_stacks(md_like, BUCKET_N, BUCKET_BATCH, 700, dev)
    dft = _bucket_stacks(dft_like, BUCKET_N, BUCKET_BATCH, 800, dev)
    krylov = dict(invert=True, use_kernel=True)
    for label, kw in (("TT", dict(variant="TT", band_width=TT_W)),
                      ("KE", dict(variant="KE", **krylov)),
                      ("KI", dict(variant="KI", **krylov)),
                      ("TT mixed", dict(variant="TT", band_width=TT_W,
                                        precision="mixed")),
                      ("KE mixed", dict(variant="KE", precision="mixed",
                                        **krylov))):
        rows[f"MD {label}"] = run_bucket(f"MD {label}", *md, BUCKET_MD_S,
                                         checks, **kw)
    rows["DFT TT"] = run_bucket("DFT TT", *dft, BUCKET_DFT_S, checks,
                                variant="TT", band_width=TT_W)
    # the paper size: TT at MD n=9997, s=100, batch 2
    torch.cuda.empty_cache()
    n = md_paper.A.shape[0]
    probs = [md_paper, md_like(n, seed=n + 1, device=dev)]
    A = torch.stack([p.A for p in probs])
    B = torch.stack([p.B for p in probs])
    rows["MD paper TT"] = run_bucket("MD paper TT", probs, A, B, 100, checks,
                                     variant="TT", band_width=TT_W)
    del probs, A, B
    for name, stacks, s in (("MD", md, BUCKET_MD_S),
                            ("DFT", dft, BUCKET_DFT_S)):
        rows[f"{name} TD"] = run_bucket(f"{name} TD", *stacks, s, checks,
                                        cached=True, variant="TD")
    del md, dft
    torch.cuda.empty_cache()
    return rows


def run_router(md, dft, s_md: int, s_dft: int, measured: dict,
               checks: Checks) -> dict:
    """``solve(variant="auto", machine=MachineParams.h100())`` at MD
    (invert) and DFT (clustered), each held to the bars; the predicted
    stage totals of the four variants beside this run's measured ones;
    whether the MD choice is the measured fastest fp64 variant; KE and KI
    at DFT once each (clustered, their restart budgets); and
    ``from_measurements`` fitted to this run's MD fp64 stage times beside
    ``h100()``."""
    import dataclasses
    import torch
    from repro_torch.analysis.variant_model import (VARIANTS, MachineParams,
                                                    predict_stage_times)
    from repro_torch.core import solve

    h100 = MachineParams.h100()
    out = {}
    auto_md = run_solve("auto MD", md, s_md, checks, variant="auto",
                        machine=h100, invert=True, use_kernel=True)
    out["MD choice"] = auto_md.info["router"]["variant"]
    print(f"  router MD: {json.dumps(auto_md.info['router'])}", flush=True)
    del auto_md
    torch.cuda.empty_cache()
    auto_dft = run_solve("auto DFT", dft, s_dft, checks, variant="auto",
                         machine=h100, clustered=True, use_kernel=True)
    out["DFT choice"] = auto_dft.info["router"]["variant"]
    print(f"  router DFT: {json.dumps(auto_dft.info['router'])}", flush=True)
    del auto_dft
    torch.cuda.empty_cache()
    # KE and KI at DFT, fp64, as the router prices them (clustered)
    for v, budget in DFT_KRYLOV_RESTARTS.items():
        t0 = time.perf_counter()
        r = solve(dft.A, dft.B, s_dft, variant=v, clustered=True,
                  use_kernel=True, max_restarts=budget)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        measured[f"DFT {v}"] = dict(r.stage_times, n_matvec=r.info[
            "n_matvec"])
        print(f"DFT {v} fp64 (clustered, max_restarts={budget}): "
              f"converged {r.info['converged']}, n_matvec "
              f"{r.info['n_matvec']}, n_restart {r.info['n_restart']}, "
              f"{wall:.2f} s; stage_times_s " + json.dumps(
                  {k: round(x, 4) for k, x in r.stage_times.items()}),
              flush=True)
        del r
        torch.cuda.empty_cache()
    for label, n, s, kw in (("MD", md.A.shape[0], s_md, {}),
                            ("DFT", dft.A.shape[0], s_dft,
                             dict(clustered=True))):
        parts = []
        for v in VARIANTS:
            vk = dict(kw, filter_degree=16) if (
                v in ("KE", "KI") and kw) else kw
            pred = predict_stage_times(v, n, s, machine=h100, band_width=TT_W,
                                       **vk)["Tot."]
            meas = measured.get(f"{label} {v}", {}).get("Tot.")
            parts.append(f"{v} predicted {pred:.4f} s, measured "
                         + (f"{meas:.4f} s" if meas is not None
                            else "not measured"))
        print(f"router {label} (h100): " + "; ".join(parts), flush=True)
    fp64 = {v: measured[f"MD {v}"]["Tot."] for v in VARIANTS}
    fastest = min(fp64, key=fp64.get)
    print(f"router MD choice {out['MD choice']} is the measured fastest fp64 "
          f"variant ({fastest}, {json.dumps(fp64)}): "
          f"{out['MD choice'] == fastest}", flush=True)
    out["MD fastest"] = fastest
    records = {"n": md.A.shape[0], "s": s_md, "n_devices": 1, "measured": [
        dict({"variant": v, "stage_times_s": {
            k: x for k, x in measured[f"MD {v}"].items()
            if k not in ("Tot.", "n_matvec")}},
             **({"band_width": TT_W} if v == "TT" else {}),
             **({"n_matvec": measured[f"MD {v}"]["n_matvec"]}
                if v in ("KE", "KI") else {})) for v in VARIANTS]}
    base = dataclasses.replace(h100, t_dispatch=0.0, t_loop_step=0.0)
    fit = MachineParams.from_measurements(records, base=base)
    print("from_measurements (this run, MD fp64): " + json.dumps(
        dataclasses.asdict(fit)) + "; h100(): " + json.dumps(
        dataclasses.asdict(h100)), flush=True)
    return out


# ---- phase 4d: the serving engine -------------------------------------------

ENGINE_REQUESTS = 16     # pencils of each workload in the served stream
ENGINE_DRILL_S = 10


def _served(label: str, reqs, probs: dict, checks: Checks, dev) -> None:
    """Every retired request of ``reqs`` against its pencil: eigenvalues
    within EVAL_BAR max|lambda| of the exact spectrum, the Table-3 bars,
    finite, converged and healthy, ``info`` JSON-clean."""
    import torch
    from repro_torch.core import accuracy_report

    errs, rr, bo, bad = [], [], [], []
    for req in reqs:
        p = probs[req.uid]
        lam = torch.from_numpy(req.evals).to(dev)
        X = torch.from_numpy(req.X).to(dev)
        exact = p.exact_evals[:req.s]
        errs.append(float((lam - exact).abs().max())
                    / float(p.exact_evals.abs().max()))
        acc = accuracy_report(p.A, p.B, X, lam)
        rr.append(float(acc.relative_residual))
        bo.append(float(acc.b_orthogonality))
        if not (req.info.get("converged", True)
                and req.info["health"]["healthy"]
                and tuple(req.X.shape) == (p.A.shape[0], req.s)
                and bool(json.dumps(req.info))):
            bad.append(req.uid)
    checks.check(f"{label} on the exact spectrum", max(errs) <= EVAL_BAR,
                 f"{len(errs)} pencils, max error / max|lambda| "
                 f"{max(errs)!r} (bar {EVAL_BAR})")
    checks.check(f"{label} Table-3 bars", max(rr) <= TABLE3 and
                 max(bo) <= TABLE3, f"max relative_residual {max(rr)!r}, "
                 f"max b_orthogonality {max(bo)!r} (bar {TABLE3})")
    checks.check(f"{label} converged, healthy, (n, s), JSON-clean", not bad,
                 f"failing uids {bad}")


def _print_summary(label: str, eng) -> dict:
    summary = eng.summary()
    print(f"{label} summary: requests {summary['requests']}, dispatches "
          f"{summary['dispatches']}, quarantined {summary['quarantined']}, "
          f"dead letters {summary['dead_letter_uids']}; " + "; ".join(
              f"{name} x{b['count']} mean {b['mean_latency_s']:.4f} s, p90 "
              f"{b['p90_latency_s']:.4f} s"
              for name, b in summary["buckets"].items()), flush=True)
    return summary


def run_engine(md_paper, s_md: int, md_fastest: str, checks: Checks,
               dev) -> dict:
    """Phase 4d: ``EigenEngine`` on the card at its real size.

    (a) a served stream: 16 ``md_like(1024)`` pencils at s=10 and 16
    ``dft_like(1024)`` at s=27, interleaved, ``tick()`` after each submit,
    through ``EigenEngine(slots=8, bucket_shapes=[1024], variant="TD")``:
    two buckets of two dispatches, whose keys are phase 4c's MD and DFT TD
    buckets (their captured programs are still in the pipeline cache);
    each dispatch's cache_hit and compile_s, requests/s, and each
    bucket's mean and p90 latency; every pencil on the exact spectrum and
    the Table-3 bars. (b) The MD paper pencil at its s with ``invert=True``
    in the same engine: the router's direct path, its choice beside phase
    4's measured fastest fp64 variant. (c) The drills at n=1024, s=10: KE
    with ``max_restarts=1`` (both lanes quarantined and recovered) and TT
    with a non-SPD pencil (dead-lettered with ``cholesky_breakdown``, the
    healthy lane retired). Every launch count is set to 0 before (a) and
    read after (c); the TD buckets' replayed graphs launch without passing
    the wrappers, so their launches are read from the ``info`` of each
    ``solve_batched`` call the engine makes. (d) The CLI in a subprocess
    (TT buckets). Returns the launches of (a)-(c)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import batched
    from repro_torch.data.problems import dft_like, md_like
    from repro_torch.resilience.faults import nonspd_pencil
    from repro_torch.serve import eigen_engine
    from repro_torch.serve.eigen_engine import EigenEngine

    s_of = {"md": BUCKET_MD_S, "dft": BUCKET_DFT_S}
    stream = []
    for i in range(ENGINE_REQUESTS):
        for kind, gen in (("md", md_like), ("dft", dft_like)):
            stream.append((kind, gen(BUCKET_N, seed=9000 + 100 * (kind == "dft")
                                     + i, device=dev)))
    torch.cuda.synchronize()
    print(f"pipeline cache before the stream (phase 4c's TD programs): "
          f"{json.dumps(batched.cache_stats())}", flush=True)
    kernels.reset_launches()
    graph_launches = dict.fromkeys(kernels.launch_counts(), 0)
    programs = []     # the info of every solve_batched call of the engine

    def observed(*args, **kw):
        res = batched.solve_batched(*args, **kw)
        programs.append(res.info)
        for k, v in res.info["kernel_launches"].items():
            graph_launches[k] += v
        return res

    eigen_engine.solve_batched = observed
    try:
        eng = EigenEngine(slots=BUCKET_BATCH, bucket_shapes=[BUCKET_N],
                          variant="TD", device=dev)
        probs, dispatches = {}, []
        t0 = time.perf_counter()
        for kind, p in stream:
            uid = eng.submit(p.A, p.B, s_of[kind])
            probs[uid] = p
            before = len(eng.done)
            eng.tick()
            if len(eng.done) > before:
                dispatches.append((kind, eng.done[-1].info))
        eng.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        eigen_engine.solve_batched = batched.solve_batched
    n_req = len(stream)
    del stream
    for kind, info in dispatches:
        print(f"  dispatch {kind.upper()} TD batch {info['batch']}: "
              f"cache_hit {info['cache_hit']}, compile_s "
              f"{info['compile_s']:.3f}, dispatch wall "
              f"{info['dispatch_wall_s']:.4f} s", flush=True)
    hits = [info["cache_hit"] for _, info in dispatches]
    if not all(hits[:2]):
        extra = sum(info["compile_s"] for _, info in dispatches)
        keys = {kind: batched.pipeline_cache_key(
            BUCKET_N, s_of[kind], "TD", "smallest", band_width=eng.band_width,
            max_restarts=eng.max_restarts) for kind in s_of}
        print(f"  the first dispatches missed phase 4c's programs (the "
              f"engine's bucket keys {json.dumps(keys)}); the extra captures "
              f"cost {extra:.3f} s", flush=True)
    rate = n_req / wall
    print(f"engine TD stream: {n_req} requests in {wall:.4f} s = {rate:.4f} "
          f"requests/s", flush=True)
    checks.check("engine stream: every request retired through a bucket",
                 len(eng.done) == n_req and not eng.dead_letters and
                 all(r.info["path"] == "batched" and r.info["batch"] ==
                     BUCKET_BATCH for r in eng.done) and
                 len(dispatches) == 4 and eng.n_quarantined == 0,
                 f"{len(eng.done)} done, {len(dispatches)} dispatches, "
                 f"{eng.n_quarantined} quarantined, "
                 f"{len(eng.dead_letters)} dead letters")
    _served("engine stream", eng.done, probs, checks, dev)
    stream_summary = _print_summary("engine stream", eng)
    # the MD program through an engine and outside it, in turns: the
    # stream's first MD dispatch's pencils and phase 4c's (seeds 700...),
    # to tell the engine's own cost from the program's wall on these
    # pencils (the walls are solve_batched's wall_s)
    md_first = [p for _, p in sorted(probs.items())
                if p.name == "md"][:BUCKET_BATCH]
    sets = {"stream": (torch.stack([p.A for p in md_first]),
                       torch.stack([p.B for p in md_first])),
            "4c": _bucket_stacks(md_like, BUCKET_N, BUCKET_BATCH, 700,
                                 dev)[1:]}
    again = EigenEngine(slots=BUCKET_BATCH, bucket_shapes=[BUCKET_N],
                        variant="TD", device=dev)
    clocks = [_nvidia_smi("clocks.sm,power.draw,temperature.gpu")]
    turns = []
    for name in ("engine", "stream", "4c", "4c", "stream", "engine"):
        if name == "engine":
            for p in md_first:
                again.submit(p.A, p.B, BUCKET_MD_S)
            again.tick()
            info = again.done[-1].info
            turns.append(f"engine {info['dispatch_wall_s']:.4f} s (cache_hit"
                         f" {info['cache_hit']})")
            continue
        A, B = sets[name]
        r = batched.solve_batched(A, B, BUCKET_MD_S, variant="TD",
                                  device=dev)
        turns.append(f"{name} {r.info['wall_s']:.4f} s (cache_hit "
                     f"{r.info['cache_hit']})")
    clocks.append(_nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    del sets, A, B, r, again
    print(f"MD TD program in turns, through an engine (the stream's first "
          f"MD pencils) and outside it (those, and phase 4c's): "
          f"{', '.join(turns)}; sum of the stream's dispatch walls "
          f"{sum(i['dispatch_wall_s'] for _, i in dispatches):.4f} s of "
          f"{wall:.4f}; nvidia-smi clocks.sm, power.draw, temperature "
          f"before and after the turns: {clocks[0]} / {clocks[1]}",
          flush=True)
    checks.check("engine TD buckets replayed their graphs",
                 len(programs) == len(dispatches) and
                 all(i["path"] == "cuda_graphs" and
                     i["graph_replays"] == {"direct": 1} for i in programs),
                 "; ".join(f"path {i['path']}, replays "
                           f"{json.dumps(i['graph_replays'])}"
                           for i in programs))
    # (b) the router path: the MD paper pencil, oversized for a bucket
    n_md = md_paper.A.shape[0]
    uid = eng.submit(md_paper.A, md_paper.B, s_md, invert=True)
    probs[uid] = md_paper
    eng.run_until_drained()
    req = {r.uid: r for r in eng.done}.get(uid)
    ok = req is not None and req.info["path"] == "direct"
    checks.check(f"engine MD n={n_md} through the router's direct path",
                 ok and "router" in req.info,
                 "path " + (req.info["path"] if req is not None else
                            "none") + (f", router {json.dumps(req.info['router'])}"
                                       if ok and "router" in req.info else ""))
    choice = req.info["router"]["variant"] if ok else None
    if ok:
        _served(f"engine MD n={n_md} direct", [req], probs, checks, dev)
        print(f"  router (engine, default MachineParams) chose {choice} "
              f"at MD n={n_md}, s={s_md}, invert; latency "
              f"{req.info['latency_s']:.4f} s, stage_times_s "
              + json.dumps({k: round(v, 4) for k, v in
                            req.info["stage_times"].items()})
              + f"; phase 4's measured fastest fp64 variant: {md_fastest} "
              f"({choice == md_fastest})", flush=True)
    # drop the stream's programs before the drills
    batched.clear_pipeline_cache()
    del eng, probs
    torch.cuda.empty_cache()

    # (c) the drills at n=1024, s=10
    drill = {}
    q = EigenEngine(slots=2, bucket_shapes=[BUCKET_N], variant="KE",
                    max_restarts=1, device=dev)
    for i in range(2):
        p = md_like(BUCKET_N, seed=9500 + i, device=dev)
        drill[q.submit(p.A, p.B, ENGINE_DRILL_S, invert=True)] = p
    q.run_until_drained()
    qs = _print_summary("quarantine drill (KE, max_restarts=1)", q)
    for r in q.done:
        print(f"  uid {r.uid}: path {r.info['path']}, variant "
              f"{r.info['variant']}, attempts {r.info.get('attempts')}, "
              f"recovery {[x['action'] for x in r.info['recovery']]}",
              flush=True)
    checks.check("quarantine drill: both lanes quarantined and retired",
                 qs["quarantined"] == 2 and not q.dead_letters and
                 len(q.done) == 2 and all(r.info["path"] == "quarantine"
                                          for r in q.done),
                 json.dumps({k: qs[k] for k in ("quarantined", "dispatches",
                                                "dead_letter_uids")}))
    if q.done:
        _served("quarantine drill", q.done, drill, checks, dev)
    del q
    drill = {}
    d = EigenEngine(slots=2, bucket_shapes=[BUCKET_N], variant="TT",
                    max_retries=1, device=dev)
    good = md_like(BUCKET_N, seed=9600, device=dev)
    uid_good = d.submit(good.A, good.B, ENGINE_DRILL_S)
    drill[uid_good] = good
    A_bad, B_bad = nonspd_pencil(BUCKET_N)
    uid_bad = d.submit(A_bad, B_bad, ENGINE_DRILL_S)
    d.run_until_drained()
    ds = _print_summary("dead-letter drill (TT, non-SPD)", d)
    dead = d.dead_letters[0] if d.dead_letters else None
    clean = True
    for r in d.done + d.dead_letters:
        try:
            json.dumps(r.info)
        except (TypeError, ValueError):
            clean = False
    checks.check("dead-letter drill: the bad uid dead-lettered with "
                 "cholesky_breakdown, the good one retired",
                 [r.uid for r in d.dead_letters] == [uid_bad] and
                 dead.info["dead_letter"]["reason"] == "cholesky_breakdown"
                 and [r.uid for r in d.done] == [uid_good] and
                 d.done[0].info["path"] == "batched" and clean,
                 json.dumps({"dead_letter_uids": ds["dead_letter_uids"],
                             "dead_letter": dead.info["dead_letter"]
                             if dead is not None else None,
                             "done": [r.uid for r in d.done],
                             "json_clean": clean})[:600])
    if d.done:
        _served("dead-letter drill good lane", d.done, drill, checks, dev)
    del d, drill, good
    batched.clear_pipeline_cache()
    torch.cuda.synchronize()
    wrapped = kernels.launch_counts()
    launches = {k: wrapped[k] + graph_launches[k] for k in wrapped}
    print(f"phase 4d launches through the wrappers: "
          f"{json.dumps({k: v for k, v in wrapped.items() if v})}; in the "
          f"TD buckets' replayed graphs: "
          f"{json.dumps({k: v for k, v in graph_launches.items() if v})}",
          flush=True)
    for name in ("bisect_sturm", "invit"):
        checks.check(f"engine TD stream launched {name} (graphs)",
                     graph_launches[name] > 0,
                     f"{graph_launches[name]} launches")
    for name in ("bisect_sturm", "invit", "house_panel", "syr2k",
                 "chase_pass", "replay_pass"):
        checks.check(f"phase 4d launched {name}", launches[name] > 0,
                     f"{launches[name]} launches")
    torch.cuda.empty_cache()

    # (d) the CLI, as a user runs it (its own process)
    cmd = [sys.executable, "-m", "repro_torch.launch.eigenserve",
           "--slots", str(BUCKET_BATCH), "--bucket-shapes", str(BUCKET_N),
           "--max-batched-n", str(BUCKET_N), "--requests",
           str(ENGINE_REQUESTS), "--stream", "mixed", "--s",
           str(BUCKET_MD_S), "--variant", "TT", "--band-width", str(TT_W),
           "--device", dev.type, "--json"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=str(ROOT), timeout=600)
        rc, stdout, stderr = out.returncode, out.stdout, out.stderr
    except subprocess.TimeoutExpired as err:
        rc, stdout, stderr = None, str(err.stdout), "timed out"
    cli_s = time.perf_counter() - t0
    said_ok = stdout.rstrip().endswith("eigenserve OK")
    cli = {}
    if said_ok:
        cli = json.loads(stdout[:stdout.rindex("eigenserve OK")])
        print(f"CLI ({' '.join(cmd[1:])}): {cli_s:.1f} s in all; "
              f"requests_per_s {cli['requests_per_s']}, wall_s "
              f"{cli['wall_s']}, max_abs_eval_error "
              f"{cli['max_abs_eval_error']!r}, summary "
              f"{json.dumps(cli['summary'])}", flush=True)
    checks.check("CLI exits 0 and prints eigenserve OK", rc == 0 and said_ok,
                 f"exit {rc}; " + (stdout[-300:] + stderr[-900:]
                                   if not (rc == 0 and said_ok) else
                                   f"{len(stdout)} bytes of output"))
    # MD and DFT at one n and s share a TT bucket (no invert outside
    # KE/KI): two full dispatches of it
    summary = cli.get("summary", {})
    buckets = summary.get("buckets", {})
    checks.check("CLI served its stream in full TT buckets",
                 summary.get("requests") == ENGINE_REQUESTS and
                 summary.get("dispatches") == ENGINE_REQUESTS // BUCKET_BATCH
                 and sum(b["count"] for b in buckets.values()) ==
                 ENGINE_REQUESTS and all(name.endswith("_TT")
                                         for name in buckets),
                 json.dumps(summary))
    return {"launches": launches, "requests_per_s": rate,
            "summary": stream_summary, "router": choice,
            "cli_requests_per_s": cli.get("requests_per_s")}


# ---- phase 4e: the distribution layer -----------------------------------------

#: phase 4e's mesh: one rank on this card, on NCCL
MESH_SHAPE = (1, 1)


def _mesh_solves(mesh, md, s: int, single: dict, checks: Checks) -> dict:
    """Phase 4e inside the one rank of ``run_local``'s NCCL world: KE
    (invert, p=4) and TT (w=16) through ``solve(mesh=)`` at fp64 and
    mixed, each through ``run_solve`` (Table-3 bars, exact spectrum,
    launches) and against phase 4/4b's single-device solve at its level;
    then the preemption drill. Returns the launches by wrapper."""
    import tempfile

    import torch
    from repro_torch.core import solve
    from repro_torch.core.sbr import _executed_passes, _n_panels
    from repro_torch.dist.eigensolver import solve_ke_distributed
    from repro_torch.resilience.faults import SimulatedPreemption

    n = md.A.shape[0]
    scale = float(md.exact_evals.abs().max())
    launches: dict = {}
    mesh_ke = None
    for variant, level in (("KE", "fp64"), ("TT", "fp64"), ("KE", "mixed"),
                           ("TT", "mixed")):
        label = f"mesh {MESH_SHAPE} {variant} {level}"
        kw = (dict(variant="KE", invert=True) if variant == "KE"
              else dict(variant="TT", band_width=TT_W))
        if level != "fp64":
            kw.update(precision=level, on_failure="recover")
        res = run_solve(label, md, s, checks, mesh=mesh, **kw)
        ref = single[f"{variant} {level}"]
        gap = float((res.evals - ref["evals"]).abs().max())
        checks.check(f"{label} eigenvalues vs the single-device solve",
                     gap <= EVAL_BAR * scale,
                     f"max gap {gap!r}, bar {EVAL_BAR} * max|lambda| = "
                     f"{EVAL_BAR * scale!r}")
        st = res.stage_times
        print(f"  stages, s (mesh / single-device): " + ", ".join(
            f"{k} {st.get(k, 0.0):.4f} / {ref['stage_times'].get(k, 0.0):.4f}"
            for k in dict.fromkeys(list(st) + list(ref["stage_times"]))),
            flush=True)
        print(f"  collectives: {json.dumps(res.info['collectives'])}",
              flush=True)
        if level != "fp64":
            rinfo = res.info["refinement"]
            print(f"  refinement: steps {rinfo['steps']}, converged "
                  f"{rinfo['converged']}, stalled {rinfo['stalled']}; "
                  f"recovery {[(r['action'], r['outcome']) for r in res.info['recovery']]}",
                  flush=True)
        counts = res.info["kernel_launches"]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if variant == "TT":
            sfx = "" if level == "fp64" else "_fp32"
            n_pass = len(_executed_passes(n, TT_W))
            want = {f"house_panel{sfx}": _n_panels(n, TT_W),
                    f"chase_pass{sfx}": n_pass,
                    f"replay_pass{sfx}": n_pass, "bisect_sturm": 1,
                    "invit": 6}
            got = {k: counts[k] for k in want}
            checks.check(f"{label} launch counts", got == want,
                         f"{json.dumps(got)} (expected {json.dumps(want)})")
        elif level == "fp64":
            mesh_ke = res.evals
        else:
            # the mixed level's own attempt, not checked: its refinement
            # trajectory (a stall is what the recover ladder escalates)
            own = solve(md.A, md.B, s, mesh=mesh, **dict(
                kw, on_failure="warn"))
            rinfo = own.info["refinement"]
            print(f"  {label} with on_failure='warn' (not checked): "
                  f"n_restart {own.info['n_restart']}, max resid bound "
                  f"{max(own.info['resid_bounds']):.3e}, KE_iter "
                  f"{own.stage_times['KE_iter']:.4f} s, refinement steps "
                  f"{rinfo['steps']}, converged {rinfo['converged']}, "
                  f"stalled {rinfo['stalled']}, relative_residual "
                  f"{[float(f'{x:.3e}') for x in rinfo['relative_residual']]}",
                  flush=True)
            del own
        del res
    # a KE block step's two collectives on this mesh's groups, against the
    # tile product they follow
    from repro_torch.dist.mesh import tiling
    tl = tiling(mesh)
    X = torch.randn((n, 4), dtype=torch.float64, device=md.A.device,
                    generator=torch.Generator(device=md.A.device).manual_seed(5))
    runs = {"all_reduce + all_gather": lambda: tl.all_gather(
                tl.all_reduce(X, tl.model_group, kind="timing"), tl.row_group,
                kind="timing"),
            "tile product (n x n) @ (n, 4)": lambda: md.A @ X}
    parts: dict = {}
    for _ in range(2):
        for name, fn in runs.items():
            parts.setdefault(name, []).append((_host_ms(fn, 50),
                                               _queued_ms(fn, 50)))
    print("mesh block step by part, ms a call (host enqueue / device "
          "queued, two rounds in turns): " + "; ".join(
              f"{k} " + ", ".join(f"{h:.4f} / {d:.4f}" for h, d in v)
              for k, v in parts.items()), flush=True)
    # the drill: preempt after 2 restarts, resume from the checkpoint
    with tempfile.TemporaryDirectory(prefix="ke_ckpt_") as ck:
        t0 = time.perf_counter()
        try:
            solve_ke_distributed(mesh, md.A, md.B, s, invert=True,
                                 checkpoint_dir=ck, preempt_after=2,
                                 return_info=True)
            at = None
        except SimulatedPreemption as err:
            at = err.at_restart
        t1 = time.perf_counter()
        lam, X, info = solve_ke_distributed(mesh, md.A, md.B, s, invert=True,
                                            checkpoint_dir=ck, resume=True,
                                            return_info=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    ck_info = info["checkpoint"]
    print(f"mesh drill: preempted at restart {at} ({t1 - t0:.2f} s), resumed "
          f"from {info.get('resumed_from')} to n_restart {info['n_restart']} "
          f"({t2 - t1:.2f} s); checkpoint {ck_info['bytes']} bytes a save, "
          f"{ck_info['saves']} saves in {ck_info['save_s']:.3f} s "
          f"({ck_info['save_s'] / max(ck_info['saves'], 1) * 1e3:.1f} ms a "
          f"save)", flush=True)
    checks.check("mesh drill preempted", at == 1, f"at restart {at}")
    gap = float((lam - mesh_ke).abs().max())
    checks.check("mesh drill resumed to parity",
                 info.get("resumed_from", -1) >= 0 and info["healthy"]
                 and info["converged"] and gap <= 1e-12 * scale,
                 f"resumed_from {info.get('resumed_from')}, max gap {gap!r} "
                 f"(bar 1e-12 * max|lambda|)")
    return {"launches": launches}


def run_mesh(md, s: int, single: dict, checks: Checks) -> dict:
    """Phase 4e: ``_mesh_solves`` in a one-rank NCCL world on this card
    (``dist.launcher.run_local``, which destroys the process group after);
    prints and checks the launches by wrapper over the mesh solves."""
    from repro_torch.dist.launcher import run_local
    import torch

    out = run_local(_mesh_solves, MESH_SHAPE, "cuda", md, s, single, checks)
    print(f"phase 4e launches through the wrappers: "
          f"{json.dumps({k: v for k, v in out['launches'].items() if v})}",
          flush=True)
    for name in ("house_panel", "house_panel_fp32", "chase_pass",
                 "chase_pass_fp32", "replay_pass", "replay_pass_fp32",
                 "bisect_sturm", "invit"):
        checks.check(f"phase 4e launched {name}",
                     out["launches"].get(name, 0) > 0,
                     f"{out['launches'].get(name, 0)} launches")
    checks.check("phase 4e left no process group",
                 not torch.distributed.is_initialized(), "destroyed")
    return out


# ---- phase 4f: the audit ---------------------------------------------------

#: the instances phase 4f's buckets reach below fp64 (TT mixed and fast,
#: the Krylov buckets' product)
AUDIT_REDUCED = tuple(f"{k}_{sfx}" for sfx in ("fp32", "bf16")
                      for k in ("house_panel", "syr2k", "chase_pass",
                                "replay_pass", "symm_block"))


def run_audit_phase(checks: Checks) -> dict:
    """Phase 4f: ``run_audit`` on the card, the mesh entries on phase 4e's
    (1, 1) NCCL mesh. Every entry's contract and its recorded kernel calls
    against the launch deltas are checks; returns the launches by
    instance over every audited program."""
    from repro_torch.launch.audit import print_human, run_audit

    payload = run_audit(device="cuda", mesh_shape=MESH_SHAPE)
    print_human(payload)
    launches: dict = {}
    for e in payload["entries"]:
        checks.check(f"audit {e['name']}", e["ok"] and not e["skipped"],
                     "; ".join(e["violations"]) or
                     ("skipped" if e["skipped"] else "contract met"))
        for prog in e["programs"] + e["probes"]:
            checks.check(f"audit {e['name']}/{prog['name']} recorded calls "
                         f"equal launches",
                         prog["kernel_calls"] == prog["launches"],
                         f"recorded {json.dumps(prog['kernel_calls'])}, "
                         f"launched {json.dumps(prog['launches'])}")
            for k, v in prog["launches"].items():
                launches[k] = launches.get(k, 0) + v
    checks.check("audit payload ok", payload["ok"],
                 json.dumps(payload["summary"]))
    for c in payload["crosscheck"]:
        checks.check(f"audit cross-check {c['stage']}.{c['field']}", c["ok"],
                     f"model {c['model_value']!r} vs counted "
                     f"{c['counted_value']!r} ({c['relation']})")
    for name in KERNEL_ORDER[:12] + AUDIT_REDUCED:
        checks.check(f"phase 4f launched {name}", launches.get(name, 0) > 0,
                     f"{launches.get(name, 0)} launches on audited paths")
    print("audit dispatch drift (model dispatches a stage / counted "
          "launches / stage entries): " + "; ".join(
              f"{d['stage']} {d['model_dispatches']:g} / "
              f"{d['counted_launches']} / {json.dumps(d['stage_entries'])}"
              for d in payload["dispatch_drift"]), flush=True)
    print(f"audit profiled seconds: {payload['summary']['seconds']:.2f}",
          flush=True)
    return {"launches": launches}


# ---- phase 4g: the LM serving path --------------------------------------------

LM_REL = 1e-4            # fp32 logits on the card vs the host, / max|logit|
LM_PREFILL = 2e-3        # decode vs prefill (rtol and atol), as the reference
INT8_ERR = 0.05          # int8 vs compute KV cache: max|dlogit| / max|logit|
INT8_AGREE = 0.9         # ... and the share of equal greedy tokens
LM_SLOTS = 4             # the engine's batch at full width
LM_CAPACITY = 1024       # the engine's cache capacity (global layers' ring)
LM_NEW = 32              # new tokens a request
#: the 8 requests' prompt lengths (one past the 512-slot local rings) and
#: the tick each is submitted at: 4 at once, then one every 20 ticks, each
#: admitted as a slot frees
LM_PROMPTS = (600, 8, 64, 16, 40, 24, 12, 56)
LM_SUBMIT_AT = (0, 0, 0, 0, 20, 40, 60, 80)
#: rerun solo: the long request and one admitted into a freed slot
LM_SOLO = (0, 5)
LM_WINDOW = 20           # ticks a timed window


def _rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


def _lm_decode(lm, params, cfg, toks, state):
    """Logits (B, T, V) of feeding ``toks`` (B, T) one step at a time."""
    import torch
    outs = []
    for t in range(toks.shape[1]):
        logits, state = lm.decode_step(params, toks[:, t:t + 1], state, cfg)
        outs.append(logits)
    return torch.cat(outs, dim=1)


def _lm_smoke(checks: Checks, dev) -> None:
    """(a) every smoke config at fp32: 8 decode steps on the card against
    the host from the same weights, and decode against prefill on the
    card."""
    import torch
    from repro_torch.configs import ARCH_IDS, smoke_config
    from repro_torch.models import model as lm

    B, T = 2, 8
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = smoke_config(arch)
        params = lm.init_params(0, cfg, device=dev)
        host = lm.LM(cfg, device="cpu")
        host.load_state_dict(params.state_dict())
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
        mem_d = mem_h = None
        with torch.no_grad():
            if cfg.encoder_decoder:
                emb = torch.randn((B, T, cfg.d_model), generator=gen)
                mem_d = lm.encode(params, emb.to(dev), cfg)
                mem_h = lm.encode(host, emb, cfg)
            full, _ = lm.forward(params, toks.to(dev), cfg, memory=mem_d)
        dec_d = _lm_decode(lm, params, cfg, toks.to(dev), lm.init_decode_state(
            cfg, B, capacity=2 * T, memory=mem_d, device=dev))
        dec_h = _lm_decode(lm, host, cfg, toks, lm.init_decode_state(
            cfg, B, capacity=2 * T, memory=mem_h, device="cpu"))
        err = _rel_err(dec_d, dec_h)
        checks.check(f"LM {arch} smoke: {T} decode steps, card vs host",
                     err <= LM_REL, f"max|d logit| / max|logit| = {err!r}, "
                     f"bar {LM_REL}")
        gap = float((dec_d - full).abs().max())
        ok = bool(torch.allclose(dec_d, full, rtol=LM_PREFILL,
                                 atol=LM_PREFILL))
        checks.check(f"LM {arch} smoke: decode vs prefill on the card", ok,
                     f"max|decode - prefill| = {gap!r} (rtol = atol = "
                     f"{LM_PREFILL}); {time.perf_counter() - t0:.2f} s")


def _lm_setup(dev):
    """gemma3-1b's config, its weights drawn on ``dev`` from seed 0 (the
    same values in every process on the card), their checksum and the 8
    prompts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    cfg = get_config("gemma3-1b")
    params = lm.init_params(0, cfg, device=dev)
    checksum = [float(p.detach().sum()) for p in params.parameters()]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in LM_PROMPTS]
    return cfg, params, checksum, prompts


def _lm_solo(cfg, params, prompt, dev) -> list:
    """``prompt``'s tokens served alone in an engine of ``LM_SLOTS``."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                      capacity=LM_CAPACITY, device=dev)
    eng.submit(prompt, max_new_tokens=LM_NEW)
    (r,) = eng.run_until_drained()
    return r.output


def lm_solo_main(device: str) -> int:
    """The solo reruns of phase 4g (b), in a process of their own so that
    they run beside the staggered run: prints one JSON line, the weights'
    checksum and each rerun's tokens."""
    import torch
    dev = torch.device(device)
    cfg, params, checksum, prompts = _lm_setup(dev)
    out = {str(i): _lm_solo(cfg, params, prompts[i], dev) for i in LM_SOLO}
    print(json.dumps({"checksum": checksum, "outputs": out}), flush=True)
    return 0


def _spawn(cmd, label: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    print(f"{label}: started ({' '.join(cmd[1:])[:120]})", flush=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))


def _collect(proc, timeout: float):
    """(exit code or None on a timeout, stdout, stderr); a process still
    running at the timeout is killed."""
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return None, out, "timed out\n" + err


def _engine_run(eng, prompts, submit_at):
    """Submit ``prompts[i]`` at tick ``submit_at[i]`` and tick until
    drained. Returns the done requests by uid, the ticks and the uids by
    prompt."""
    uids, tick = {}, 0
    while True:
        for i, at in enumerate(submit_at):
            if at == tick:
                uids[i] = eng.submit(prompts[i], max_new_tokens=LM_NEW)
        if (len(uids) == len(prompts) and not eng.queue
                and all(s.free for s in eng.slots)):
            break
        eng.tick()
        tick += 1
    return {r.uid: r for r in eng.done}, tick, uids


def _timed_ticks(eng, n: int) -> list:
    """Host ms of ``n`` ticks, each ending in the argmax's copy to the
    host."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.tick()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _tick_profile(eng, ticks: int) -> dict:
    """``ticks`` engine ticks under ``torch.profiler`` (CUDA activity):
    the wall, the device time, the kernel launches (copies and memsets
    apart) and the device's idle share, with the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(getattr(ev, "device_time_total", 0.0) / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows
                   if not r[2].startswith(("Memcpy", "Memset")))
    return {"wall_ms": wall, "device_ms": device,
            "launches_per_tick": launches / ticks,
            "idle_share": 1.0 - device / wall if device else None,
            "top": "; ".join(f"{_kernel_name(k)} {ms:.2f} ms x{n}"
                             for ms, n, k in rows[:5])}


def _lm_full_width(checks: Checks, dev, solo_proc) -> dict:
    """(b) gemma3-1b at full width: the fp32 forward on the card against
    the host, the bf16 engine (4 slots, 8 requests, staggered admissions,
    one 600-token prompt), its solo reruns (``solo_proc``, running beside
    it), the int8 KV cache, then the timed and profiled windows."""
    import numpy as np
    import torch
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServeEngine

    checks.check("fp32 matmuls are fp32 (no TF32)",
                 not torch.backends.cuda.matmul.allow_tf32
                 and torch.get_float32_matmul_precision() == "highest",
                 f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
                 f"precision {torch.get_float32_matmul_precision()}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()    # what earlier phases still hold
    t0 = time.perf_counter()
    cfg, params, checksum, prompts = _lm_setup(dev)
    n_par = sum(p.numel() for p in params.parameters())
    print(f"gemma3-1b: {cfg.n_layers} layers {cfg.layer_kinds()[:6]}..., "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}; {n_par} parameters "
          f"({4 * n_par / 1e9:.3f} GB f32), param_count() "
          f"{cfg.param_count()}; drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 1. a 16-token fp32 forward, card against host
    cfg32 = cfg.scaled(dtype="float32")
    t0 = time.perf_counter()
    host = lm.LM(cfg32, device="cpu")
    host.load_state_dict(params.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        on_card, _ = lm.forward(params, toks.to(dev), cfg32)
        on_host, _ = lm.forward(host, toks, cfg32)
    del host
    err = _rel_err(on_card, on_host)
    checks.check("gemma3-1b 16-token fp32 forward, card vs host",
                 err <= LM_REL and tuple(on_card.shape) == (
                     1, 16, cfg.vocab_size)
                 and bool(torch.isfinite(on_card).all()),
                 f"max|d logit| / max|logit| = {err!r}, bar {LM_REL}; "
                 f"{time.perf_counter() - t0:.1f} s with the host copy")
    del on_card, on_host

    # 2. the bf16 engine: 8 requests, staggered, one past the local rings
    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                      capacity=LM_CAPACITY, device=dev)
    t0 = time.perf_counter()
    done, n_ticks, uids = _engine_run(eng, prompts, LM_SUBMIT_AT)
    wall = time.perf_counter() - t0
    outs = {i: done[u].output for i, u in uids.items()}
    checks.check("gemma3-1b engine served every request",
                 sorted(outs) == list(range(len(prompts))) and all(
                     len(o) == LM_NEW for o in outs.values()),
                 f"{len(done)} done in {n_ticks} ticks, {wall:.2f} s (the "
                 f"solo reruns' process beside it)")
    checks.check("gemma3-1b tokens in range",
                 all(0 <= t < cfg.vocab_size for o in outs.values()
                     for t in o), f"{sum(map(len, outs.values()))} tokens")

    # 3. int8 KV against the bf16 cache on a short decode
    cfg8 = cfg.scaled(kv_cache_dtype="int8")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    lf = _lm_decode(lm, params, cfg, toks, lm.init_decode_state(
        cfg, 2, capacity=64, device=dev))
    st8 = lm.init_decode_state(cfg8, 2, capacity=64, device=dev)
    lq = _lm_decode(lm, params, cfg8, toks, st8)
    err = _rel_err(lq, lf)
    agree = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
    checks.check("gemma3-1b int8 KV vs bf16 KV, 16 decode steps",
                 err < INT8_ERR and agree >= INT8_AGREE
                 and st8.caches[0].k.dtype == torch.int8,
                 f"max|d logit| / max|logit| = {err!r} (bar {INT8_ERR}), "
                 f"greedy agreement {agree} (bar {INT8_AGREE})")

    # 4. the solo reruns: the same weights, the same tokens
    t0 = time.perf_counter()
    rc, out, err_ = _collect(solo_proc, timeout=900)
    solo = {}
    if rc == 0 and out.strip():
        solo = json.loads(out.strip().splitlines()[-1])
    checks.check("gemma3-1b solo process drew the same weights",
                 solo.get("checksum") == checksum,
                 f"exit {rc}, waited {time.perf_counter() - t0:.1f} s "
                 f"after the staggered run; " + (
                     f"{len(checksum)} parameter sums equal" if solo
                     else err_[-900:]))
    for i in LM_SOLO:
        got = solo.get("outputs", {}).get(str(i))
        checks.check(f"gemma3-1b request {i} (prompt {LM_PROMPTS[i]}) solo "
                     f"equals its staggered run", got == outs[i],
                     f"first tokens {None if got is None else got[:6]} vs "
                     f"{outs[i][:6]}")

    # 5. timed, then profiled: 4 busy slots, the card otherwise idle, the
    # profiler last (its hooks can slow the launches after it)
    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                      capacity=LM_CAPACITY, device=dev)
    for _ in range(LM_SLOTS):
        eng.submit(prompts[1], max_new_tokens=2 * LM_NEW)
    prefill = _timed_ticks(eng, LM_PROMPTS[1])   # every slot prefilling
    decode = _timed_ticks(eng, LM_WINDOW)        # every slot generating
    prof = _tick_profile(eng, LM_WINDOW)
    tick_ms = float(np.median(decode))
    pre_ms = float(np.median(prefill[1:])) / LM_SLOTS
    print(f"gemma3-1b engine (bf16, {LM_SLOTS} slots, capacity "
          f"{LM_CAPACITY}): decode ms per tick at B={LM_SLOTS} median "
          f"{tick_ms:.3f} (min {min(decode):.3f}, max {max(decode):.3f}, "
          f"{LM_WINDOW} ticks) = {1e3 * LM_SLOTS / tick_ms:.1f} tokens/s; "
          f"prefill-by-decode {pre_ms:.3f} ms per prompt token ({LM_SLOTS} "
          f"slots prefilling, median tick / {LM_SLOTS}); the staggered "
          f"run: {n_ticks} ticks in {wall:.2f} s "
          f"({1e3 * wall / n_ticks:.3f} ms a tick beside the solo "
          f"process)", flush=True)
    print(f"gemma3-1b tick profile ({LM_WINDOW} ticks at B={LM_SLOTS}, "
          f"torch.profiler): wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms, idle share "
          + ("not measured" if prof["idle_share"] is None
             else f"{prof['idle_share']:.4f}")
          + f", kernel launches a tick {prof['launches_per_tick']:.1f}; "
          f"{prof['top']}", flush=True)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"gemma3-1b peak memory allocated: {peak:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before the phase", flush=True)
    return {"ms_per_tick": tick_ms, "prefill_ms_per_token": pre_ms,
            "peak_gib": peak, **prof}


def _lm_cli_check(checks: Checks, proc, cmd, t_start: float) -> None:
    """(c) the CLI's process, started with the phase: exit 0 and
    ``serve OK``."""
    rc, stdout, stderr = _collect(proc, timeout=600)
    said_ok = stdout.rstrip().endswith("serve OK")
    print(f"CLI ({' '.join(cmd[1:])}): done {time.perf_counter() - t_start:.1f}"
          f" s after its start; " + " | ".join(stdout.strip().splitlines()[:3]),
          flush=True)
    checks.check("LM CLI exits 0 and prints serve OK", rc == 0 and said_ok,
                 f"exit {rc}; " + (stdout[-300:] + stderr[-900:]
                                   if not (rc == 0 and said_ok) else
                                   f"{len(stdout)} bytes of output"))


def run_lm(checks: Checks, dev) -> dict:
    """Phase 4g: the LM serving path on the card, (a) every smoke config,
    (b) gemma3-1b at full width, (c) the CLI; the table's kernels launched
    on it, counted from 0 (none: the LM path runs no kernel of the
    table). The CLI and (b)'s solo reruns run in processes of their own
    beside the rest: the tick is host-bound and the card mostly idle."""
    import torch
    from repro_torch import kernels

    kernels.reset_launches()
    t_start = time.perf_counter()
    cli_cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "gemma3-1b", "--batch", "4", "--prompt-len", "32", "--gen",
               "32", "--device", dev.type]
    procs = [_spawn(cli_cmd, "LM CLI"),
             _spawn([sys.executable, "-c", "import sys, chip_smoke; "
                     f"sys.exit(chip_smoke.lm_solo_main({dev.type!r}))"],
                    "gemma3-1b solo reruns")]
    try:
        _lm_smoke(checks, dev)
        print(f"phase 4g (a): {time.perf_counter() - t_start:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        full = _lm_full_width(checks, dev, procs[1])
        torch.cuda.empty_cache()
        print(f"phase 4g (b): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        _lm_cli_check(checks, procs[0], cli_cmd, t_start)
        print(f"phase 4g (c): {time.perf_counter() - t0:.1f} s more",
              flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    checks.check("phase 4g launched no kernel of the table", not launches,
                 json.dumps(launches))
    return full


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--md-n", type=int, default=9997)
    ap.add_argument("--md-s", type=int, default=100)
    ap.add_argument("--dft-n", type=int, default=17243)
    ap.add_argument("--dft-s", type=int, default=448)
    ap.add_argument("--wide-n", type=int, default=17243)
    ap.add_argument("--chase-n", type=int, default=512,
                    help="n of the MD pencil the chase and replay kernels "
                         "are compared at (the plain chase is a host loop)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels
        from repro_torch.core import ExplicitC, apply_op, solve
        from repro_torch.core.cholesky import cholesky_blocked, cholesky_upper
        from repro_torch.core.linalg_utils import wy_syr2k_panel
        from repro_torch.core.sbr import (_chunk_bounds, _executed_passes,
                                          _n_panels, band_chase,
                                          default_n_chunks, reduce_to_band)
        from repro_torch.core.band_storage import to_band_mv_layout
        from repro_torch.kernels.band_mv import ops as band_mv_ops
        from repro_torch.kernels.gemm import kernel as gemm_kernel
        from repro_torch.kernels.gemm import ops as gemm_ops
        from repro_torch.kernels.rot_apply import ops as rot_ops
        from repro_torch.kernels.trsm import ops as trsm_ops
        from repro_torch.kernels.tridiag_eig import kernel as td2_kernel
        from repro_torch.core.standard_form import (to_standard_sygst,
                                                    to_standard_two_trsm)
        from repro_torch.core.tridiag import tridiagonalize
        from repro_torch.data.problems import dft_like, md_like
        from repro_torch.kernels import _build
        from repro_torch.kernels.symv import ref as symv_ref
    except ImportError as err:
        print(f"chip_smoke: the port is not next to this script ({err})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(ROOT)}", flush=True)
    for src, log in _build.BUILD_INFO["ptxas"].items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled name, cut to what tells the variants apart
                entry = line.split("'")[1][-40:] if "'" in line else ""
            if "registers" in line or "spill" in line:
                print(f"  {src} {entry}: {line.strip()}")

    checks = Checks()
    last = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - last[0]:.1f} s", flush=True)
        last[0] = now

    # ---- phase 2: the TD2 kernels against their plain versions -----------
    def standard_form(prob):
        return to_standard_two_trsm(prob.A, cholesky_upper(prob.B))

    t0 = time.perf_counter()
    md = md_like(args.md_n, device=dev)
    torch.cuda.synchronize()
    print(f"md_like(n={args.md_n}): {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    C = standard_form(md)
    res = tridiagonalize(C)
    torch.cuda.synchronize()
    print(f"MD GS1+GS2+TD1 for the kernel inputs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = compare_td2_kernels(f"MD n={args.md_n} s={args.md_s}", res.d,
                               res.e, args.md_s, checks)
    del res

    # the DFT tridiagonal from TT1 + TT2 (TD1 is a host loop of n columns);
    # the plain versions on the card (on the host they would take minutes)
    t0 = time.perf_counter()
    dft = dft_like(args.dft_n, device=dev)
    C_dft = standard_form(dft)
    dft_panel = C_dft[:, :TT_W].clone()     # its first TT1 panel (phase 3b)
    chase = band_chase(reduce_to_band(C_dft, w=TT_W).Wb, TT_W)
    del dft, C_dft
    torch.cuda.synchronize()
    print(f"DFT GS1+GS2+TT1+TT2 for the kernel inputs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    compare_td2_kernels(f"DFT n={args.dft_n} s={args.dft_s}", chase.d,
                        chase.e, args.dft_s, checks, plain_dev=dev)
    dft_tables = chase.cs                   # TT4's replay there (phase 3b)
    del chase
    torch.cuda.empty_cache()
    phase_done("2 (TD2 kernels)")

    # ---- phase 3: the one-triangle product against its plain version -----
    prod = compare_product(f"MD C n={args.md_n}", C, checks, seed=1)
    rows["symm_block"] = prod["symm_block p=1"]
    rows["symv"] = prod["symv"]
    product_variants(f"MD C n={args.md_n}", C, seed=13)
    product_accuracy(f"MD C n={args.md_n}", C, seed=14)
    W = _wide_matrix(args.wide_n, seed=2, device=dev)
    compare_product(f"garbage-lower n={args.wide_n}", W, checks, seed=3)
    del W
    torch.cuda.empty_cache()
    phase_done("3 (product)")

    # ---- phase 3b: the TT kernels against their plain versions -----------
    n = args.md_n
    rows["house_panel"], (V, T) = compare_house_panel(
        f"MD C n={n} first panel", C[:, :TT_W], TT_W, checks, by_part=True)
    compare_house_panel(f"DFT C n={args.dft_n} first panel", dft_panel, TT_W,
                        checks)
    del dft_panel
    # a mid-ladder panel: the middle panel of the middle window, on C
    ladder = _chunk_bounds(_n_panels(n, TT_W), default_n_chunks(n, TT_W))
    p0, p1 = ladder[len(ladder) // 2]
    o, p = p0 * TT_W, (p0 + p1) // 2
    c0 = p * TT_W - o
    compare_house_panel(f"MD C n={n} window {o} panel {p}",
                        C[o:, o + c0: o + c0 + TT_W], c0 + TT_W, checks)
    rows["syr2k"] = compare_syr2k(f"MD C n={n} first window", C, V,
                                  wy_syr2k_panel(C, V, T), checks)
    del V, T
    torch.cuda.empty_cache()
    rows["rot_apply"] = compare_rot_apply(checks, dev)
    small = md_like(args.chase_n, device=dev)
    band = reduce_to_band(standard_form(small), w=TT_W)
    compare_chase(f"MD band n={args.chase_n} w={TT_W}", band.Wb, TT_W,
                  checks, dev)
    del small, band
    # the main path's band: ||W||_2 = max |lambda| of the exact spectrum
    band = reduce_to_band(C, w=TT_W)
    rows.update(compare_chase_md(
        f"MD band n={n} w={TT_W}", band.Wb, TT_W,
        float(md.exact_evals.abs().max()), checks, dev))
    # the DFT paper size: TT4's replay onto (n, s) against the sweep kernel
    compare_replay(f"DFT n={args.dft_n} w={TT_W}",
                   _executed_passes(args.dft_n, TT_W), dft_tables, args.dft_n,
                   None, checks, dev, cols=args.dft_s)
    del dft_tables
    torch.cuda.empty_cache()
    phase_done("3b (TT kernels)")
    rows["band_mv"] = compare_band_mv(f"MD band n={n} w={TT_W}", band.Wb, TT_W,
                                      checks, seed=9)
    band_bm = to_band_mv_layout(band.Wb).contiguous()
    phase_done("3b (band_mv)")
    # ---- phase 3d: the fp32 and bf16 instances at the MD shapes ----------
    rows.update(compare_reduced(f"MD n={n}", C, band.Wb, TT_W, checks, dev))
    del band
    torch.cuda.empty_cache()
    phase_done("3d (kernels below fp64)")

    # ---- phase 3c: gemm and trsm at the MD shapes -------------------------
    U = cholesky_upper(md.B).contiguous()
    Xs = torch.randn((n, args.md_s), dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(10))
    compare_gemm(f"MD C n={n}", C, Xs, checks, TIMING_REPS)
    rows["gemm"] = compare_gemm(f"MD C U n={n}", C, U, checks, 1)
    torch.cuda.empty_cache()
    trsm_bt1 = compare_trsm(f"BT1 shape n={n}", U, Xs, False, checks)
    trsm_gs2 = compare_trsm(f"GS2 shape n={n}", U, md.A, True, checks)
    rows["trsm_tile"] = compare_trsm_tile(
        f"U[:{TRSM_BLOCK}, :{TRSM_BLOCK}]", U[:TRSM_BLOCK, :TRSM_BLOCK],
        md.A[:TRSM_BLOCK], checks)
    for label, r in (("BT1", trsm_bt1), ("GS2", trsm_gs2)):
        print("trsm composite " + label + ": " + json.dumps(
            {k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}),
              flush=True)
    torch.cuda.empty_cache()
    # the products the blocked stages launch, at their MD shapes
    k1 = TRSM_BLOCK
    Xu = Xs[:k1].clone()
    compare_update(f"BT1 n={n}", U[:k1, k1:], Xs[k1:], Xu, -1.0, checks)
    t1 = n - 2 * TRSM_BLOCK                # GS2 sygst's first trailing solve
    R256 = torch.randn((t1, 2 * TRSM_BLOCK), dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(11))
    Xg = torch.randn((k1, 2 * TRSM_BLOCK), dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(12))
    compare_update(f"GS2 sygst n={n}", U[:t1, t1 - k1:t1].mT, R256, Xg, -1.0,
                   checks)
    del R256, Xg, Xu
    g0 = 2 * TRSM_BLOCK                    # GS1's first block row, block 256
    row = U[:g0, g0:].contiguous()
    M = md.B.clone()
    compare_update(f"GS1 SYRK n={n}", row.mT, row, M[g0:, g0:], -1.0, checks)
    S = gemm_ops.gemm(row.mT, row)
    asym = float((S - S.mT).abs().max())
    print(f"GS1 SYRK symmetry: max|S - S^T| of S = row^T row ({n - g0}^2, "
          f"K={g0}) = {asym!r}; of the updated block "
          f"{float((M[g0:, g0:] - M[g0:, g0:].mT).abs().max())!r}", flush=True)
    del S, M, row
    torch.cuda.empty_cache()
    # bitwise repeats: no atomics in the sums, the same plan every call
    for label, fn in (("gemm (n^2, 100)", lambda: gemm_ops.gemm(C, Xs)),
                      ("BT1 trsm", lambda: trsm_ops.trsm(U, Xs))):
        first, second = fn(), fn()
        checks.check(f"{label} repeats bitwise", bool(torch.equal(first,
                                                                  second)),
                     f"max |run 1 - run 2| = "
                     f"{float((first - second).abs().max())!r}")
        del first, second
    dmma = _dmma_count(out_dir / "libgemm.so")
    print(f"DMMA instructions in libgemm.so: {dmma}", flush=True)
    if dmma != "not measured":
        checks.check("gemm runs on the fp64 tensor cores", int(dmma) > 0,
                     f"{dmma} DMMA in the SASS")
    phase_done("3c (band_mv, gemm, trsm)")

    # ---- phase 4: the main paths -----------------------------------------
    # each solve's stage times, for the router's lines (phase 4c)
    measured = {}
    td_res = run_solve("TD", md, args.md_s, checks, variant="TD")
    td = td_res.info["kernel_launches"]
    ke_res = run_solve("KE", md, args.md_s, checks, variant="KE",
                       invert=True, use_kernel=True)
    ke = ke_res.info["kernel_launches"]
    ki_res = run_solve("KI", md, args.md_s, checks, variant="KI",
                       invert=True, use_kernel=True)
    measured["MD TD"] = dict(td_res.stage_times)
    for v, r in (("KE", ke_res), ("KI", ki_res)):
        measured[f"MD {v}"] = dict(r.stage_times, n_matvec=r.info["n_matvec"])
    ke4_res = run_solve("KE p=4", md, args.md_s, checks, variant="KE",
                        invert=True, use_kernel=True, krylov_block=4)
    ki = ki_res.info["kernel_launches"]
    ke4 = ke4_res.info["kernel_launches"]
    krylov = (("KE", ke_res), ("KI", ki_res), ("KE p=4", ke4_res))
    print("symm_block launches on the Krylov paths: " + ", ".join(
        f"{label} {r.info['kernel_launches']['symm_block']} (n_matvec "
        f"{r.info['n_matvec']}, {label[:2]}_iter "
        f"{r.stage_times[label[:2] + '_iter']:.4f} s)"
        for label, r in krylov), flush=True)
    # phase 4e holds the mesh solves at fp64 to these
    single = {"KE fp64": {"evals": ke4_res.evals,
                          "stage_times": dict(ke4_res.stage_times)}}
    del ke_res, ki_res, ke4_res, krylov
    # the restart count at tol=0 follows the product's rounding: the same
    # block solve on torch.matmul, and one KE solve under the profiler
    mm4 = solve(md.A, md.B, args.md_s, variant="KE", invert=True,
                use_kernel=False, krylov_block=4)
    print(f"KE p=4 on torch.matmul (use_kernel=False): n_matvec "
          f"{mm4.info['n_matvec']}, n_restart {mm4.info['n_restart']}, "
          f"KE_iter {mm4.stage_times['KE_iter']:.4f} s", flush=True)
    del mm4
    profile_stage("KE solve", lambda: solve(md.A, md.B, args.md_s,
                                            variant="KE", invert=True,
                                            use_kernel=True))
    tt_res = run_solve("TT", md, args.md_s, checks, variant="TT",
                       band_width=TT_W)
    measured["MD TT"] = dict(tt_res.stage_times)
    tt = tt_res.info["kernel_launches"]
    single["TT fp64"] = {"evals": tt_res.evals,
                         "stage_times": dict(tt_res.stage_times)}
    del tt_res
    print_plans("TT", args.md_n, args.md_s, TT_W)
    # the paper's second experiment at its size: TT, then TD
    dft = dft_like(args.dft_n, device=dev)
    tt_dft_res = run_solve("TT DFT", dft, args.dft_s, checks, variant="TT",
                           band_width=TT_W)
    measured["DFT TT"] = dict(tt_dft_res.stage_times)
    tt_dft = tt_dft_res.info["kernel_launches"]
    del tt_dft_res
    print_plans("TT DFT", args.dft_n, args.dft_s, TT_W)
    torch.cuda.empty_cache()
    td_dft_res = run_solve("TD DFT", dft, args.dft_s, checks, variant="TD")
    measured["DFT TD"] = dict(td_dft_res.stage_times)
    td_dft = td_dft_res.info["kernel_launches"]
    del td_dft_res
    torch.cuda.empty_cache()
    # the paper's Table 4: the blocked GS1/GS2/TD1 against the fused ones
    tdb_res = run_solve("TD blocked", md, args.md_s, checks, variant="TD",
                        gs1="blocked", gs2="sygst", td1="blocked")
    keb_res = run_solve("KE blocked", md, args.md_s, checks, variant="KE",
                        invert=True, use_kernel=True, gs1="blocked",
                        gs2="sygst")
    scale = float(md.exact_evals.abs().max())
    for label, r in (("TD blocked", tdb_res), ("KE blocked", keb_res)):
        gap = float((r.evals - td_res.evals).abs().max())
        checks.check(f"{label} eigenvalues vs the fused TD's", gap <= EVAL_BAR
                     * scale, f"max gap {gap!r}, bar {EVAL_BAR} * max|lambda| "
                     f"= {EVAL_BAR * scale!r}")
    st, sb, kb = td_res.stage_times, tdb_res.stage_times, keb_res.stage_times
    print(f"Table 4 (MD n={args.md_n}, s={args.md_s}; s): GS1 fused "
          f"{st['GS1']:.4f}, blocked {sb['GS1']:.4f} (KE {kb['GS1']:.4f}); GS2 "
          f"trsm {st['GS2']:.4f}, sygst {sb['GS2']:.4f} (KE {kb['GS2']:.4f}); "
          f"TD1 unblocked {st['TD1']:.4f}, blocked {sb['TD1']:.4f}; TD total "
          f"{st['Tot.']:.4f} against {sb['Tot.']:.4f}", flush=True)
    profile_stage("GS1 blocked", lambda: cholesky_blocked(md.B))
    profile_stage("GS2 sygst", lambda: to_standard_sygst(md.A, U))
    tdb = tdb_res.info["kernel_launches"]
    keb = keb_res.info["kernel_launches"]
    del td_res, tdb_res, keb_res
    phase_done("4 (main paths)")
    # ---- phase 4b: the mixed and fast levels, and a fault drill ----------
    prec = run_precision(md, args.md_s, checks)
    fault_drill(checks, dev)
    phase_done("4b (precision, fault drill)")
    # ---- phase 4c: batched buckets and the router -------------------------
    buckets = run_buckets(md, checks, dev)
    phase_done("4c (batched buckets)")
    router = run_router(md, dft, args.md_s, args.dft_s, measured, checks)
    del dft
    torch.cuda.empty_cache()
    phase_done("4c (router)")
    # ---- phase 4d: the serving engine --------------------------------------
    engine = run_engine(md, args.md_s, router["MD fastest"], checks, dev)
    phase_done("4d (serving engine)")
    # ---- phase 4e: the distribution layer on a (1, 1) NCCL mesh ----------
    for level in ("mixed",):
        for v in ("TT", "KE"):
            single[f"{v} {level}"] = prec[f"{v} {level} result"]
    mesh_run = run_mesh(md, args.md_s, single, checks)
    del single
    phase_done("4e (distribution layer)")
    # ---- phase 4f: the audit on the card -----------------------------------
    audit = run_audit_phase(checks)
    phase_done("4f (audit)")
    # ---- phase 4g: the LM serving path -------------------------------------
    run_lm(checks, dev)
    phase_done("4g (LM serving path)")
    for label, counts, names in (("TD", td, ("bisect_sturm", "invit")),
                                 ("KE", ke, ("symm_block",)),
                                 ("KI", ki, ("symm_block",)),
                                 ("KE p=4", ke4, ("symm_block",)),
                                 ("TT", tt, ("bisect_sturm", "invit")),
                                 ("TT DFT", tt_dft, ("bisect_sturm", "invit")),
                                 ("TD DFT", td_dft, ("bisect_sturm", "invit")),
                                 ("TD blocked", tdb, ("gemm", "trsm_tile",
                                                      "syr2k", "bisect_sturm",
                                                      "invit")),
                                 ("KE blocked", keb, ("gemm", "trsm_tile",
                                                      "syr2k", "symm_block"))):
        for name in names:
            checks.check(f"main path {label} launched {name}",
                         counts[name] > 0, f"{counts[name]} launches")
    # invit: the solve and the Gram-Schmidt a round, three rounds
    for label, counts in (("TD", td), ("TT", tt), ("TT DFT", tt_dft),
                          ("TD DFT", td_dft)):
        want = 3 * td2_kernel.LAUNCHES_PER_ROUND
        checks.check(f"main path {label} invit launches",
                     counts["invit"] == want,
                     f"{counts['invit']} launches (expected {want})")
    for label, counts, n_ in (("TT", tt, args.md_n),
                              ("TT DFT", tt_dft, args.dft_n)):
        n_pass = len(_executed_passes(n_, TT_W))
        want = {"house_panel": _n_panels(n_, TT_W),
                "syr2k": _n_panels(n_, TT_W), "chase_pass": n_pass,
                "replay_pass": n_pass}
        got = {k: counts[k] for k in want}
        checks.check(f"main path {label} TT launch counts", got == want,
                     f"{json.dumps(got)} (expected {json.dumps(want)})")

    # symv: reached by apply_op on a vector, not by solve
    x = torch.randn((args.md_n,), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    kernels.reset_launches()
    y = apply_op(ExplicitC(C), x, use_kernel=True)
    torch.cuda.synchronize()
    sv = kernels.launch_counts()
    print(f"apply_op(ExplicitC(C), x, use_kernel=True) launches: "
          f"{json.dumps(sv)}", flush=True)
    checks.check("apply_op on a vector launched symv", sv["symv"] == 1,
                 f"{sv['symv']} launches")
    C_h, x_h = C.cpu(), x.cpu()
    diff = (y.cpu() - symv_ref.symv_upper_ref(C_h, x_h)).abs()
    checks.check("apply_op symv within gamma_n of plain",
                 bool(torch.all(diff <= gamma_bound(C_h, x_h))),
                 f"max |kernel - plain| = {float(diff.max())!r}")
    del C_h
    # rot_apply: reached by its public wrapper on a CUDA tensor, not by solve
    pairs = torch.randn((1000, 2, 8), dtype=torch.float64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    cs = torch.randn((1000, 2), dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(8))
    kernels.reset_launches()
    rot_ops.rot_apply(pairs, cs)
    torch.cuda.synchronize()
    ra = kernels.launch_counts()
    print(f"rot_apply ops call launches: {json.dumps(ra)}", flush=True)
    checks.check("rot_apply ops call launched rot_apply", ra["rot_apply"] == 1,
                 f"{ra['rot_apply']} launches")
    # gemm, trsm and band_mv: reached by their public entry points
    public = {}
    for name, call in (("gemm", lambda: gemm_ops.gemm(C, Xs)),
                       ("trsm", lambda: trsm_ops.trsm(U, Xs)),
                       ("band_mv", lambda: band_mv_ops.band_mv(band_bm, x,
                                                               TT_W))):
        kernels.reset_launches()
        call()
        torch.cuda.synchronize()
        public[name] = kernels.launch_counts()
        print(f"{name} ops call launches: {json.dumps(public[name])}",
              flush=True)
    bt1 = trsm_ops.launches(args.md_n, args.md_s)
    gemm_want = gemm_kernel.plan(args.md_n, args.md_s, args.md_n).launches
    for name, kname, want in (("gemm", "gemm", gemm_want),
                              ("trsm", "trsm_tile", bt1["trsm_tile"]),
                              ("trsm", "gemm", bt1["gemm"]),
                              ("band_mv", "band_mv", 1)):
        checks.check(f"{name} ops call launched {kname}",
                     public[name][kname] == want,
                     f"{public[name][kname]} launches (expected {want})")
    # the reduced symv and rot_apply: reached by their public entry points
    for sfx in ("fp32", "bf16"):
        dt = _reduced_dtype(sfx)
        for name, call in (
                ("symv", lambda dt=dt: apply_op(ExplicitC(C.to(dt)), x.to(dt),
                                                use_kernel=True)),
                ("rot_apply", lambda dt=dt: rot_ops.rot_apply(pairs.to(dt),
                                                              cs.to(dt)))):
            kernels.reset_launches()
            call()
            torch.cuda.synchronize()
            got = kernels.launch_counts()[f"{name}_{sfx}"]
            public[f"{name}_{sfx}"] = got
            checks.check(f"{name} ops call on {sfx} launched {name}_{sfx}",
                         got == 1, f"{got} launches")
    del U, Xs, band_bm
    phase_done("4 (public calls)")
    launches = {"bisect_sturm": td["bisect_sturm"], "invit": td["invit"],
                "symm_block": ke["symm_block"], "symv": sv["symv"],
                "house_panel": tt["house_panel"], "syr2k": tt["syr2k"],
                "rot_apply": ra["rot_apply"], "chase_pass": tt["chase_pass"],
                "replay_pass": tt["replay_pass"],
                "gemm": public["gemm"]["gemm"],
                "trsm_tile": public["trsm"]["trsm_tile"],
                "band_mv": public["band_mv"]["band_mv"]}
    for sfx, level in (("fp32", "mixed"), ("bf16", "fast")):
        tt_r, ke_r = prec[f"TT {level}"], prec[f"KE {level}"]
        for name in ("house_panel", "syr2k", "chase_pass", "replay_pass"):
            launches[f"{name}_{sfx}"] = tt_r[f"{name}_{sfx}"]
        launches[f"symm_block_{sfx}"] = ke_r[f"symm_block_{sfx}"]
        for name in ("symv", "rot_apply"):
            launches[f"{name}_{sfx}"] = public[f"{name}_{sfx}"]

    # ---- phase 5: the report ---------------------------------------------
    kernel_rows = []
    for name in KERNEL_ORDER:
        r = rows[name]
        family = name.rsplit("_", 1)[0] if name.endswith(
            ("_fp32", "_bf16")) else name
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[family],
            "replaces": REPLACES[family], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # launches a warm call of phase 4c's buckets ran, all buckets
            "batched_launches": sum(b["launches"].get(name, 0)
                                    for b in buckets.values()),
            # launches of phase 4d's engine run (stream, router, drills)
            "engine_launches": engine["launches"].get(name, 0),
            # launches of phase 4e's mesh solves (KE and TT, fp64, mixed)
            "mesh_launches": mesh_run["launches"].get(name, 0),
            # launches of phase 4f's audited entries
            "audit_launches": audit["launches"].get(name, 0),
            # the reduced panel, chase and replay: the older kernel on the
            # same input, the pass's chain floor, the panel's device time
            **{k: r[k] for k in ("older_path_ms", "chain_floor_ms",
                                 "device_ms") if k in r}})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    if checks.failed:
        print("FAILED: " + ", ".join(checks.failed), flush=True)
        return 1
    print(json.dumps({"kernels": kernel_rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
