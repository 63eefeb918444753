#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printed as it runs; any failed check exits nonzero:

1. the card (``torch.cuda`` and ``nvidia-smi``), then the build of every
   CUDA source under ``src/repro_torch/csrc`` with ``nvcc`` (sm_90a);
2. each TD2 kernel against its plain PyTorch version (run on CPU copies of
   the same inputs, as the wrapper runs it for a CPU tensor), on the
   tridiagonal that TD1 makes of the MD pencil at the paper's size
   (n=9997, the s=100 smallest) and of the DFT pencil at n=4096, s=64:
   ``bisect_sturm`` bitwise, ``invit`` by residual, orthogonality,
   per-cluster subspace angle and elementwise on singleton clusters;
   kernel and plain timed in turns (kernel, plain, kernel, plain);
3. the one-triangle product (``symm_block`` at p=1 and p=4, ``symv``)
   against its plain version on CPU copies, componentwise within
   gamma_n (|sym(triu A)| |X|), on the MD standard-form C and on a random
   symmetric matrix at the DFT width n=17243 whose strictly lower triangle
   holds 1e6-scale garbage; timed in turns, beside ``torch.matmul`` on the
   full matrix (the library call that computes the same function);
4. the main paths, each with every launch count set to 0 just before and
   read just after: ``solve(A, B, 100, variant="TD")`` on the MD pencil;
   ``solve(A, B, 100, variant="KE"|"KI", invert=True, use_kernel=True)``
   and KE with ``krylov_block=4``; each held to the Table-3 bars (1e-12)
   and to the generator's exact spectrum; then one
   ``apply_op(ExplicitC(C), x, use_kernel=True)`` on a vector (``symv``);
5. one JSON line of the kernels (launches on their main path, error
   against the plain version, times, bound), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

``--md-n`` / ``--dft-n`` / ``--wide-n`` shrink the matrices for a quick
rehearsal; the defaults are the sizes above.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): fp64 outside the tensor cores
# and HBM3 bandwidth
FP64_VECTOR_FLOPS = 34e12
HBM_BYTES_PER_S = 3.35e12

TABLE3 = 1e-12           # relative_residual and b_orthogonality bars
EVAL_BAR = 1e-10         # max eigenvalue error / max|lambda| of the spectrum
INVIT_RESID = 1e-12      # ||T z - lam z||_2 / ||T||_1, per column
INVIT_ORTH = 1e-12       # max |Z^T Z - I|
INVIT_SINGLETON = 1e-10  # elementwise kernel vs plain, singleton clusters
INVIT_SUBSPACE = 1e-8    # sin of the largest principal angle per cluster
TIMING_REPS = 20         # launches per timed window of the product

SOURCES = {"bisect_sturm": "src/repro_torch/csrc/tridiag_eig.cu",
           "invit": "src/repro_torch/csrc/tridiag_eig.cu",
           "symv": "src/repro_torch/csrc/symv.cu",
           "symm_block": "src/repro_torch/csrc/symv.cu"}
REPLACES = {"bisect_sturm": "src/repro/kernels/tridiag_eig/kernel.py:74",
            "invit": "src/repro/kernels/tridiag_eig/kernel.py:194",
            "symv": "src/repro/kernels/symv/kernel.py:82",
            "symm_block": "src/repro/kernels/symv/kernel.py:117"}


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
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


def _bound(ops: float, nbytes: float) -> dict:
    """Least time for the work: operations over the fp64 vector peak, bytes
    (inputs read once, outputs written once) over HBM bandwidth."""
    t_ops = 1e3 * ops / FP64_VECTOR_FLOPS
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
                        seed: int = 20120520) -> dict:
    """Both TD2 kernels against their plain versions on tridiag(d, e), the s
    smallest indices. Returns one row per kernel (error, times, bound)."""
    import torch
    from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                              bisect_inputs, normalize_columns,
                                              start_block)
    from repro_torch.kernels.tridiag_eig import kernel, ref

    n = d.shape[0]
    e2, scal = bisect_inputs(d, e)
    ks = torch.arange(s, device=d.device)
    host = [t.cpu() for t in (d, e2, ks, scal)]
    kernel.bisect_sturm(d, e2, ks, scal)   # warm-up: loads the module
    lam_k, k1 = _time_cuda(lambda: kernel.bisect_sturm(d, e2, ks, scal))
    lam_p, p1 = _time_host(lambda: ref.bisect_sturm_ref(*host))
    _, k2 = _time_cuda(lambda: kernel.bisect_sturm(d, e2, ks, scal))
    _, p2 = _time_host(lambda: ref.bisect_sturm_ref(*host))
    bis_err = float(torch.max(torch.abs(lam_k.cpu() - lam_p)))
    print(f"{label} bisect_sturm: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.1f} / {p2:.1f} ms (plain on the host CPU)", flush=True)
    checks.check(f"{label} bisect_sturm bitwise",
                 torch.equal(lam_k.cpu(), lam_p),
                 f"max |kernel - plain| = {bis_err!r}")
    # Sturm recurrence: sub, div, sub per row, lane and sweep
    rows = {"bisect_sturm": dict(
        max_abs_err=bis_err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
        library_ms=None,
        **_bound(80 * n * s * 3, 8 * (2 * n + 3 + 2 * s)))}

    lam = lam_k
    cid = _cluster_ids(lam, _scale(d, e))
    piv = _pivmin(d, e)
    gen = torch.Generator(device=d.device).manual_seed(seed)
    X0 = normalize_columns(start_block(n, s, gen, d.device))
    args = (d, e, lam, cid, piv, X0)
    host = [t.cpu() for t in args]
    kernel.invit(*args)                    # warm-up
    Z_k, k1 = _time_cuda(lambda: kernel.invit(*args))
    Z_p, p1 = _time_host(lambda: ref.invit_ref(*host))
    _, k2 = _time_cuda(lambda: kernel.invit(*args))
    _, p2 = _time_host(lambda: ref.invit_ref(*host))
    print(f"{label} invit: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.1f} / {p2:.1f} ms (plain on the host CPU)", flush=True)

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
        max_abs_err=float(diff.max()), ms=(k1 + k2) / 2,
        plain_ms=(p1 + p2) / 2, library_ms=None,
        **_bound(3 * (19 * n * s + 4 * n * pairs),
                 8 * (2 * n + 2 * s + 2 * n * s)))
    return rows


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
    — a bound on the error of any order of summation. Returns one row per
    case (error, times, bound, ``torch.matmul`` time)."""
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
        _, p2 = _time_host(plain)
        torch.matmul(A, X)
        _, l1 = _time_cuda(lambda: torch.matmul(A, X), TIMING_REPS)
        _, l2 = _time_cuda(lambda: torch.matmul(A, X), TIMING_REPS)
        diff = (Y_k.cpu() - Y_p).abs()
        bound = gamma_bound(A_h, X_h)
        ratio = float(torch.max(diff / bound))
        key = f"{name} p={p}" if name == "symm_block" else name
        print(f"{label} {key}: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.1f} / {p2:.1f} ms (plain on the host CPU), "
              f"torch.matmul {l1:.4f} / {l2:.4f} ms", flush=True)
        checks.check(f"{label} {key} within gamma_n of plain",
                     bool(torch.all(diff <= bound)),
                     f"max |kernel - plain| / (gamma_n |A||X|) = {ratio!r}, "
                     f"max |kernel - plain| = {float(diff.max())!r}")
        rows[key] = dict(
            max_abs_err=float(diff.max()), ms=(k1 + k2) / 2,
            plain_ms=(p1 + p2) / 2, library_ms=(l1 + l2) / 2,
            # the upper triangle once, X once, Y once; 2 n^2 p flops
            **_bound(2.0 * n * n * p, 8 * (n * (n + 1) / 2 + 2 * n * p)))
    return rows


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


def run_solve(label: str, prob, s: int, checks: Checks, **kw):
    """One main-path solve with every launch count set to 0 just before and
    read just after; returns the launch counts."""
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
    print(f"main path {label}: solve(md n={n}, s={s}, "
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
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--md-n", type=int, default=9997)
    ap.add_argument("--md-s", type=int, default=100)
    ap.add_argument("--dft-n", type=int, default=4096)
    ap.add_argument("--dft-s", type=int, default=64)
    ap.add_argument("--wide-n", type=int, default=17243)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels
        from repro_torch.core import ExplicitC, apply_op
        from repro_torch.core.cholesky import cholesky_upper
        from repro_torch.core.standard_form import to_standard_two_trsm
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    checks = Checks()

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

    dft = dft_like(args.dft_n, device=dev)
    res = tridiagonalize(standard_form(dft))
    del dft
    compare_td2_kernels(f"DFT n={args.dft_n} s={args.dft_s}", res.d, res.e,
                        args.dft_s, checks)
    del res

    # ---- phase 3: the one-triangle product against its plain version -----
    prod = compare_product(f"MD C n={args.md_n}", C, checks, seed=1)
    rows["symm_block"] = prod["symm_block p=1"]
    rows["symv"] = prod["symv"]
    W = _wide_matrix(args.wide_n, seed=2, device=dev)
    compare_product(f"garbage-lower n={args.wide_n}", W, checks, seed=3)
    del W
    torch.cuda.empty_cache()

    # ---- phase 4: the main paths -----------------------------------------
    td = run_solve("TD", md, args.md_s, checks, variant="TD")
    ke = run_solve("KE", md, args.md_s, checks, variant="KE", invert=True,
                   use_kernel=True)
    run_solve("KI", md, args.md_s, checks, variant="KI", invert=True,
              use_kernel=True)
    run_solve("KE p=4", md, args.md_s, checks, variant="KE", invert=True,
              use_kernel=True, krylov_block=4)
    for label, counts, names in (("TD", td, ("bisect_sturm", "invit")),
                                 ("KE", ke, ("symm_block",))):
        for name in names:
            checks.check(f"main path {label} launched {name}",
                         counts[name] > 0, f"{counts[name]} launches")

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
    launches = {"bisect_sturm": td["bisect_sturm"], "invit": td["invit"],
                "symm_block": ke["symm_block"], "symv": sv["symv"]}

    # ---- phase 5: the report ---------------------------------------------
    kernel_rows = []
    for name in ("bisect_sturm", "invit", "symv", "symm_block"):
        r = rows[name]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
