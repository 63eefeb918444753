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
3. the main path: ``repro_torch.core.solve(A, B, 100, variant="TD")`` on
   the MD pencil, with every launch count set to 0 just before and read
   just after, held to the Table-3 bars (1e-12) and to the generator's
   exact spectrum;
4. one JSON line of the kernels (launches on the main path, error against
   the plain version, times, bound), the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

``--md-n`` / ``--dft-n`` shrink the pencils for a quick rehearsal; the
defaults are the sizes above.
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

SOURCE = "src/repro_torch/csrc/tridiag_eig.cu"
REPLACES = {"bisect_sturm": "src/repro/kernels/tridiag_eig/kernel.py:74",
            "invit": "src/repro/kernels/tridiag_eig/kernel.py:194"}


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_cuda(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def compare_kernels(label: str, d, e, s: int, checks: Checks,
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
        plain_ms=(p1 + p2) / 2,
        **_bound(3 * (19 * n * s + 4 * n * pairs),
                 8 * (2 * n + 2 * s + 2 * n * s)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--md-n", type=int, default=9997)
    ap.add_argument("--md-s", type=int, default=100)
    ap.add_argument("--dft-n", type=int, default=4096)
    ap.add_argument("--dft-s", type=int, default=64)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.core import accuracy_report, solve
        from repro_torch.core.cholesky import cholesky_upper
        from repro_torch.core.standard_form import to_standard_two_trsm
        from repro_torch.core.tridiag import tridiagonalize
        from repro_torch.data.problems import dft_like, md_like
        from repro_torch.kernels import _build
        from repro_torch.kernels.tridiag_eig import kernel
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

    # ---- phase 2: kernels against their plain versions --------------------
    def td1(prob):
        U = cholesky_upper(prob.B)
        C = to_standard_two_trsm(prob.A, U)
        res = tridiagonalize(C)
        return res.d, res.e

    t0 = time.perf_counter()
    md = md_like(args.md_n, device=dev)
    torch.cuda.synchronize()
    print(f"md_like(n={args.md_n}): {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    d, e = td1(md)
    torch.cuda.synchronize()
    print(f"MD GS1+GS2+TD1 for the kernel inputs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = compare_kernels(f"MD n={args.md_n} s={args.md_s}", d, e,
                           args.md_s, checks)

    dft = dft_like(args.dft_n, device=dev)
    d2, e2 = td1(dft)
    del dft
    compare_kernels(f"DFT n={args.dft_n} s={args.dft_s}", d2, e2,
                    args.dft_s, checks)

    # ---- phase 3: the main path ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = solve(md.A, md.B, args.md_s, variant="TD")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launch_counts()
    print(f"main path: solve(md n={args.md_n}, s={args.md_s}, TD) "
          f"{wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("stage_times_s: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_times.items()}), flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        checks.check(f"main path launched {name}", count > 0,
                     f"{count} launches")
    acc = accuracy_report(md.A, md.B, res.X, res.evals)
    rr, bo = float(acc.relative_residual), float(acc.b_orthogonality)
    checks.check("relative_residual", rr <= TABLE3, f"{rr!r} (bar {TABLE3})")
    checks.check("b_orthogonality", bo <= TABLE3, f"{bo!r} (bar {TABLE3})")
    exact = md.exact_evals
    err = float(torch.max(torch.abs(res.evals - exact[:args.md_s])))
    scale = float(torch.max(torch.abs(exact)))
    checks.check("eigenvalues vs exact spectrum", err <= EVAL_BAR * scale,
                 f"max error {err!r}, bar {EVAL_BAR} * max|lambda| = "
                 f"{EVAL_BAR * scale!r}")
    finite = bool(torch.isfinite(res.X).all() and torch.isfinite(res.evals).all())
    checks.check("output shape and finite",
                 finite and tuple(res.X.shape) == (args.md_n, args.md_s),
                 f"X {tuple(res.X.shape)}, evals {tuple(res.evals.shape)}")
    checks.check("health", bool(res.info["health"]["healthy"]),
                 json.dumps(res.info["health"]["stages"]))
    checks.check("info is JSON-clean", bool(json.dumps(res.info)),
                 f"{len(json.dumps(res.info))} bytes")

    # ---- phase 4: the report ---------------------------------------------
    kernels = []
    for name in ("bisect_sturm", "invit"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    if checks.failed:
        print("FAILED: " + ", ".join(checks.failed), flush=True)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
