"""Device time of ``invit``'s launches, kernel by kernel, on the card.

For each problem size: the pencil's standard form, its tridiagonal (TD1),
the s smallest eigenvalues (``bisect_sturm``), then one ``invit`` call
under ``torch.profiler``: the device time of each kernel it launches (the
solve and the Gram-Schmidt), and the call's time by CUDA events.

  PYTHONPATH=src python -m repro_torch.launch.invit_profile \\
      --problem md dft --n 9997 4096 --s 100 64

To profile another tree's kernels, run this file with that tree's ``src``
first on PYTHONPATH:
``PYTHONPATH=<tree>/src python src/repro_torch/launch/invit_profile.py``.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.cholesky import cholesky_upper
from repro_torch.core.standard_form import to_standard_two_trsm
from repro_torch.core.tridiag import tridiagonalize
from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                          bisect_inputs, normalize_columns,
                                          start_block)
from repro_torch.data.problems import dft_like, md_like
from repro_torch.kernels.tridiag_eig import kernel


def profile_invit(problem: str, n: int, s: int, seed: int = 20120520) -> dict:
    dev = torch.device("cuda")
    prob = (md_like if problem == "md" else dft_like)(n, device=dev)
    res = tridiagonalize(to_standard_two_trsm(prob.A, cholesky_upper(prob.B)))
    d, e = res.d, res.e
    del prob, res
    e2, scal = bisect_inputs(d, e)
    lam = kernel.bisect_sturm(d, e2, torch.arange(s, device=dev), scal)
    cid = _cluster_ids(lam, _scale(d, e))
    gen = torch.Generator(device=dev).manual_seed(seed)
    X0 = normalize_columns(start_block(n, s, gen, dev))
    args = (d, e, lam, cid, _pivmin(d, e), X0)
    kernel.invit(*args)                       # warm-up: loads the module
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel.invit(*args)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", 0.0) / 1e3
        if ms:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            by_kernel[name.split()[-1]] = {"ms": ms, "count": ev.count}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    kernel.invit(*args)
    end.record()
    torch.cuda.synchronize()
    sizes = torch.bincount(cid.long())
    return dict(problem=problem, n=n, s=s, clusters=int(sizes.numel()),
                largest_cluster=int(sizes.max()),
                call_ms=start.elapsed_time(end), device_ms=by_kernel)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", nargs="+", default=["md", "dft"],
                    choices=["md", "dft"])
    ap.add_argument("--n", type=int, nargs="+", default=[9997, 4096])
    ap.add_argument("--s", type=int, nargs="+", default=[100, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("invit_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for problem, n, s in zip(args.problem, args.n, args.s):
        print(json.dumps(profile_invit(problem, n, s)), flush=True)


if __name__ == "__main__":
    main()
