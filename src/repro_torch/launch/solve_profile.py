"""Wall, host enqueue and device time of a solve on the card, with the
device's idle share and its kernels by device time.

  PYTHONPATH=src python -m repro_torch.launch.solve_profile \\
      --variant KE --precision mixed fast --n 9997 --s 100

For each precision: one warm-up call, then ``--repeats`` calls timed on
the host clock to the synchronize (the wall, and the solve's
``stage_times``), then one more under ``torch.profiler`` for the device
time by kernel. Idle share: 1 - device time / the median wall of the
timed calls. KE and KI run ``invert=True, use_kernel=True``, TT at
``--band-width``; every solve ``on_failure="recover"``. One JSON line a
precision.

To profile another tree's kernels, run this file with that tree's ``src``
first on PYTHONPATH:
``PYTHONPATH=<tree>/src python src/repro_torch/launch/solve_profile.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import solve
from repro_torch.data.problems import dft_like, md_like


def _device_ms(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0)) / 1e3


def profile_solve(prob, s: int, variant: str, precision: str, repeats: int,
                  band_width: int = 16, top: int = 6) -> dict:
    kw = dict(variant=variant, precision=precision, on_failure="recover")
    if variant in ("KE", "KI"):
        kw.update(invert=True, use_kernel=True)
    if variant == "TT":
        kw["band_width"] = band_width

    def run():
        res = solve(prob.A, prob.B, s, **kw)
        torch.cuda.synchronize()
        return res

    run()
    walls, stages = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
        stages.append({k: round(float(v), 4)
                       for k, v in res.stage_times.items()})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kernels = sorted(((_device_ms(ev), ev.count, ev.key)
                      for ev in prof.key_averages() if _device_ms(ev) > 0),
                     reverse=True)
    device_ms = sum(k[0] for k in kernels)
    wall_ms = 1e3 * statistics.median(walls)
    return dict(variant=variant, precision=precision, n=prob.A.shape[0], s=s,
                wall_ms=[round(1e3 * w, 2) for w in walls],
                stage_times_s=stages, device_ms=round(device_ms, 2),
                idle_share=round(1.0 - device_ms / wall_ms, 4),
                kernels=[dict(name=name[:60], ms=round(ms, 3), count=count)
                         for ms, count, name in kernels[:top]])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", choices=["md", "dft"], default="md")
    ap.add_argument("--n", type=int, default=9997)
    ap.add_argument("--s", type=int, default=100)
    ap.add_argument("--variant", choices=["TD", "TT", "KE", "KI"],
                    default="KE")
    ap.add_argument("--precision", nargs="+", default=["mixed"],
                    choices=["fp64", "mixed", "fast"])
    ap.add_argument("--band-width", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--tag", default="", help="a label for the lines")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    prob = (md_like if args.problem == "md" else dft_like)(
        args.n, device=torch.device("cuda"))
    for precision in args.precision:
        out = profile_solve(prob, args.s, args.variant, precision,
                            args.repeats, args.band_width)
        print(json.dumps(dict(tag=args.tag, **out)), flush=True)


if __name__ == "__main__":
    main()
