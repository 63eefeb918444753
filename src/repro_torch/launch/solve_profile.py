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
precision. ``--match`` sums the device time and launches of the kernels
whose names hold each given string (``--match house_`` is the TT1 panel's
kernels, cluster and cooperative, at any level).

``--batch B`` profiles a warm ``solve_batched`` call of one bucket of B
pencils (``--problem`` at seeds ``--seed``, ``--seed`` + 1, ...; the
graphs captured by a cold call first) the same way: its wall is the
call's ``info["wall_s"]``, and its device time is that of the kernels and
copies the graphs' replays and the ``eigh`` splits ran. A line adds the
bucket's graphs, replays and restarts:

  PYTHONPATH=src python -m repro_torch.launch.solve_profile \\
      --batch 8 --n 1024 --s 10 --seed 700 --variant TD KE --precision fp64

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

from repro_torch.core import solve, solve_batched
from repro_torch.data.problems import dft_like, md_like


def _device_ms(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0)) / 1e3


def profile_solve(prob, s: int, variant: str, precision: str, repeats: int,
                  band_width: int = 16, top: int = 6, match=()) -> dict:
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
    matched = {m: dict(ms=round(sum(k[0] for k in kernels if m in k[2]), 3),
                       count=sum(k[1] for k in kernels if m in k[2]))
               for m in match}
    return dict(variant=variant, precision=precision, n=prob.A.shape[0], s=s,
                wall_ms=[round(1e3 * w, 2) for w in walls],
                stage_times_s=stages, device_ms=round(device_ms, 2),
                idle_share=round(1.0 - device_ms / wall_ms, 4),
                kernels=[dict(name=name[:60], ms=round(ms, 3), count=count)
                         for ms, count, name in kernels[:top]],
                matched=matched)


def profile_batched(A, B, s: int, variant: str, precision: str,
                    repeats: int, band_width: int = 16, top: int = 6,
                    match=()) -> dict:
    kw = dict(variant=variant, precision=precision, band_width=band_width)
    if variant in ("KE", "KI"):
        kw.update(invert=True, use_kernel=True)
    solve_batched(A, B, s, **kw)                  # cold: capture
    walls = [solve_batched(A, B, s, **kw).info["wall_s"]
             for _ in range(repeats)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = solve_batched(A, B, s, **kw)
    info = res.info
    kernels = sorted(((_device_ms(ev), ev.count, ev.key)
                      for ev in prof.key_averages() if _device_ms(ev) > 0),
                     reverse=True)
    device_ms = sum(k[0] for k in kernels)
    wall_ms = 1e3 * statistics.median(walls)
    matched = {m: dict(ms=round(sum(k[0] for k in kernels if m in k[2]), 3),
                       count=sum(k[1] for k in kernels if m in k[2]))
               for m in match}
    return dict(variant=variant, precision=precision, n=A.shape[1], s=s,
                batch=A.shape[0], path=info["path"], graphs=info["graphs"],
                graph_replays=info["graph_replays"],
                restarts=info.get("restarts"),
                wall_ms=[round(1e3 * w, 2) for w in walls],
                profiled_wall_ms=round(1e3 * info["wall_s"], 2),
                device_ms=round(device_ms, 2),
                idle_share=round(1.0 - device_ms / wall_ms, 4),
                kernels=[dict(name=name[:60], ms=round(ms, 3), count=count)
                         for ms, count, name in kernels[:top]],
                matched=matched)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", choices=["md", "dft"], default="md")
    ap.add_argument("--n", type=int, default=9997)
    ap.add_argument("--s", type=int, default=100)
    ap.add_argument("--variant", nargs="+", choices=["TD", "TT", "KE", "KI"],
                    default=["KE"])
    ap.add_argument("--precision", nargs="+", default=["mixed"],
                    choices=["fp64", "mixed", "fast"])
    ap.add_argument("--band-width", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0,
                    help="profile a warm solve_batched bucket of this many "
                         "pencils (0: one solve)")
    ap.add_argument("--seed", type=int, default=9997,
                    help="the first pencil's seed")
    ap.add_argument("--tag", default="", help="a label for the lines")
    ap.add_argument("--match", nargs="*", default=[],
                    help="sum the device time of the kernels whose names "
                         "hold each of these strings")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    gen = md_like if args.problem == "md" else dft_like
    dev = torch.device("cuda")
    probs = [gen(args.n, seed=args.seed + i, device=dev)
             for i in range(max(args.batch, 1))]
    if args.batch:
        A = torch.stack([p.A for p in probs])
        B = torch.stack([p.B for p in probs])
    for variant in args.variant:
        for precision in args.precision:
            if args.batch:
                out = profile_batched(A, B, args.s, variant, precision,
                                      args.repeats, args.band_width,
                                      match=args.match)
            else:
                out = profile_solve(probs[0], args.s, variant, precision,
                                    args.repeats, args.band_width,
                                    match=args.match)
            print(json.dumps(dict(tag=args.tag, **out)), flush=True)


if __name__ == "__main__":
    main()
