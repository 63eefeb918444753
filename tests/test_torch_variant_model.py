"""The port's cost model and variant router
(``repro_torch.analysis.variant_model``) against the reference's
``repro.analysis.variant_model``, on the CPU.

Every cost formula is the reference's: ``stage_costs`` and
``predict_stage_times`` agree to 1e-12 relative over a grid of variants,
sizes (n 32-17243, s 1-448), precision levels, Krylov blocks and filters,
clustered spectra and a mesh, on the default machine and on one with
every latency term set; ``choose_variant`` picks as the reference does
there. The router's invariants are ``tests/test_variant_router.py``'s
(its golden table of TPU decisions is left out: the port's machine is
the H100). ``from_measurements``/``from_artifact`` fit as the reference's
``from_artifact`` on a synthetic race artifact, and ``h100()``'s
constants are pinned to their fit.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from repro.analysis import variant_model as jv
from repro.core import solve as j_solve
from repro.data.problems import dft_like, md_like
from repro_torch.analysis import variant_model as tv
from repro_torch.core import solve
from repro_torch.interop import problem_from_numpy

NS = (32, 128, 1024, 9997, 17243)
SS = (1, 4, 100, 448)
LATENCY = dict(t_dispatch=5e-3, t_collective=2e-4, t_loop_step=3e-6)
GRID = [(n, s, cl, p, fd, mesh)
        for n, s in itertools.product(NS, SS) if s < n
        for cl, p, fd, mesh in itertools.product(
            (False, True), (1, 4), (0, 16), (None, (4, 2)))]


def _machines():
    return ((jv.MachineParams(), tv.MachineParams()),
            (jv.MachineParams(**LATENCY), tv.MachineParams(**LATENCY)))


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fast"])
@pytest.mark.parametrize("variant", tv.VARIANTS)
def test_stage_costs_match_reference(variant, precision):
    for (jm, tm), (n, s, cl, p, fd, mesh) in itertools.product(_machines(),
                                                               GRID):
        kw = dict(clustered=cl, p=p, filter_degree=fd, precision=precision,
                  band_width=16)
        ref = jv.stage_costs(variant, n, s, machine=jm, **kw)
        got = tv.stage_costs(variant, n, s, machine=tm, **kw)
        assert list(got) == list(ref)
        for st in ref:
            r, g = dataclasses.asdict(ref[st]), dataclasses.asdict(got[st])
            assert g.pop("compute_dtype") == r.pop("compute_dtype")
            for f in r:
                _close(g[f], r[f])
        rt = jv.predict_stage_times(variant, n, s, machine=jm,
                                    mesh_shape=mesh, **kw)
        gt = tv.predict_stage_times(variant, n, s, machine=tm,
                                    mesh_shape=mesh, **kw)
        assert list(gt) == list(rt)
        for st in rt:
            _close(gt[st], rt[st])


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fast"])
def test_choose_variant_matches_reference(precision):
    for (jm, tm), (n, s, cl, p, fd, mesh) in itertools.product(_machines(),
                                                               GRID):
        kw = dict(clustered=cl, krylov_block=p, filter_degree=fd,
                  precision=precision, mesh_shape=mesh, band_width=16)
        ref = jv.choose_variant(n, s, machine=jm, **kw)
        got = tv.choose_variant(n, s, machine=tm, **kw)
        assert got.variant == ref.variant, (n, s, kw, ref.table)
        assert got.n_devices == ref.n_devices
        assert set(got.table) == set(ref.table)
        for v in ref.table:
            _close(got.table[v], ref.table[v])


def test_estimates_match_reference():
    for n, s in itertools.product(NS, SS):
        if s >= n:
            continue
        for cl, p, fd in itertools.product((False, True), (1, 4), (0, 16)):
            it = tv.estimate_lanczos_iters(n, s, clustered=cl, p=p,
                                           filter_degree=fd)
            assert it == jv.estimate_lanczos_iters(n, s, clustered=cl, p=p,
                                                   filter_degree=fd)
            m = tv.default_subspace(s, n, p)
            assert (tv.estimate_lanczos_restarts(it, s, m, p)
                    == jv.estimate_lanczos_restarts(it, s, m, p))
        for w in (2, 8, 16, 32):
            assert tv._chase_loop_steps(n, w) == jv._chase_loop_steps(n, w)
            assert tv._replay_loop_steps(n, w) == jv._replay_loop_steps(n, w)
        assert (dataclasses.astuple(tv._tridiag_eig_cost(n, s, 8))
                == dataclasses.astuple(jv._tridiag_eig_cost(n, s, 8)))
        for steps in (8, 16):
            assert (dataclasses.astuple(tv._refinement_cost(n, s, 8, steps))
                    == dataclasses.astuple(jv._refinement_cost(n, s, 8,
                                                               steps)))
    assert tv.DTYPE_FLOP_SPEEDUP == jv.DTYPE_FLOP_SPEEDUP
    assert tv.DTYPE_BYTES == jv.DTYPE_BYTES
    assert tv.DEMOTED_STAGES == jv.DEMOTED_STAGES
    assert tv.DISTRIBUTED_VARIANTS == jv.DISTRIBUTED_VARIANTS


# ------------------------------------- the reference's router invariants --

INVARIANT_ARGS = [(9997, 100, None, False), (9997, 100, None, True),
                  (17243, 448, None, False), (512, 8, None, False),
                  (4096, 32, None, False), (4096, 512, None, False),
                  (2048, 2000, None, False), (128, 4, None, False),
                  (9997, 100, (4, 2), False), (512, 8, (4, 2), False),
                  (128, 4, (4, 2), True),
                  (17243, 100, (4, 2), True,
                   {"krylov_block": 4, "filter_degree": 16})]


@pytest.mark.parametrize("machine", [None, "h100"])
def test_choice_invariants(machine):
    mach = tv.MachineParams.h100() if machine else None
    for args in INVARIANT_ARGS:
        n, s, mesh_shape, clustered = args[:4]
        kw = args[4] if len(args) > 4 else {}
        c = tv.choose_variant(n, s, mesh_shape=mesh_shape,
                              clustered=clustered, machine=mach, **kw)
        allowed = (tv.DISTRIBUTED_VARIANTS
                   if mesh_shape and np.prod(mesh_shape) > 1 else tv.VARIANTS)
        assert set(c.table) == set(allowed)
        assert c.variant in c.table
        assert c.predicted_s == min(c.table.values())
        json.dumps(c.as_json_dict())


def test_model_reflects_blas_levels():
    mach = tv.MachineParams()
    n, s = 8192, 64
    td = tv.stage_costs("TD", n, s, machine=mach)
    tt = tv.stage_costs("TT", n, s, band_width=32, machine=mach)
    assert tt["TT1"].flops > td["TD1"].flops
    assert td["TD1"].bytes / mach.mem_bw > td["TD1"].flops / mach.peak_flops
    assert tt["TT1"].bytes / mach.mem_bw < tt["TT1"].flops / mach.peak_flops
    tt8 = tv.stage_costs("TT", n, s, band_width=8, machine=mach)
    assert tt8["TT1"].bytes > tt["TT1"].bytes
    t_td = tv.predict_stage_times("TD", n, s, machine=mach)["Tot."]
    for w in (8, 32):
        assert tv.predict_stage_times("TT", n, s, band_width=w,
                                      machine=mach)["Tot."] < t_td


def test_iteration_estimate_monotone():
    base = tv.estimate_lanczos_iters(4096, 32)
    assert tv.estimate_lanczos_iters(4096, 32, clustered=True) > base
    assert tv.estimate_lanczos_iters(4096, 128) >= base


def test_block_and_filter_knobs_move_ke():
    n, s = 17243, 100
    ke1 = tv.stage_costs("KE", n, s, clustered=True)["KE_iter"]
    ke4 = tv.stage_costs("KE", n, s, clustered=True, p=4)["KE_iter"]
    assert ke4.collectives < 0.6 * ke1.collectives
    assert ke4.flops < 1.5 * ke1.flops
    assert (tv.estimate_lanczos_iters(n, s, clustered=True, filter_degree=16)
            < tv.estimate_lanczos_iters(n, s, clustered=True))
    ke_known = tv.stage_costs("KE", 128, 4, m=48, n_iter=6626)["KE_iter"]
    assert ke_known.dispatches == pytest.approx(
        2 + tv.estimate_lanczos_restarts(6626, 4, 48))


def test_more_devices_never_slower():
    for v in ("TT", "KE"):
        t1 = tv.predict_stage_times(v, 8192, 64, mesh_shape=(1, 1))["Tot."]
        t8 = tv.predict_stage_times(v, 8192, 64, mesh_shape=(4, 2))["Tot."]
        assert t8 < t1


def test_dispatch_term_separates_ke_from_tt():
    n, s, m = 128, 4, 48
    ke = tv.stage_costs("KE", n, s, m=m, n_iter=6626)
    tt = tv.stage_costs("TT", n, s, band_width=8)
    d_ke = sum(c.dispatches for c in ke.values())
    d_tt = sum(c.dispatches for c in tt.values())
    assert d_tt <= 10 and d_ke >= 10 * d_tt
    mach = tv.MachineParams(t_dispatch=5e-3)
    for costs, d_total in ((ke, d_ke), (tt, d_tt)):
        tot = sum(c.seconds(mach, 8) for c in costs.values())
        tot0 = sum(c.seconds(tv.MachineParams(), 8) for c in costs.values())
        np.testing.assert_allclose(tot - tot0, d_total * 5e-3, rtol=1e-9)


# ---------------------------------------------------- the measured fits --

def _artifact():
    """A synthetic race artifact: stage times of the model on a machine
    with latency terms, scaled by per-stage factors, TT and KE each at two
    band widths / blocks, over two races."""
    truth = jv.MachineParams(peak_flops=2e11, mem_bw=4e10, **LATENCY)
    n, s, dev = 256, 8, 4
    races = []
    for r, scale in enumerate((1.0, 1.3)):
        measured = []
        for v, kw in (("TT", {"band_width": 8}), ("TT", {"band_width": 16}),
                      ("KE", {"krylov_block": 2, "n_matvec": 900}),
                      ("KE", {"krylov_block": 1, "filter_degree": 8,
                              "n_matvec": 1400})):
            ckw = {"band_width": kw.get("band_width", 8),
                   "p": kw.get("krylov_block", 1),
                   "filter_degree": kw.get("filter_degree", 0)}
            if "n_matvec" in kw:
                ckw["n_iter"] = kw["n_matvec"]
            costs = jv.stage_costs(v, n, s, machine=truth, **ckw)
            times = {st: scale * (1.0 + 0.1 * i) * c.seconds(truth, dev)
                     for i, (st, c) in enumerate(costs.items())}
            measured.append({"variant": v, "stage_times_s": times,
                             "wall_s_median": sum(times.values()), **kw})
        races.append({"problem": f"race{r}", "measured": measured})
    return {"n": n, "s": s, "n_devices": dev, "races": races}


def test_from_measurements_matches_reference_fit(tmp_path):
    art = _artifact()
    path = tmp_path / "BENCH_variant_race.json"
    path.write_text(json.dumps(art))
    ref = jv.MachineParams.from_artifact(str(path))
    got_file = tv.MachineParams.from_artifact(str(path))
    got = tv.MachineParams.from_measurements(art)
    assert got == got_file
    for f in dataclasses.fields(tv.MachineParams):
        _close(getattr(got, f.name), getattr(ref, f.name))
    assert got.t_dispatch > 0.0 and got.t_loop_step > 0.0
    # with a base: the fit starts from it, as the reference's
    base_j = jv.MachineParams(peak_flops=1e12, mem_bw=2e11)
    base_t = tv.MachineParams(peak_flops=1e12, mem_bw=2e11)
    ref_b = jv.MachineParams.from_artifact(str(path), base=base_j)
    got_b = tv.MachineParams.from_measurements(art, base=base_t)
    for f in dataclasses.fields(tv.MachineParams):
        _close(getattr(got_b, f.name), getattr(ref_b, f.name))
    # nothing to fit: the base comes back
    assert tv.MachineParams.from_measurements(
        {"n": 64, "s": 4, "measured": []}) == tv.MachineParams()


def test_h100_constants_pinned():
    """``h100()``: the card's data-sheet peaks, and the latency terms that
    ``from_measurements`` fits to the port's MD fp64 stage times from
    those peaks (PERF.md §5)."""
    h = tv.MachineParams.h100()
    assert (h.peak_flops, h.mem_bw, h.link_bw, h.dtype_bytes) == (
        67e12, 3.35e12, 450e9, 8)
    assert h.t_collective == 0.0
    assert h.t_loop_step == 4.087126477242383e-07
    assert h.t_dispatch == 0.023538055672044776
    base = dataclasses.replace(h, t_dispatch=0.0, t_loop_step=0.0)
    fit = tv.MachineParams.from_measurements(tv.H100_MD_FP64, base=base)
    assert fit.t_loop_step == pytest.approx(h.t_loop_step, rel=1e-12)
    assert fit.t_dispatch == pytest.approx(h.t_dispatch, rel=1e-12)
    # the router at the paper's two sizes on the card's machine
    assert tv.choose_variant(9997, 100, band_width=16,
                             machine=h).variant == "KE"
    assert tv.choose_variant(17243, 448, band_width=16, clustered=True,
                             filter_degree=16, machine=h).variant == "TT"


# ------------------------------------------------------- auto dispatch ----

AUTO_GRID = [(md_like, 64, 4, "smallest"), (md_like, 48, 3, "largest"),
             (dft_like, 64, 4, "largest")]


@pytest.mark.parametrize("gen,n,s,which", AUTO_GRID,
                         ids=[f"{g.__name__}_n{n}_s{s}_{w}"
                              for g, n, s, w in AUTO_GRID])
def test_auto_matches_explicit(gen, n, s, which):
    """variant='auto' runs, records the reference's decision, and returns
    the eigenvalues of the variant it chose, solved explicitly."""
    p = gen(n)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    ref = j_solve(p.A, p.B, s, variant="auto", which=which)
    res_auto = solve(tp.A, tp.B, s, variant="auto", which=which,
                     device="cpu")
    picked = res_auto.info["variant"]
    assert picked in tv.VARIANTS
    assert res_auto.info["router"]["variant"] == picked
    assert picked == ref.info["variant"]
    res_explicit = solve(tp.A, tp.B, s, variant=picked, which=which,
                         device="cpu")
    np.testing.assert_allclose(res_auto.evals.numpy(),
                               res_explicit.evals.numpy(),
                               rtol=1e-12, atol=1e-12)
    json.dumps(res_auto.info)


def test_auto_takes_the_machine():
    """``machine=`` reaches the router: the H100's latency terms price
    TD1's single dispatch and the chase's loop steps."""
    p = md_like(64)
    tp = problem_from_numpy(p.A, p.B, p.exact_evals, p.name, device="cpu")
    h = tv.MachineParams.h100()
    res = solve(tp.A, tp.B, 4, variant="auto", machine=h, device="cpu")
    want = tv.choose_variant(64, 4, band_width=16, machine=h)
    assert res.info["router"] == want.as_json_dict()
    assert res.info["variant"] == want.variant
    assert torch.isfinite(res.evals).all()
