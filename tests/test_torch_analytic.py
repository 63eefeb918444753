"""The port's analytic cost model (``repro_torch.analysis.analytic``)
against the reference's: every function equal as floats for every
architecture (full size and smoke), every ``LM_SHAPES`` entry and 1, 4 and
256 chips; then the reference's four checks of
``tests/test_roofline_analytic.py`` on the port, with the forward's flops
held against ``torch.utils.flop_counter.FlopCounterMode`` over the port's
``forward`` (in place of XLA's ``cost_analysis``) within the reference's
0.5-2.0 band, and the decode check's machine balance the H100's (3.35
TB/s of HBM, 989 TFLOP/s bf16 dense: NVIDIA's data sheet, SXM).
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.analysis import analytic as janalytic
from repro.models import config as jmconfig
from repro_torch import configs
from repro_torch.analysis import analytic
from repro_torch.models import config as mconfig
from repro_torch.models import model as tm

H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12


def _pairs(arch):
    """(port cfg, reference cfg) at full size and at smoke size."""
    return [(configs.get_config(arch), jconfigs.get_config(arch)),
            (configs.smoke_config(arch), jconfigs.smoke_config(arch))]


def _same(got, want):
    assert type(got) is float and type(want) is float
    assert got == want, (got, want)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_function_equals_the_reference(arch):
    shapes = list(zip(mconfig.LM_SHAPES, jmconfig.LM_SHAPES))
    for cfg, jcfg in _pairs(arch):
        for B, S, T in ((1, 1, None), (2, 128, None), (4, 1, 4096),
                        (8, 4096, 4096)):
            for decode in (False, True):
                _same(analytic.fwd_flops(cfg, B, S, T, decode),
                      janalytic.fwd_flops(jcfg, B, S, T, decode))
        for shape, jshape in shapes:
            for remat in (True, False):
                _same(analytic.train_flops(cfg, shape, remat),
                      janalytic.train_flops(jcfg, jshape, remat))
            for name in ("decode_flops", "prefill_flops", "train_bytes",
                         "decode_bytes", "prefill_bytes"):
                _same(getattr(analytic, name)(cfg, shape),
                      getattr(janalytic, name)(jcfg, jshape))
            for chips in (1, 4, 256):
                _same(analytic.train_coll_bytes(cfg, shape, chips),
                      janalytic.train_coll_bytes(jcfg, jshape, chips))
                for rep in (False, True):
                    _same(analytic.decode_coll_bytes(cfg, shape, chips, rep),
                          janalytic.decode_coll_bytes(jcfg, jshape, chips,
                                                      rep))
                    got = analytic.cell_cost(cfg, shape, chips, rep)
                    want = janalytic.cell_cost(jcfg, jshape, chips, rep)
                    assert isinstance(got, analytic.CellCost)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _counted_flops(cfg, B, S):
    """FLOPs that ``FlopCounterMode`` counts over the port's forward."""
    params = tm.init_params(0, cfg, device="cpu")
    toks = torch.zeros((B, S), dtype=torch.int64)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tm.forward(params, toks, cfg)
    return float(counter.get_total_flops())


@pytest.mark.parametrize("arch", ["mistral-large-123b", "qwen1.5-32b"])
def test_analytic_flops_match_the_flop_counter_dense(arch):
    cfg = configs.smoke_config(arch).scaled(dtype="float32")
    B, S = 2, 128
    counted = _counted_flops(cfg, B, S)
    ana = analytic.fwd_flops(cfg, B, S)
    assert counted > 0
    ratio = ana / counted
    assert 0.5 < ratio < 2.0, (ana, counted, ratio)


def test_analytic_flops_scale_with_seq():
    cfg = configs.smoke_config("chameleon-34b")
    f1 = analytic.fwd_flops(cfg, 2, 256)
    f2 = analytic.fwd_flops(cfg, 2, 512)
    # attention is quadratic but projections linear: 2x seq => 2-4x flops
    assert 2.0 <= f2 / f1 <= 4.0


def test_decode_flops_much_smaller_than_prefill():
    cfg = configs.get_config("mistral-large-123b")
    dec = analytic.cell_cost(cfg, mconfig.shape_by_name("decode_32k"), 256)
    pre = analytic.cell_cost(cfg, mconfig.shape_by_name("prefill_32k"), 256)
    assert dec.flops < pre.flops / 1000.0
    # decode is never compute-bound on the H100 either
    assert dec.hbm_bytes / H100_HBM_BYTES_PER_S > dec.flops / H100_BF16_FLOPS


def test_moe_active_vs_total_flops():
    cfg = configs.get_config("arctic-480b")
    n_total = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    assert n_active < 0.2 * n_total  # 2-of-128 routing
    f = analytic.fwd_flops(cfg, 1, 1024)
    # flops track ACTIVE params (2*N_active*D), within attention/embed slack
    assert f < 2 * 2 * n_active * 1024 * 1.5
