"""The port's table drivers (``repro_torch.benchmarks``) at tiny n on the
CPU: each prints the lines of its reference driver under the same names
(``benchmarks/table{2,3,4}*.py``), with the values the port measured."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.benchmarks import (common, table2_stage_timings,
                                    table3_accuracy, table4_blocked_vs_fused)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--md-n", "40", "--md-s", "3", "--dft-n", "48",
        "--dft-s", "3"]
VARIANTS = ("TD", "TT", "KE", "KI")


def _args(mod, extra=()):
    ap = common.parser("test", precision=mod is not table4_blocked_vs_fused)
    return ap.parse_args([*TINY, *extra])


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_table2_and_table3_lines(precision):
    common._SOLVE_CACHE.clear()
    args = _args(table2_stage_timings, ["--precision", precision])
    t2 = table2_stage_timings.main(args)
    names = {ln.split(",")[0] for ln in t2 if ln.startswith("table2_")}
    assert names == {f"table2_{p}_{v}_total" for p in ("md", "dft")
                     for v in VARIANTS}
    assert ("RF," in "\n".join(t2)) == (precision != "fp64")
    for ln in t2:
        if ln.startswith("table2_"):
            m = re.fullmatch(r"table2_\w+_total,([0-9.]+),orth=(\S+);"
                             r"resid=(\S+)", ln)
            assert m and float(m.group(2)) <= 1e-12
            assert float(m.group(3)) <= 1e-12
    # table3 reuses table2's solves from the cache
    n_cached = len(common._SOLVE_CACHE)
    t3 = table3_accuracy.main(args)
    assert len(common._SOLVE_CACHE) == n_cached
    rows = [ln for ln in t3 if ln.startswith("table3_")]
    assert [r.split(",")[0] for r in rows] == [
        f"table3_{p}_{v}" for p in ("md", "dft") for v in VARIANTS]
    for r in rows:
        vals = dict(kv.split("=") for kv in r.split(",")[2].split(";"))
        assert float(vals["orth"]) <= 1e-12
        assert float(vals["resid"]) <= 1e-12
        assert float(vals["eval_relerr"]) <= 1e-10


def test_table4_lines():
    out = table4_blocked_vs_fused.main(_args(table4_blocked_vs_fused))
    names = [ln.split(",")[0] for ln in out if ln.startswith("table4_")]
    assert names == [f"table4_{p}_{k}" for p in ("md", "dft")
                     for k in ("GS1_fused", "GS1_blocked128",
                               "GS2_two_trsm", "GS2_sygst")]
    assert all(float(ln.split(",")[1]) > 0 for ln in out
               if ln.startswith("table4_"))


def test_sizes_default_to_the_reference_and_full_to_the_paper():
    ap = common.parser("test")
    sz = common.sizes(ap.parse_args([]))
    assert sz == {"md": (384, 4), "dft": (512, 13), "dft_m": 96}
    sz = common.sizes(ap.parse_args(["--full"]))
    assert sz == {"md": (9997, 100), "dft": (17243, 448), "dft_m": 896}
    assert ap.parse_args([]).device == "cuda"


def test_drivers_run_as_modules():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.table4_blocked_vs_fused",
         *TINY], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "table4_md_GS1_fused," in out.stdout
