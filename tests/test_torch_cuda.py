"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX,
which the GPU machine need not have.)

Each kernel is held against its plain version on the same inputs (the
plain version on CPU copies, as the wrapper runs it for a CPU tensor),
and a small TD solve on the card must launch both kernels.
"""
import pytest
import torch

from repro_torch.core import accuracy_report, solve
from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                          bisect_inputs, normalize_columns,
                                          start_block)
from repro_torch.data.problems import dft_like
from repro_torch.kernels.tridiag_eig import kernel, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tridiag(n, seed, device):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(n, generator=g, dtype=torch.float64)
    e = torch.randn(n - 1, generator=g, dtype=torch.float64)
    return d.to(device), e.to(device)


@pytest.mark.parametrize("n,s", [(1, 1), (37, 5), (3000, 130)])
def test_bisect_sturm_bitwise_vs_plain(cuda, n, s):
    d, e = _tridiag(n, n, cuda)
    e2, scal = bisect_inputs(d, e)
    ks = torch.arange(s, device=cuda)
    lam = kernel.bisect_sturm(d, e2, ks, scal)
    plain = ref.bisect_sturm_ref(d.cpu(), e2.cpu(), ks.cpu(), scal.cpu())
    assert torch.equal(lam.cpu(), plain)


@pytest.mark.parametrize("n,s", [(37, 5), (1500, 40)])
def test_invit_vs_plain(cuda, n, s):
    d, e = _tridiag(n, n + 1, cuda)
    e2, scal = bisect_inputs(d, e)
    lam = kernel.bisect_sturm(d, e2, torch.arange(s, device=cuda), scal)
    cid = _cluster_ids(lam, _scale(d, e))
    X0 = normalize_columns(start_block(n, s, None, cuda))
    args = (d, e, lam, cid, _pivmin(d, e), X0)
    Z = kernel.invit(*args)
    Zp = ref.invit_ref(*(t.cpu() for t in args))
    eye = torch.eye(s, dtype=Z.dtype)
    assert torch.abs(Z.cpu().mT @ Z.cpu() - eye).max() <= 1e-12
    sign = torch.where(torch.sum(Z.cpu() * Zp, 0) < 0, -1.0, 1.0)
    sizes = torch.bincount(cid.cpu().long())
    single = sizes[cid.cpu().long()] == 1
    assert torch.abs(Z.cpu() - Zp * sign)[:, single].max() <= 1e-10


def test_td_solve_on_the_card_launches_both_kernels(cuda):
    p = dft_like(256, device=cuda)
    kernel.reset_launches()
    res = solve(p.A, p.B, 8)
    assert kernel.launch_counts() == {"bisect_sturm": 1, "invit": 6}
    assert res.info["kernel_launches"] == {"bisect_sturm": 1, "invit": 6}
    acc = accuracy_report(p.A, p.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12
