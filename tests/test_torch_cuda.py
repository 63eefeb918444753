"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX,
which the GPU machine need not have.)

Each kernel is held against its plain version on the same inputs (the
plain version on CPU copies, as the wrapper runs it for a CPU tensor),
and small TD and KE solves on the card must launch their kernels.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ExplicitC, accuracy_report, apply_op, solve
from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                          bisect_inputs, normalize_columns,
                                          start_block)
from repro_torch.data.problems import dft_like, md_like
from repro_torch.kernels.symv import kernel as symv_kernel
from repro_torch.kernels.symv import ref as symv_ref
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
    assert res.info["kernel_launches"] == {"bisect_sturm": 1, "invit": 6,
                                           "symv": 0, "symm_block": 0}
    acc = accuracy_report(p.A, p.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12


# ------------------------------------------------ the one-triangle product --

def _gamma(n):
    u = torch.finfo(torch.float64).eps / 2
    return n * u / (1 - n * u)


def _garbage_lower(n, seed, device):
    """Symmetric upper triangle, 1e6-scale garbage strictly below it."""
    g = torch.Generator().manual_seed(seed)
    R = torch.randn((n, n), generator=g, dtype=torch.float64)
    G = 1e6 * torch.randn((n, n), generator=g, dtype=torch.float64)
    return (torch.triu(R) + torch.tril(G, -1)).to(device)


def _within_gamma(Y, Yp, A, X):
    """|Y - Y_plain| <= gamma_n (|sym(triu A)| |X|), componentwise: a bound
    for any order of summation."""
    absA = torch.triu(A.abs()) + torch.triu(A.abs(), 1).mT
    bound = _gamma(A.shape[0]) * (absA @ X.abs())
    return bool(torch.all((Y - Yp).abs() <= bound))


@pytest.mark.parametrize("n,p", [(1, 1), (5, 3), (64, 1), (65, 4), (129, 4),
                                 (1000, 1), (1000, 5), (3001, 4)])
def test_symm_block_vs_plain(cuda, n, p):
    A = _garbage_lower(n, n, cuda)
    X = torch.randn((n, p), dtype=torch.float64, device=cuda)
    Y = symv_kernel.symm_block(A, X)
    Yp = symv_ref.symm_block_upper_ref(A.cpu(), X.cpu())
    assert _within_gamma(Y.cpu(), Yp, A.cpu(), X.cpu())
    # fixed summation order: the same inputs give the same bits
    assert torch.equal(symv_kernel.symm_block(A, X), Y)


@pytest.mark.parametrize("n", [1, 33, 1000, 2049])
def test_symv_vs_plain(cuda, n):
    A = _garbage_lower(n, n + 7, cuda)
    x = torch.randn((n,), dtype=torch.float64, device=cuda)
    y = symv_kernel.symv(A, x)
    yp = symv_ref.symv_upper_ref(A.cpu(), x.cpu())
    assert _within_gamma(y.cpu()[:, None], yp[:, None], A.cpu(),
                         x.cpu()[:, None])


def test_symm_block_reads_a_column_slice_in_place(cuda):
    n, p = 300, 4
    A = _garbage_lower(n, 3, cuda)
    V = torch.randn((n, 3 * p + 1), dtype=torch.float64, device=cuda)
    Xs = V[:, p:2 * p]
    assert not Xs.is_contiguous()
    Y = symv_kernel.symm_block(A, Xs)
    assert torch.equal(Y, symv_kernel.symm_block(A, Xs.contiguous()))


def test_symm_block_refuses_a_column_major_matrix(cuda):
    A = torch.randn((70, 70), dtype=torch.float64, device=cuda).mT
    with pytest.raises(ValueError, match="row-major"):
        symv_kernel.symm_block(A, torch.ones((70, 1), dtype=torch.float64,
                                             device=cuda))


def test_ke_solve_on_the_card_launches_symm_block(cuda):
    p = md_like(200, device=cuda)
    kernels.reset_launches()
    res = solve(p.A, p.B, 6, variant="KE", invert=True, use_kernel=True)
    launches = res.info["kernel_launches"]
    assert launches["symm_block"] == res.info["n_matvec"] > 0
    assert launches["symv"] == 0
    assert res.info["converged"]
    acc = accuracy_report(p.A, p.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12
    x = torch.randn((200,), dtype=torch.float64, device=cuda)
    y = apply_op(ExplicitC(p.A), x, use_kernel=True)
    assert symv_kernel.launch_counts()["symv"] == 1
    assert _within_gamma(y.cpu()[:, None],
                         symv_ref.symv_upper_ref(p.A.cpu(), x.cpu())[:, None],
                         p.A.cpu(), x.cpu()[:, None])
