"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX,
which the GPU machine need not have.)

Each kernel is held against its plain version on the same inputs (the
plain version on CPU copies, as the wrapper runs it for a CPU tensor),
and small TD, TT and KE solves on the card, and the blocked GS1/GS2/TD1
stages, must launch their kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ExplicitC, accuracy_report, apply_op, solve
from repro_torch.core import sbr
from repro_torch.core.tridiag_eig import (_cluster_ids, _pivmin, _scale,
                                          bisect_inputs, normalize_columns,
                                          start_block)
from repro_torch.core.cholesky import cholesky_blocked, cholesky_upper
from repro_torch.core.precision import padded_copy
from repro_torch.core.standard_form import (to_standard_sygst,
                                            to_standard_two_trsm)
from repro_torch.core.tridiag import tridiagonalize, tridiagonalize_blocked
from repro_torch.data.problems import dft_like, md_like
from repro_torch.kernels.band_mv import kernel as bmv_kernel
from repro_torch.kernels.band_mv import ops as bmv_ops
from repro_torch.kernels.band_mv import ref as bmv_ref
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.house_panel import kernel as hp_kernel
from repro_torch.kernels.house_panel import ref as hp_ref
from repro_torch.kernels.rot_apply import kernel as rot_kernel
from repro_torch.kernels.rot_apply import ref as rot_ref
from repro_torch.kernels.rot_apply import schedule as rot_sched
from repro_torch.kernels.symv import kernel as symv_kernel
from repro_torch.kernels.symv import ref as symv_ref
from repro_torch.kernels.syr2k import kernel as syr2k_kernel
from repro_torch.kernels.syr2k import ref as syr2k_ref
from repro_torch.kernels.tridiag_eig import kernel, ref
from repro_torch.kernels.tridiag_eig.schedule import bisect_multisection
from repro_torch.kernels.trsm import kernel as trsm_kernel
from repro_torch.kernels.trsm import ops as trsm_ops
from repro_torch.kernels.trsm import ref as trsm_ref

pytestmark = pytest.mark.cuda

#: the reduced storage dtypes (the fp32 and bf16 instances)
REDUCED = [torch.float32, torch.bfloat16]


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


@pytest.mark.parametrize("max_iters", [80, 7])
@pytest.mark.parametrize("n,s", [(1, 1), (37, 5), (3000, 130), (17243, 448)])
def test_bisect_sturm_bitwise_vs_plain(cuda, n, s, max_iters):
    """The wrapper (the plan's levels, with the stop) and every forced m
    that a block holds, with the stop on and off, bitwise against the
    plain bisection; the sweeps at small n as the plain twin counts them."""
    d, e = _tridiag(n, n, cuda)
    e2, scal = bisect_inputs(d, e)
    ks = torch.arange(s, device=cuda)
    host = (d.cpu(), e2.cpu(), ks.cpu(), scal.cpu())
    plain = ref.bisect_sturm_ref(*host, max_iters=max_iters)
    kernel.reset_launches()
    lam = kernel.bisect_sturm(d, e2, ks, scal, max_iters=max_iters)
    assert kernel.launch_counts()["bisect_sturm"] == 1
    assert torch.equal(lam.cpu(), plain)
    sms = kernel.sm_count(cuda.index or 0)
    for m in range(1, kernel.MAX_LEVELS + 1):
        per = kernel.bisect_plan(n, s, sms, max_iters, levels=m).per_block
        for flags in (kernel.STOP, 0):
            lam, sweeps = kernel.bisect_launch(d, e2, ks, scal, max_iters, m,
                                               per, flags)
            assert torch.equal(lam.cpu(), plain), (m, flags)
            if n <= 37:
                twin = bisect_multisection(*host, m, max_iters,
                                           stop=bool(flags & kernel.STOP))
                assert torch.equal(twin[0], plain)
                assert torch.equal(sweeps.cpu(), twin[1]), (m, flags)
    assert kernel.launch_counts()["bisect_sturm"] == 1


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


def _cluster_layout(name, lam):
    """Cluster ids for the Gram-Schmidt of ``invit``: contiguous ranges of
    columns, as the sorted shifts give them."""
    s = lam.shape[0]
    if name == "natural":
        return None
    if name == "one":
        return torch.zeros(s, dtype=torch.int32)
    if name == "straddle":       # clusters across the 32-column panels
        edges = [0, 20, 53, 90, s]
    else:                        # singletons between clusters
        edges = [0, 1, 2, 40, 41, 75, 76, 77, s - 1, s]
    cid = torch.zeros(s, dtype=torch.int32)
    for c, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        cid[a:b] = c
    return cid


@pytest.mark.parametrize("layout,n,s", [
    ("natural", 3000, 130), ("one", 3000, 130), ("straddle", 3000, 130),
    ("singletons", 3000, 130), ("one", 256, 8), ("one", 200, 33)])
def test_invit_cluster_layouts_vs_plain_on_the_card(cuda, layout, n, s):
    """The Gram-Schmidt across the card (panels of 32 columns) against the
    plain version on the card: residual, orthogonality, subspace angle per
    cluster, singletons elementwise; two runs bitwise equal."""
    d, e = _tridiag(n, 11, cuda)
    e2, scal = bisect_inputs(d, e)
    lam = kernel.bisect_sturm(d, e2, torch.arange(s, device=cuda), scal)
    cid = _cluster_layout(layout, lam)
    cid = _cluster_ids(lam, _scale(d, e)) if cid is None else cid.to(cuda)
    X0 = normalize_columns(start_block(n, s, None, cuda))
    args = (d, e, lam, cid, _pivmin(d, e), X0)
    Z = kernel.invit(*args)
    assert torch.equal(kernel.invit(*args), Z)
    Zp = ref.invit_ref(*args)
    ea = torch.abs(e)
    zero = ea.new_zeros(1)
    tnorm = float(torch.max(torch.abs(d) + torch.cat([zero, ea])
                            + torch.cat([ea, zero])))
    TZ = d[:, None] * Z
    TZ[:-1] += e[:, None] * Z[1:]
    TZ[1:] += e[:, None] * Z[:-1]
    R = TZ - Z * lam[None, :]
    assert float(torch.linalg.vector_norm(R, dim=0).max()) / tnorm <= 1e-12
    eye = torch.eye(s, dtype=Z.dtype, device=cuda)
    assert float(torch.abs(Z.mT @ Z - eye).max()) <= 1e-12
    sign = torch.where(torch.sum(Z * Zp, 0) < 0, -1.0, 1.0)
    cidl = cid.long()
    sizes = torch.bincount(cidl)
    single = sizes[cidl] == 1
    if bool(single.any()):
        assert float(torch.abs(Z - Zp * sign)[:, single].max()) <= 1e-10
    for c in torch.nonzero(sizes > 1).flatten().tolist():
        A, B = Z[:, cidl == c], Zp[:, cidl == c]
        assert float(torch.linalg.matrix_norm(A - B @ (B.mT @ A),
                                              ord=2)) <= 1e-8


def test_invit_launches_two_kernels_a_round(cuda):
    d, e = _tridiag(200, 3, cuda)
    e2, scal = bisect_inputs(d, e)
    lam = kernel.bisect_sturm(d, e2, torch.arange(40, device=cuda), scal)
    cid = torch.zeros(40, dtype=torch.int32, device=cuda)
    X0 = normalize_columns(start_block(200, 40, None, cuda))
    kernel.reset_launches()
    kernel.invit(d, e, lam, cid, _pivmin(d, e), X0, iters=2)
    assert kernel.launch_counts()["invit"] == 2 * kernel.LAUNCHES_PER_ROUND


def test_td_solve_on_the_card_launches_both_kernels(cuda):
    p = dft_like(256, device=cuda)
    kernel.reset_launches()
    res = solve(p.A, p.B, 8)
    assert kernel.launch_counts() == {"bisect_sturm": 1, "invit": 6}
    # every other instance (the fp32 and bf16 ones too) launched nothing
    assert res.info["kernel_launches"] == {
        k: {"bisect_sturm": 1, "invit": 6}.get(k, 0)
        for k in kernels.launch_counts()}
    assert set(res.info["kernel_launches"]) >= {
        "bisect_sturm", "invit", "symv", "symm_block", "house_panel",
        "syr2k", "rot_apply", "chase_pass", "replay_pass", "gemm",
        "trsm_tile", "band_mv", "syr2k_fp32", "chase_pass_bf16"}
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


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 3001])
def test_symm_block_ragged_tile_edges(cuda, n, p):
    # n around the 64-row tile edge, p around the compiled widths 1, 2, 4
    A = _garbage_lower(n, 10 * n + p, cuda)
    X = _randn((n, p), n + p, cuda)
    Y = symv_kernel.symm_block(A, X)
    Yp = symv_ref.symm_block_upper_ref(A.cpu(), X.cpu())
    assert _within_gamma(Y.cpu(), Yp, A.cpu(), X.cpu())
    assert torch.equal(symv_kernel.symm_block(A, X), Y)


def test_symm_block_reads_one_column_of_the_basis_in_place(cuda):
    n = 1000
    A = _garbage_lower(n, 6, cuda)
    V = _randn((n, 9), 7, cuda)
    x = V[:, 5:6]
    assert x.stride() == (9, 1)
    assert torch.equal(symv_kernel.symm_block(A, x),
                       symv_kernel.symm_block(A, x.contiguous()))


def test_symm_block_never_reads_the_lower_triangle(cuda):
    n = 300
    A = _garbage_lower(n, 8, cuda)
    X = _randn((n, 4), 9, cuda)
    nan_lower = torch.triu(A) + torch.tril(torch.full_like(A, float("nan")),
                                           -1)
    for Xk in (X, X[:, :1]):
        Y = symv_kernel.symm_block(A, Xk)
        assert torch.equal(symv_kernel.symm_block(nan_lower, Xk), Y)
    assert torch.equal(symv_kernel.symv(nan_lower, X[:, 0]),
                       symv_kernel.symv(A, X[:, 0]))


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


def test_ki_solve_on_the_card_launches_symm_block_per_application(cuda):
    p = md_like(200, device=cuda)
    kernels.reset_launches()
    res = solve(p.A, p.B, 6, variant="KI", invert=True, use_kernel=True)
    launches = res.info["kernel_launches"]
    assert launches["symm_block"] == res.info["n_matvec"] > 0
    assert launches["symv"] == 0
    assert res.info["converged"]
    acc = accuracy_report(p.A, p.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12


# ------------------------------------------------------------ the TT path --

def _randn(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(device)


@pytest.mark.parametrize("rows,b,row_start", [
    (37, 5, 10), (40, 8, 0), (12, 8, 8), (21, 16, 9), (33, 4, 32),
    (1000, 16, 16), (3001, 33, 700), (300, 128, 5)])
def test_house_panel_vs_plain(cuda, rows, b, row_start):
    # E is a column slice of a wider matrix, read through its row stride
    M = _randn((rows, b + 7), rows + b, cuda)
    E = M[:, 3: 3 + b]
    V, T = hp_kernel.house_panel(E, row_start)
    Vp, Tp = hp_ref.house_panel_ref(E.cpu(), row_start)
    # |v| <= 1 and |T| <= 2: the entries agree to rounding of O(rows) sums
    assert torch.abs(V.cpu() - Vp).max() <= 1e-12
    assert torch.abs(T.cpu() - Tp).max() <= 1e-12
    V2, T2 = hp_kernel.house_panel(E, row_start)
    assert torch.equal(V2, V) and torch.equal(T2, T)


def _gamma(m):
    u = torch.finfo(torch.float64).eps / 2
    return m * u / (1 - m * u)


@pytest.mark.parametrize("n,k", [(1, 1), (31, 16), (33, 17), (100, 3),
                                 (1000, 16), (1025, 40)])
@pytest.mark.parametrize("sym", [False, True])
def test_syr2k_vs_plain(cuda, n, k, sym):
    C = _randn((n, n), n, cuda)
    V = _randn((n, k), n + 1, cuda)
    W = _randn((n, k), n + 2, cuda)
    out = syr2k_kernel.syr2k(C, V, W, alpha=-1.0, symmetrize=sym)
    Ch, Vh, Wh = C.cpu(), V.cpu(), W.cpu()
    R = syr2k_ref.syr2k_ref(Ch, Vh, Wh, -1.0)
    absC = Ch.abs()
    bound = _gamma(2 * k + 1) * (absC + Vh.abs() @ Wh.abs().mT
                                 + Wh.abs() @ Vh.abs().mT)
    if sym:
        R = 0.5 * (R + R.mT)
        bound = 0.5 * (bound + bound.mT)
        assert torch.equal(out, out.mT)
    assert bool(torch.all((out.cpu() - R).abs() <= bound))
    # in place on a window view: the same bits
    big = torch.zeros((n + 5, n + 5), dtype=torch.float64, device=cuda)
    win = big[5:, 5:]
    win.copy_(C)
    syr2k_kernel.syr2k(win, V, W, alpha=-1.0, symmetrize=sym, out=win)
    assert torch.equal(win, out)
    assert torch.equal(big[:5], torch.zeros_like(big[:5]))


@pytest.mark.parametrize("G,L", [(1, 1), (7, 5), (1000, 8), (209, 36),
                                 (625, 100), (3, 257), (517, 131),
                                 (1000, 1), (300, 2), (129, 1), (513, 1),
                                 (1, 65535 * 256 + 3)])
def test_rot_apply_bitwise_vs_plain(cuda, G, L):
    pairs = _randn((G, 2, L), G + L, cuda)
    cs = _randn((G, 2), G, cuda)
    out = rot_kernel.rot_apply(pairs, cs)
    assert torch.equal(out.cpu(), rot_ref.rot_apply_ref(pairs.cpu(), cs.cpu()))


def _band(n, w, seed, device):
    C = _randn((n, n), seed, "cpu")
    C = 0.5 * (C + C.mT)
    return sbr.reduce_to_band(C, w=w).Wb.to(device)


@pytest.mark.parametrize("column_major", [False, True])
@pytest.mark.parametrize("n,w", [(9, 7), (40, 4), (97, 16), (200, 5),
                                 (300, 16)])
def test_chase_and_replay_passes_vs_plain(cuda, n, w, column_major):
    Wb = _band(n, w, n * 7 + w, cuda)
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    Wp = torch.zeros((w + 2, npad), dtype=torch.float64, device=cuda)
    if column_major:     # the layout core.sbr.band_chase uses
        Wp = torch.zeros((npad, w + 2), dtype=torch.float64, device=cuda).mT
    Wp[: w + 1, 2: 2 + n] = Wb
    Wp_h = Wp.cpu()
    X = _randn((n, 13), n, cuda)
    Xf, Xr = X.clone(), X.clone()
    tables = []
    for b in sbr._executed_passes(n, w):
        CS = rot_kernel.chase_pass(Wp, b, w, n)
        CS_h = rot_ref.chase_pass_ref(Wp_h, b, w, n)
        # IEEE-rounded sqrt and division and no FMA on either side, the
        # same operations in the same order: the same bits
        assert torch.equal(CS.cpu(), CS_h)
        assert torch.equal(Wp.cpu(), Wp_h)
        tables.append(CS)
        for Xk, reverse in ((Xf, False), (Xr, True)):
            X_h = Xk.cpu()
            rot_kernel.replay_pass(Xk, CS, b, n, reverse=reverse)
            rot_ref.replay_pass_ref(X_h, CS_h, b, n, reverse=reverse)
            assert torch.equal(Xk.cpu(), X_h)
    # repeated launches give the same bits
    Wp2 = torch.zeros_like(Wp)   # the same strides
    Wp2[: w + 1, 2: 2 + n] = Wb
    for b, CS in zip(sbr._executed_passes(n, w), tables):
        assert torch.equal(rot_kernel.chase_pass(Wp2, b, w, n), CS)
    assert torch.equal(Wp2, Wp)


def _chase_pass_both_paths(Wb, w, n, bs):
    """The passes ``bs`` of the band Wb through the cluster path, the
    cooperative path and the plain version (on the card), each bitwise
    against the plain version."""
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    base = torch.zeros((npad, w + 2), dtype=torch.float64,
                       device=Wb.device).mT
    base[: w + 1, 2: 2 + n] = Wb
    paths = {p: base.clone() for p in ("cluster", "cooperative", "plain")}
    for b in bs:
        tables = {"plain": rot_ref.chase_pass_ref(paths["plain"], b, w, n),
                  "cluster": rot_kernel.chase_pass(paths["cluster"], b, w, n),
                  "cooperative": rot_kernel.chase_launch(
                      paths["cooperative"], b, w, n, rot_kernel.COOPERATIVE,
                      rot_kernel.FULL)}
        for p in ("cluster", "cooperative"):
            assert torch.equal(tables[p], tables["plain"]), (p, b)
            assert torch.equal(paths[p], paths["plain"]), (p, b)


def test_chase_pass_every_width_both_paths_bitwise(cuda):
    """Every b from 16 to 2 at n = 1001, whose 1066 padded columns do not
    divide evenly over the cluster's CTAs."""
    n, w = 1001, 16
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    plan = rot_kernel.chase_plan(npad, w, w, rot_kernel.cluster_capacity)
    assert plan.path == "cluster" and npad % plan.csize != 0
    _chase_pass_both_paths(_band(n, w, 5, cuda), w, n, range(w, 1, -1))


def test_chase_pass_band_beyond_the_cluster_takes_the_cooperative_path(cuda):
    """w = 100 at n = 4500: 3.9 MB of band, more than 16 CTAs hold."""
    n, w, b = 4500, 100, 2
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    assert rot_kernel.chase_plan(npad, w, b).path == "cooperative"
    # a band of bandwidth b stored in w + 2 diagonals
    Wb = torch.zeros((w + 1, n), dtype=torch.float64, device=cuda)
    Wb[: b + 1] = _randn((b + 1, n), 17, cuda)
    Wp = torch.zeros((npad, w + 2), dtype=torch.float64, device=cuda).mT
    Wp[: w + 1, 2: 2 + n] = Wb
    Wq = Wp.clone()
    rot_kernel.reset_launches()
    CS = rot_kernel.chase_pass(Wp, b, w, n)
    assert rot_kernel.launch_counts()["chase_pass"] == 1
    CSq = rot_ref.chase_pass_ref(Wq, b, w, n)
    assert torch.equal(CS, CSq) and torch.equal(Wp, Wq)


def _random_tables(n, bs, device, seed):
    """A (J+1, K0+1, 2) table per pass b: random rotations (c, s) in the
    live slots (k < K_j), so that rows stay bounded over many passes; the
    identity past each sweep's end."""
    g = torch.Generator().manual_seed(seed)
    tables = []
    for b in bs:
        _, _, _, J, K0 = rot_sched.pass_schedule(n, b)
        CS = rot_sched.identity_table(J, K0, torch.zeros(1,
                                                         dtype=torch.float64))
        j = torch.arange(J)[:, None]
        live = torch.arange(K0 + 1)[None, :] < (n - 1 - j - b) // b + 1
        theta = 6.3 * torch.rand(int(live.sum()), generator=g,
                                 dtype=torch.float64)
        CS[:J][live] = torch.stack([theta.cos(), theta.sin()], 1)
        tables.append(CS.to(device))
    return tables


def _misaligned(CS):
    """A copy of the table 8 bytes past a 16-byte boundary."""
    flat = torch.empty(CS.numel() + 1, dtype=CS.dtype, device=CS.device)
    out = flat[1:].view(CS.shape)
    out.copy_(CS)
    assert out.is_contiguous() and out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("n,w,ncols", [(40, 4, 2), (97, 16, 13),
                                       (1001, 16, 1), (3000, 16, 301)])
def test_replay_pass_every_path_bitwise_vs_plain(cuda, n, w, ncols):
    """Every pass b = w..2, forward and reverse, through the wrapper (its
    plan: the slab path), the wrapper on a table that is not 16-byte
    aligned (its plan: the sweep path), the sweep kernel forced and the
    slab kernel with the smallest table slices (512 lanes by a few
    sweeps), against the plain version on the host: the same bits, and
    rows past n untouched. 301 columns (odd, more than the card's SMs)
    run in waves."""
    bs = list(range(w, 1, -1))
    tables = _random_tables(n, bs, cuda, n + ncols)
    X = _randn((n + 3, ncols), n, cuda)
    assert rot_kernel.replay_plan(n, ncols).path == "slab"
    assert rot_kernel.replay_plan(n, ncols, False) == rot_kernel.SWEEP
    small = 16 * rot_kernel.REPLAY_CONSUMERS
    plans = {"sweep": rot_kernel.SWEEP,
             "slab, small slices": rot_kernel.ReplayPlan(
                 "slab", ncols, small, rot_kernel.replay_smem(n, small))}
    names = ["wrapper", "wrapper, unaligned table", *plans]
    for reverse in (False, True):
        want = X.cpu()
        got = {name: X.clone() for name in names}
        for b, CS in zip(bs, tables):
            rot_ref.replay_pass_ref(want, CS.cpu(), b, n, reverse)
            rot_kernel.replay_pass(got["wrapper"], CS, b, n, reverse)
            rot_kernel.replay_pass(got["wrapper, unaligned table"],
                                   _misaligned(CS), b, n, reverse)
            for name, plan in plans.items():
                rot_kernel.replay_launch(got[name], CS, b, n, reverse, plan,
                                         rot_kernel.REPLAY_FULL)
            for name in names:
                assert torch.equal(got[name].cpu(), want), (name, b, reverse)


@pytest.mark.parametrize("dt", [torch.float64, *REDUCED])
def test_replay_smem_is_the_kernels(cuda, dt):
    """The plan's shared memory (``replay_smem``) is what the slab kernel
    takes (``replay_slab_smem``), at each entry size, n and b."""
    esize = torch.empty((), dtype=dt).element_size()
    lib = rot_kernel._lib()
    for n in (9, 97, 1001, 9997, 17243):
        for b in (2, 3, 7, 16):
            for stage in (0, 8208, 96208):
                assert lib.replay_slab_smem(n, b, esize, stage) == \
                    rot_kernel.replay_smem(n, stage, dt, b)


def test_replay_pass_counts_one_launch_a_pass(cuda):
    n, b = 500, 5
    (CS,) = _random_tables(n, [b], cuda, 3)
    X = _randn((n, 100), 4, cuda)
    Y = X.cpu()
    rot_kernel.reset_launches()
    rot_kernel.replay_pass(X, CS, b, n, reverse=True)
    assert rot_kernel.launch_counts()["replay_pass"] == 1
    rot_ref.replay_pass_ref(Y, CS.cpu(), b, n, reverse=True)
    assert torch.equal(X.cpu(), Y)


@pytest.mark.parametrize("rows,b,row_start,csize", [
    (9997, 16, 16, 16), (5000, 16, 2000, 8), (700, 16, 100, 1),
    (37, 5, 10, 1), (12, 8, 8, 1), (33, 4, 32, 1), (21, 16, 9, 1),
    (4000, 40, 7, 8)])
def test_house_panel_both_paths_vs_plain(cuda, rows, b, row_start, csize):
    """The cluster path (16 CTAs at the first MD panel, 8 at 3000 active
    rows, one CTA at 600 and below, pivots past the end; b not a power of
    two) and the cooperative path, each within 1e-12 of the plain version
    and bitwise on repeat; the wrapper takes the cluster path."""
    M = _randn((rows, b + 3), rows + b, cuda)
    E = M[:, 1: 1 + b]
    plan = hp_kernel.house_plan(max(rows - row_start, 0), b,
                                hp_kernel.cluster_capacity)
    assert (plan.path, plan.csize) == ("cluster", csize)
    Vp, Tp = hp_ref.house_panel_ref(E.cpu(), row_start)
    first = {}
    for p in (plan, hp_kernel.COOPERATIVE):
        for _ in range(2):
            V = torch.full((rows, b), float("nan"), dtype=torch.float64,
                           device=cuda)
            T = torch.full((b, b), float("nan"), dtype=torch.float64,
                           device=cuda)
            hp_kernel.house_launch(E, row_start, V, T, p, hp_kernel.FULL)
            assert torch.abs(V.cpu() - Vp).max() <= 1e-12, p
            assert torch.abs(T.cpu() - Tp).max() <= 1e-12, p
            V0, T0 = first.setdefault(p.path, (V, T))
            assert torch.equal(V, V0) and torch.equal(T, T0), p
    hp_kernel.reset_launches()
    V, T = hp_kernel.house_panel(E, row_start)
    assert hp_kernel.launch_counts()["house_panel"] == 1
    assert torch.equal(V, first["cluster"][0])
    assert torch.equal(T, first["cluster"][1])


def test_tt_solve_on_the_card_launches_its_kernels(cuda):
    n, s, w = 300, 6, 16
    p = md_like(n, device=cuda)
    kernels.reset_launches()
    res = solve(p.A, p.B, s, variant="TT", band_width=w)
    launches = res.info["kernel_launches"]
    n_panels = len(range(0, n - w - 1, w))
    passes = len(sbr._executed_passes(n, w))
    assert launches["house_panel"] == launches["syr2k"] == n_panels
    assert launches["chase_pass"] == launches["replay_pass"] == passes
    assert launches["bisect_sturm"] == 1 and launches["invit"] > 0
    assert res.info["tt1"]["kernel_launches"] == {"house_panel": n_panels,
                                                  "syr2k": n_panels}
    acc = accuracy_report(p.A, p.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12
    exact = p.exact_evals
    assert float(torch.abs(res.evals - exact[:s]).max()) <= (
        1e-10 * float(exact.abs().max()))


# ------------------------------------------- gemm, trsm_tile and band_mv --

U64 = torch.finfo(torch.float64).eps / 2


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (5, 7, 3), (100, 70, 50),
                                   (129, 257, 65), (300, 1000, 130)])
@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_vs_plain(cuda, m, k, n, trans_a, accumulate):
    # within gamma_(k+1) (|C| + |A||B|): a bound for any order of summation
    # of the k products and the one add of C
    A = _randn((k, m), m, cuda).mT if trans_a else _randn((m, k), m, cuda)
    B = _randn((k, n), k, cuda)
    C = _randn((m, n), n, cuda)
    gemm_kernel.reset_launches()
    if accumulate:
        got = gemm_kernel.gemm(A, B, out=C.clone(), alpha=-0.5,
                               accumulate=True)
        want = C.cpu() - 0.5 * (A.cpu() @ B.cpu())
    else:
        got = gemm_kernel.gemm(A, B)
        want = A.cpu() @ B.cpu()
    # one launch, two where the planner splits K
    assert gemm_kernel.launch_counts() == {
        "gemm": gemm_kernel.plan(m, n, k).launches}
    bound = _gamma(k + 1) * ((C.cpu().abs() if accumulate else 0)
                               + A.cpu().abs() @ B.cpu().abs())
    assert bool(torch.all((got.cpu() - want).abs() <= bound))


@pytest.mark.parametrize("bm,bn,bk", [(16, 16, 8), (32, 128, 16),
                                      (128, 32, 24), (64, 64, 32),
                                      (128, 128, 128)])
def test_gemm_tile_knobs(cuda, bm, bn, bk):
    A, B = _randn((257, 333), 1, cuda), _randn((333, 129), 2, cuda)
    got = gemm_ops.gemm(A, B, bm=bm, bn=bn, bk=bk).cpu()
    want = A.cpu() @ B.cpu()
    bound = _gamma(333) * (A.cpu().abs() @ B.cpu().abs())
    assert bool(torch.all((got - want).abs() <= bound))


def test_gemm_accumulates_into_a_view_and_refuses_other_layouts(cuda):
    A, B = _randn((40, 30), 3, cuda), _randn((30, 20), 4, cuda)
    big = _randn((100, 100), 5, cuda)
    want = big.cpu().clone()
    want[10:50, 60:80] += A.cpu() @ B.cpu()
    gemm_ops.gemm_accum(big[10:50, 60:80], A, B)
    bound = _gamma(31) * (want.abs() + 0)
    bound[10:50, 60:80] += _gamma(31) * (A.cpu().abs() @ B.cpu().abs())
    assert bool(torch.all((big.cpu() - want).abs() <= bound))
    with pytest.raises(ValueError, match="B must be row-major"):
        gemm_kernel.gemm(A, _randn((20, 30), 6, cuda).mT)
    with pytest.raises(ValueError, match="out must be row-major"):
        gemm_kernel.gemm(A, B, out=torch.empty((20, 40), dtype=torch.float64,
                                               device=cuda).mT)
    # the dispatch copies a column-major B rather than misreading it
    Bt = _randn((20, 30), 6, cuda).mT
    assert torch.allclose(gemm_ops.gemm(A, Bt).cpu(), A.cpu() @ Bt.cpu(),
                          rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_split_k_on_odd_views(cuda, trans_a, accumulate):
    # a skinny output (128 x 100, 4 tiles) with K = 990: the planner splits
    # K; every operand a view of a 1001-wide matrix (an odd leading
    # dimension) at an odd offset, as the MD stages pass them
    m, n, k = 128, 100, 990
    p = gemm_kernel.plan(m, n, k)
    assert p.splits > 1 and p.launches == 2
    src = _randn((1100, 1001), 11, cuda)
    A = src[1:1 + k, 7:7 + m].mT if trans_a else src[3:3 + m, 5:5 + k]
    B = _randn((1000, 1001), 12, cuda)[3:3 + k, 11:11 + n]
    big = _randn((200, 1001), 13, cuda)
    C = big[5:5 + m, 9:9 + n]
    C0 = C.cpu().clone()
    gemm_kernel.reset_launches()
    if accumulate:
        got = gemm_kernel.gemm(A, B, out=C, alpha=-0.5, accumulate=True)
        want = C0 - 0.5 * (A.cpu() @ B.cpu())
    else:
        got = gemm_kernel.gemm(A, B, out=C, alpha=-0.5)
        want = -0.5 * (A.cpu() @ B.cpu())
    assert got.data_ptr() == C.data_ptr()
    assert gemm_kernel.launch_counts() == {"gemm": 2}
    bound = _gamma(k + 1) * ((C0.abs() if accumulate else 0)
                               + 0.5 * (A.cpu().abs() @ B.cpu().abs()))
    assert bool(torch.all((got.cpu() - want).abs() <= bound))
    rest = big.cpu()
    rest[5:5 + m, 9:9 + n] = 0.0
    ref = _randn((200, 1001), 13, "cpu")
    ref[5:5 + m, 9:9 + n] = 0.0
    assert torch.equal(rest, ref)           # nothing outside the view moved


def test_gemm_and_trsm_repeat_bitwise(cuda):
    # no atomics: the same call gives the same bits, split K included
    A = _randn((128, 3000), 14, cuda)
    B = _randn((3000, 100), 15, cuda)
    assert gemm_kernel.plan(128, 100, 3000).splits > 1
    assert torch.equal(gemm_ops.gemm(A, B), gemm_ops.gemm(A, B))
    U = _upper(700, 16, cuda)
    Bs = _randn((700, 100), 17, cuda)
    for trans in (False, True):
        assert torch.equal(trsm_ops.trsm(U, Bs, trans=trans),
                           trsm_ops.trsm(U, Bs, trans=trans))


@pytest.mark.parametrize("trans", [False, True])
def test_trsm_tile_full_tile_ragged_columns(cuda, trans):
    # b = 128 (every lane holds four rows) and s not a multiple of the
    # columns of a block, so the last block has idle warps
    b, s = 128, 1001
    assert s % trsm_kernel.warps(s) != 0
    U = _upper(b, 18, cuda)
    B = _randn((b, s), 19, cuda)
    X = trsm_kernel.trsm_tile(U, B.clone(), trans)
    Xp = trsm_ref.trsm_tile_ref(U.cpu(), B.cpu(), trans)
    assert float((X.cpu() - Xp).abs().max()) <= 1e-12 * float(Xp.abs().max())
    Uc = U.cpu().mT if trans else U.cpu()
    assert float(torch.linalg.matrix_norm(Uc @ X.cpu() - B.cpu())) <= \
        _solve_bar(U.cpu(), X.cpu())


def _upper(n, seed, device):
    # well conditioned: kappa(U) < 10
    return (torch.triu(_randn((n, n), seed, "cpu"))
            + n * torch.eye(n, dtype=torch.float64)).to(device)


def _solve_bar(U, X):
    """n eps ||U|| ||X|| (Frobenius): the substitution's backward error,
    componentwise gamma_n |U||X|, bounds ||U X - B|| by it."""
    n = U.shape[0]
    return 2 * n * U64 * float(torch.linalg.matrix_norm(U)
                               * torch.linalg.matrix_norm(X))


@pytest.mark.parametrize("b,s", [(1, 1), (13, 5), (64, 65), (128, 300)])
@pytest.mark.parametrize("trans", [False, True])
def test_trsm_tile_vs_plain(cuda, b, s, trans):
    U = _upper(b, b, cuda)
    B = _randn((b, s), s, cuda)
    trsm_kernel.reset_launches()
    X = trsm_kernel.trsm_tile(U, B.clone(), trans)
    assert trsm_kernel.launch_counts() == {"trsm_tile": 1}
    Xp = trsm_ref.trsm_tile_ref(U.cpu(), B.cpu(), trans)
    # both backward stable on a kappa < 10 tile: they agree to ~b u kappa
    assert float((X.cpu() - Xp).abs().max()) <= 1e-12 * float(Xp.abs().max())
    Uc = U.cpu().mT if trans else U.cpu()
    assert float(torch.linalg.matrix_norm(Uc @ X.cpu() - B.cpu())) <= \
        _solve_bar(U.cpu(), X.cpu())


@pytest.mark.parametrize("n,s,block", [(1, 1, 128), (97, 5, 32),
                                       (300, 7, 128), (300, 0, 64),
                                       (257, 130, 128), (200, None, 64)])
@pytest.mark.parametrize("trans", [False, True])
def test_trsm_vs_plain(cuda, n, s, block, trans):
    U = _upper(n, n, cuda)
    B = _randn((n,) if s is None else (n, s), n + 1, cuda)
    gemm_kernel.reset_launches()
    trsm_kernel.reset_launches()
    X = trsm_ops.trsm(U, B, trans=trans, block=block)
    tiles = -(-n // min(block, n)) if s != 0 else 0
    assert trsm_kernel.launch_counts() == {"trsm_tile": tiles}
    # a product per update, plus a reduce pass where its K is split
    want = trsm_ops.launches(n, 1 if s is None else s, trans, block)
    assert want["trsm_tile"] == tiles
    assert gemm_kernel.launch_counts() == {"gemm": want["gemm"]}
    Xp = trsm_ref.trsm_blocked_ref(U.cpu(), B.cpu(), trans=trans, block=block)
    assert X.shape == B.shape
    if s != 0:
        assert float((X.cpu() - Xp).abs().max()) <= \
            1e-12 * float(Xp.abs().max())
        Xm = X.cpu().reshape(n, -1)
        Uc = U.cpu().mT if trans else U.cpu()
        assert float(torch.linalg.matrix_norm(
            Uc @ Xm - B.cpu().reshape(n, -1))) <= _solve_bar(U.cpu(), Xm)


def test_trsm_reads_a_column_major_u_and_refuses_bad_tiles(cuda):
    n = 150
    U = _upper(n, 7, cuda)
    B = _randn((n, 4), 8, cuda)
    Ucm = U.mT.contiguous().mT          # the same matrix, column-major
    X = trsm_ops.trsm(Ucm, B, trans=True)
    Xp = trsm_ref.trsm_blocked_ref(U.cpu(), B.cpu(), trans=True)
    assert float((X.cpu() - Xp).abs().max()) <= 1e-12 * float(Xp.abs().max())
    with pytest.raises(ValueError, match="at most 128"):
        trsm_ops.trsm(U, B, block=256)
    with pytest.raises(ValueError, match="X must be row-major"):
        trsm_kernel.trsm_tile(U[:16, :16], B[:16].mT.contiguous().mT)


def _band_problem(n, w, seed):
    A = _randn((n, n), seed, "cpu")
    A = 0.5 * (A + A.mT)
    idx = torch.arange(n)
    A = torch.where((idx[:, None] - idx[None, :]).abs() <= w, A, 0.0)
    return A, bmv_ref.dense_to_band(A, w)


@pytest.mark.parametrize("n,w", [(1, 0), (37, 1), (300, 16), (1000, 3),
                                 (20, 25), (129, 0), (2500, 16), (333, 7),
                                 (400, 200)])
@pytest.mark.parametrize("transposed", [False, True])
def test_band_mv_vs_plain(cuda, n, w, transposed):
    """Staged (where the window fits; (400, 200) takes the direct kernel)
    at ragged n, w = 0 and w >= n: within gamma_(2w+1) of the plain
    version, bitwise on repeat, and bitwise against the direct kernel and
    across layouts and block heights (every one sums a row in the same
    order)."""
    A, band = _band_problem(n, w, n + w)
    x = _randn((n,), n, "cpu")
    bd = band.to(cuda)
    if transposed:          # the TT pipeline's lower band, as a view
        bd = bd.mT.contiguous().mT
    xd = x.to(cuda)
    bmv_kernel.reset_launches()
    y = bmv_ops.band_mv(bd, xd, w, bm=64)
    assert bmv_kernel.launch_counts() == {"band_mv": 1}
    # within gamma_(2w+1) |A| |x|: at most 2w+1 products a row
    bound = _gamma(2 * w + 1) * (A.abs() @ x.abs())
    assert bool(torch.all((y.cpu() - bmv_ref.band_mv_ref(band, x)).abs()
                          <= 2 * bound))
    assert torch.equal(bmv_ops.band_mv(bd, xd, w, bm=64), y)
    assert torch.equal(bmv_kernel.band_mv_launch(bd, xd, w, 64, 0), y)
    assert torch.equal(bmv_ops.band_mv(band.to(cuda), xd, w, bm=128), y)
    assert torch.equal(bmv_ops.band_mv(bd, xd, w, bm=1), y)
    # a row stride past w + 1: rows of a wider array
    wide = torch.zeros((n, w + 3), dtype=torch.float64, device=cuda)
    wide[:, : w + 1] = band.to(cuda)
    assert torch.equal(bmv_ops.band_mv(wide[:, : w + 1], xd, w), y)
    assert (bmv_kernel.band_mv_plan(n, w, 64) == 0) == ((n, w) == (400, 200))


def test_blocked_stages_on_the_card_launch_their_kernels(cuda):
    n, s = 300, 6
    p = md_like(n, device=cuda)
    kernels.reset_launches()
    U = cholesky_blocked(p.B, 64)
    C = to_standard_sygst(p.A, U, 64)
    res = tridiagonalize_blocked(C, 32)
    counts = kernels.launch_counts()
    assert counts["gemm"] > 0 and counts["trsm_tile"] > 0
    assert counts["syr2k"] > 0
    Uf = cholesky_upper(p.B)
    Cf = to_standard_two_trsm(p.A, Uf)
    scale = float(p.exact_evals.abs().max())
    assert float((U - Uf).abs().max()) <= 1e-12
    assert float((C - Cf).abs().max()) <= 1e-12 * scale
    ref_res = tridiagonalize(Cf)
    assert float((res.d - ref_res.d).abs().max()) <= 1e-11 * scale
    kernels.reset_launches()
    out = solve(p.A, p.B, s, gs1="blocked", gs2="sygst", td1="blocked",
                block=64)
    assert out.info["kernel_launches"]["trsm_tile"] > 0
    acc = accuracy_report(p.A, p.B, out.X, out.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12
    assert float((out.evals - p.exact_evals[:s]).abs().max()) <= 1e-10 * scale


# ---------------------------------------------- the fp32 and bf16 instances --

#: unit roundoff of fp32 (the reduced instances' compute dtype) and of each
#: storage dtype
U32 = 2.0 ** -24
U_STORE = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def _gamma32(k):
    return k * U32 / (1 - k * U32)


def _panel_ratio(got, want, rows, us):
    """max |got - want| / the reduced panel's bar, entry (i, j) of V or T
    within 4 sqrt(rows) u(fp32) max(|x_ij|, ||x_:j|| / sqrt(m)) + 2 u_store
    |x_ij| (m the matrix's rows; chip_smoke.py's PANEL_C says where the 4
    comes from)."""
    got, want = got.cpu().double(), want.cpu().double()
    col = torch.linalg.vector_norm(want, dim=0, keepdim=True)
    scale = torch.maximum(want.abs(), col / want.shape[0] ** 0.5)
    bar = 4 * rows ** 0.5 * U32 * scale + 2 * us * want.abs()
    return float(((got - want).abs() / bar).max())


@pytest.mark.parametrize("dt", REDUCED)
@pytest.mark.parametrize("n,k", [(1, 1), (33, 17), (130, 16), (1000, 16)])
@pytest.mark.parametrize("sym", [False, True])
def test_syr2k_reduced_bitwise_vs_plain(cuda, dt, n, k, sym):
    g = torch.Generator().manual_seed(n + k)
    C, V, W = (torch.randn(shape, generator=g).to(dt)
               for shape in ((n, n), (n, k), (n, k)))
    C = (C + C.mT).to(dt)
    plain = syr2k_ref.syr2k_reduced_ref(C, V, W, -1.0, sym)
    kernels.reset_launches()
    got = syr2k_kernel.syr2k(C.to(cuda), V.to(cuda), W.to(cuda), -1.0, sym)
    name = "syr2k_fp32" if dt == torch.float32 else "syr2k_bf16"
    assert kernels.launch_counts()[name] == 1
    assert kernels.launch_counts()["syr2k"] == 0
    assert got.dtype == dt and torch.equal(got.cpu(), plain)


@pytest.mark.parametrize("dt", REDUCED)
@pytest.mark.parametrize("rows,b,row_start,csize", [
    (24, 4, 3, 1), (1000, 16, 16, 2), (9997, 16, 16, 16), (500, 64, 20, 1),
    (700, 64, 10, 2), (3000, 32, 7, 8)])
def test_house_panel_reduced_vs_plain(cuda, dt, rows, b, row_start, csize):
    """The wrapper's plan (the cluster kernel, at ``csize`` CTAs) and the
    cooperative instance forced, each against the plain panel factored in
    fp32 (rounded to bf16 at the store): within the panel's bar
    (``_panel_ratio``), which the panel computed in bf16 arithmetic and a V
    zeroed below its pivots fail; each bitwise on repeat. The wrapper
    counts one launch of the dtype's instance, on the cluster path."""
    from repro_torch.kernels.house_panel import ops as hp_ops
    E = torch.randn((rows, b), generator=torch.Generator().manual_seed(rows),
                    dtype=torch.float64).to(dt)
    Vp, Tp = hp_ops.house_panel(E, row_start)
    Ek = E.to(cuda)
    plan = hp_kernel.house_plan(max(rows - row_start, 0), b,
                                hp_kernel.cluster_capacity, dt)
    assert (plan.path, plan.csize) == ("cluster", csize)
    us = U_STORE[dt]
    first = {}
    for p in (plan, hp_kernel.COOPERATIVE):
        for _ in range(2):
            V = torch.full((rows, b), float("nan"), dtype=dt, device=cuda)
            T = torch.full((b, b), float("nan"), dtype=dt, device=cuda)
            hp_kernel.house_launch(Ek, row_start, V, T, p, hp_kernel.FULL)
            assert _panel_ratio(V, Vp, rows, us) <= 1.0, p
            assert _panel_ratio(T, Tp, rows, us) <= 1.0, p
            V0, T0 = first.setdefault(p.path, (V, T))
            assert torch.equal(V, V0) and torch.equal(T, T0), p
    sfx = "fp32" if dt == torch.float32 else "bf16"
    kernels.reset_launches()
    V, T = hp_kernel.house_panel(Ek, row_start)
    assert V.dtype == dt and T.dtype == dt
    assert kernels.launch_counts()[f"house_panel_{sfx}"] == 1
    paths = kernels.path_counts()
    assert paths[f"house_panel_{sfx}_cluster"] == 1
    assert paths[f"house_panel_{sfx}_cooperative"] == 0
    assert torch.equal(V, first["cluster"][0])
    assert torch.equal(T, first["cluster"][1])
    if rows > 100:
        Vc, Tc = hp_ref.house_panel_ref(E.to(torch.bfloat16), row_start)
        assert _panel_ratio(Vc, Vp, rows, us) > 1.0
        assert _panel_ratio(Tc, Tp, rows, us) > 1.0
        Vz = V.cpu().clone()
        Vz[row_start + b + 1:] = 0
        assert _panel_ratio(Vz, Vp, rows, us) > 1.0


@pytest.mark.parametrize("dt", REDUCED)
@pytest.mark.parametrize("G,L", [(1, 1), (1000, 8), (625, 100)])
def test_rot_apply_reduced_bitwise_vs_plain(cuda, dt, G, L):
    g = torch.Generator().manual_seed(G + L)
    pairs = torch.randn((G, 2, L), generator=g).to(dt)
    th = 6.283185307179586 * torch.rand((G,), generator=g)
    cs = torch.stack([torch.cos(th), torch.sin(th)], 1).to(dt)
    got = rot_kernel.rot_apply(pairs.to(cuda), cs.to(cuda))
    assert torch.equal(got.cpu(), rot_ref.rot_apply_ref(pairs, cs))


@pytest.mark.parametrize("dt", REDUCED)
@pytest.mark.parametrize("n,w", [(9, 7), (97, 16), (500, 16), (1001, 16)])
def test_chase_and_replay_reduced_bitwise_vs_plain(cuda, dt, n, w):
    """The reduced chase through both its kernels (the wrapper's plan, the
    cluster kernel; the cooperative kernel forced) and the reduced replay
    through both of its (the wrapper's plan, the slab kernel; the slab with
    its smallest table slices; the sweep kernel forced), pass by pass,
    forward and reverse, bitwise against the plain versions (the same
    rounding points), with one count of the dtype's instance a pass on the
    plan's path. Most passes' table rows here are not 16-byte aligned
    (pairs of 8 or 4 bytes, K0+1 pairs a row)."""
    prob = md_like(n)
    C = to_standard_two_trsm(prob.A, cholesky_upper(prob.B))
    Wb = sbr.reduce_to_band(C, w=w).Wb.to(dt).cpu()
    Wk = rot_sched.padded_band(Wb, w).to(cuda)
    Wc = Wk.clone()
    Wq = rot_sched.padded_band(Wb, w)
    passes = sbr._executed_passes(n, w)
    sfx = "fp32" if dt == torch.float32 else "bf16"
    esize = Wb.element_size()
    assert any(((pass_k0 + 1) * 2 * esize) % 16 for pass_k0 in (
        rot_sched.pass_schedule(n, b)[4] for b in passes))
    for b in passes:
        assert rot_kernel.chase_plan(Wk.shape[1], w, b,
                                     dtype=dt).path == "cluster"
    kernels.reset_launches()
    tk = [rot_kernel.chase_pass(Wk, b, w, n) for b in passes]
    assert kernels.launch_counts()[f"chase_pass_{sfx}"] == len(passes)
    assert kernels.path_counts()[f"chase_pass_{sfx}_cluster"] == len(passes)
    tc = [rot_kernel.chase_launch(Wc, b, w, n, rot_kernel.COOPERATIVE,
                                  rot_kernel.FULL) for b in passes]
    tq = [rot_ref.chase_pass_lanes_ref(Wq, b, w, n) for b in passes]
    assert torch.equal(Wk.cpu(), Wq) and torch.equal(Wc.cpu(), Wq)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tk, tq))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tc, tq))
    Z = torch.randn((n, 7), generator=torch.Generator().manual_seed(n)).to(dt)
    for reverse in (True, False):
        order = list(zip(passes, tk, tq))
        if reverse:
            order = order[::-1]
        kernels.reset_launches()
        Yk, Yq = Z.to(cuda), Z.clone()
        Ys, Yl = Z.to(cuda), Z.to(cuda)
        for b, CSk, CSq in order:
            assert rot_kernel.replay_plan(n, 7, True, dt, b).path == "slab"
            small = 2 * esize * rot_kernel.REPLAY_CONSUMERS \
                + rot_kernel.slice_pad(esize)
            least = rot_kernel.ReplayPlan(
                "slab", 7, small, rot_kernel.replay_smem(n, small, dt, b))
            rot_kernel.replay_pass(Yk, CSk, b, n, reverse)
            rot_kernel.replay_launch(Ys, CSk, b, n, reverse, rot_kernel.SWEEP,
                                     rot_kernel.REPLAY_FULL)
            rot_kernel.replay_launch(Yl, CSk, b, n, reverse, least,
                                     rot_kernel.REPLAY_FULL)
            rot_ref.replay_pass_ref(Yq, CSq, b, n, reverse)
            for Y in (Yk, Ys, Yl):
                assert torch.equal(Y.cpu(), Yq), (b, reverse)
        assert kernels.launch_counts()[f"replay_pass_{sfx}"] == len(passes)
        assert kernels.path_counts()[f"replay_pass_{sfx}_slab"] == \
            len(passes)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_reduced_tt_solve_takes_the_cluster_and_slab_paths(cuda, precision):
    """A TT solve at a demoted level (n = 400, w = 16: 24 panels, 15
    passes) runs all its panels and chase passes on the cluster kernels and
    all its replay passes on the slab kernel, counted by path."""
    prob = md_like(400, device=cuda)
    sfx = {"mixed": "fp32", "fast": "bf16"}[precision]
    n_pass = len(sbr._executed_passes(400, 16))
    assert n_pass == 15
    kernels.reset_launches()
    solve(prob.A, prob.B, 8, variant="TT", band_width=16,
          precision=precision, on_failure="recover")
    paths = kernels.path_counts()
    assert paths[f"house_panel_{sfx}_cluster"] == sbr._n_panels(400, 16)
    assert paths[f"house_panel_{sfx}_cooperative"] == 0
    assert paths[f"chase_pass_{sfx}_cluster"] == n_pass
    assert paths[f"chase_pass_{sfx}_cooperative"] == 0
    assert paths[f"replay_pass_{sfx}_slab"] == n_pass
    assert paths[f"replay_pass_{sfx}_sweep"] == 0


@pytest.mark.parametrize("dt", REDUCED)
@pytest.mark.parametrize("n,p", [(1, 1), (65, 2), (1000, 1), (1000, 4),
                                 (129, 5)])
def test_symm_block_reduced_vs_plain(cuda, dt, n, p):
    """fp32 sums in the kernel's order and the plain version's: within
    2 gamma_n(fp32) |sym(triu A)||X| + 2 u_store |Y|, and bitwise on
    repeat."""
    g = torch.Generator().manual_seed(n * p)
    A = torch.randn((n, n), generator=g, dtype=torch.float64)
    A = (A + A.mT + torch.tril(1e3 * torch.ones(n, n), -1)).to(dt)
    X = torch.randn((n, p), generator=g).to(dt)
    plain = symv_ref.symm_block_upper_ref(A, X).double()
    got = symv_kernel.symm_block(A.to(cuda), X.to(cuda))
    Ad = A.double()
    mag = (torch.triu(Ad).abs() + torch.triu(Ad, 1).abs().mT) @ X.double().abs()
    bar = 2 * _gamma32(n) * mag + 2 * U_STORE[dt] * plain.abs()
    assert got.dtype == dt
    assert torch.all((got.cpu().double() - plain).abs() <= bar)
    assert torch.equal(got, symv_kernel.symm_block(A.to(cuda), X.to(cuda)))
    y = symv_kernel.symv(A.to(cuda), X[:, 0].to(cuda))
    assert torch.all((y.cpu().double() - plain[:, 0]).abs() <= bar[:, 0])


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_demoted_solves_on_the_card_launch_the_reduced_instances(cuda,
                                                                 precision):
    """TT and KE at a demoted level launch the level's instances and meet
    the Table-3 bars after refinement (escalating to fp64 if it stalls)."""
    prob = md_like(400, device=cuda)
    sfx = {"mixed": "fp32", "fast": "bf16"}[precision]
    res = solve(prob.A, prob.B, 8, variant="TT", band_width=16,
                precision=precision, on_failure="recover")
    counts = res.info["kernel_launches"]
    n_pass = len(sbr._executed_passes(400, 16))
    assert counts[f"house_panel_{sfx}"] == counts[f"syr2k_{sfx}"] > 0
    assert counts[f"chase_pass_{sfx}"] == counts[f"replay_pass_{sfx}"] \
        == n_pass
    res = solve(prob.A, prob.B, 8, variant="KE", invert=True,
                use_kernel=True, precision=precision, on_failure="recover")
    assert res.info["kernel_launches"][f"symm_block_{sfx}"] > 0
    acc = accuracy_report(prob.A, prob.B, res.X, res.evals)
    assert float(acc.relative_residual) <= 1e-12
    assert float(acc.b_orthogonality) <= 1e-12


# ---------- the reduced product and syr2k by load path (wide, narrow) --

def _in_layout(M, path):
    """M on the card in a layout that takes ``path``: a padded copy (rows
    on 16-byte boundaries) for ``wide``; for ``narrow`` a view one entry
    into a padded copy of one more column (every row's start off a
    16-byte boundary)."""
    rows, cols = M.shape
    if path == "wide":
        return padded_copy(M.cuda(), M.dtype)
    big = padded_copy(torch.zeros((rows, cols + 1), dtype=M.dtype,
                                  device="cuda"), M.dtype)
    view = big[:, 1:]
    view.copy_(M)
    return view


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("path", ["wide", "narrow"])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("n,k", [(7, 3), (33, 17), (64, 16), (130, 16),
                                 (1000, 16), (333, 40), (70, 0)])
@pytest.mark.parametrize("dt", REDUCED)
def test_syr2k_pairs_bitwise_vs_plain(cuda, dt, n, k, sym, path, inplace):
    """The reduced syr2k on either path (wide: syr2k_pairs; narrow:
    syr2k_tiles), into a new tensor or in place, bitwise against
    ``syr2k_reduced_ref``, one launch counted on its path."""
    g = torch.Generator().manual_seed(7 * n + k)
    C = torch.randn((n, n), generator=g)
    C = (C + C.mT).to(dt)
    V, W = (torch.randn((n, k), generator=g).to(dt) for _ in range(2))
    plain = syr2k_ref.syr2k_reduced_ref(C, V, W, -1.0, sym)
    Ck = _in_layout(C, path)
    kernels.reset_launches()
    got = syr2k_kernel.syr2k(Ck, V.to(cuda), W.to(cuda), -1.0, sym,
                             out=Ck if inplace else None)
    sfx = "fp32" if dt == torch.float32 else "bf16"
    # an (n, n) output of its own is contiguous: wide where n entries
    # fill whole 16-byte vectors
    want = path if inplace or path == "narrow" else (
        "wide" if n * C.element_size() % 16 == 0 else "narrow")
    assert kernels.path_counts()[f"syr2k_{sfx}_{want}"] == 1
    assert sum(kernels.path_counts().values()) == 1
    assert torch.equal(got.cpu(), plain)
    if inplace:
        assert got.data_ptr() == Ck.data_ptr()


@pytest.mark.parametrize("offset,path", [(16, "wide"), (3, "narrow")])
@pytest.mark.parametrize("dt", REDUCED)
def test_syr2k_pairs_on_a_tt1_window(cuda, dt, offset, path):
    """The TT1 sweep's call: in place on a window M[o:, o:] of a padded
    working copy, symmetrized; o = 16 keeps 16-byte rows (wide), o = 3
    does not (narrow); bitwise against the plain version, and the entries
    outside the window untouched."""
    n, k = 517, 16
    g = torch.Generator().manual_seed(offset)
    B = torch.randn((n, n), generator=g)
    M = padded_copy((B + B.mT).to(dt).cuda(), dt)
    before = M.clone()
    win = M[offset:, offset:]
    m = n - offset
    V, W = (torch.randn((m, k), generator=g).to(dt) for _ in range(2))
    plain = syr2k_ref.syr2k_reduced_ref(win.cpu(), V, W, -1.0, True)
    kernels.reset_launches()
    syr2k_kernel.syr2k(win, V.to(cuda), W.to(cuda), -1.0, True, out=win)
    sfx = "fp32" if dt == torch.float32 else "bf16"
    assert kernels.path_counts()[f"syr2k_{sfx}_{path}"] == 1
    assert torch.equal(win.cpu(), plain)
    assert torch.equal(M[:offset], before[:offset])
    assert torch.equal(M[:, :offset], before[:, :offset])


@pytest.mark.parametrize("path", ["wide", "narrow"])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("n", [8, 65, 128, 129, 1000, 3001])
@pytest.mark.parametrize("dt", REDUCED)
def test_symm_block_16_byte_paths_within_gamma(cuda, dt, n, p, path):
    """symm_wide on either path: within the reduced product's bar of the
    plain version (fp32 sums in other orders, then one rounding to the
    storage dtype), bitwise on a second launch, one launch counted on its
    path; symv the same at p = 1."""
    g = torch.Generator().manual_seed(n + 10 * p)
    A = torch.randn((n, n), generator=g, dtype=torch.float64)
    A = (A + A.mT + torch.tril(1e3 * torch.ones(n, n), -1)).to(dt)
    X = torch.randn((n, p), generator=g).to(dt)
    plain = symv_ref.symm_block_upper_ref(A, X).double()
    Ak = _in_layout(A, path)
    sfx = "fp32" if dt == torch.float32 else "bf16"
    kernels.reset_launches()
    got = symv_kernel.symm_block(Ak, X.to(cuda))
    assert kernels.path_counts()[f"symm_block_{sfx}_{path}"] == 1
    Ad = A.double()
    mag = (torch.triu(Ad).abs() + torch.triu(Ad, 1).abs().mT) @ X.double().abs()
    bar = 2 * _gamma32(n) * mag + 2 * U_STORE[dt] * plain.abs()
    assert got.dtype == dt
    assert torch.all((got.cpu().double() - plain).abs() <= bar)
    assert torch.equal(symv_kernel.symm_block(Ak, X.to(cuda)), got)
    if p == 1:
        y = symv_kernel.symv(Ak, X[:, 0].to(cuda))
        assert kernels.path_counts()[f"symv_{sfx}_{path}"] == 1
        assert torch.all((y.cpu().double() - plain[:, 0]).abs() <= bar[:, 0])


@pytest.mark.parametrize("path", ["wide", "narrow"])
@pytest.mark.parametrize("dt", REDUCED)
def test_symm_block_16_byte_never_reads_the_lower_triangle(cuda, dt, path):
    """NaN strictly below the diagonal (also inside a 16-byte vector that
    crosses it) changes no bit of the reduced product on either path."""
    n = 300
    g = torch.Generator().manual_seed(8)
    A = torch.randn((n, n), generator=g).to(dt)
    X = torch.randn((n, 4), generator=g).to(dt)
    nan_lower = torch.triu(A) + torch.tril(
        torch.full((n, n), float("nan")), -1).to(dt)
    Ak, Nk = _in_layout(A, path), _in_layout(nan_lower, path)
    for Xk in (X.to(cuda), X[:, :1].to(cuda)):
        assert torch.equal(symv_kernel.symm_block(Nk, Xk),
                           symv_kernel.symm_block(Ak, Xk))
    assert torch.equal(symv_kernel.symv(Nk, X[:, 0].to(cuda)),
                       symv_kernel.symv(Ak, X[:, 0].to(cuda)))


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_demoted_solves_take_the_wide_paths(cuda, precision):
    """A TT and a KE solve at a demoted level, at an n whose rows are no
    multiple of 16 bytes, run the reduced syr2k and product on their wide
    paths only: the working copies are padded."""
    n = 403
    prob = md_like(n, device=cuda)
    sfx = {"mixed": "fp32", "fast": "bf16"}[precision]
    kernels.reset_launches()
    solve(prob.A, prob.B, 8, variant="TT", band_width=16,
          precision=precision, on_failure="recover")
    paths = kernels.path_counts()
    assert paths[f"syr2k_{sfx}_wide"] > 0
    assert paths[f"syr2k_{sfx}_narrow"] == 0
    kernels.reset_launches()
    solve(prob.A, prob.B, 8, variant="KE", invert=True, use_kernel=True,
          precision=precision, on_failure="recover")
    paths = kernels.path_counts()
    assert paths[f"symm_block_{sfx}_wide"] > 0
    assert paths[f"symm_block_{sfx}_narrow"] == 0


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_demoted_blocked_td1_takes_the_wide_path(cuda, precision):
    """The blocked TD1 at a demoted level, at an n whose rows are no
    multiple of 16 bytes, runs every panel's reduced syr2k on the wide
    path: its working copy is padded."""
    n = 403
    prob = md_like(n, device=cuda)
    sfx = {"mixed": "fp32", "fast": "bf16"}[precision]
    kernels.reset_launches()
    res = solve(prob.A, prob.B, 8, variant="TD", td1="blocked",
                precision=precision, on_failure="recover")
    paths = kernels.path_counts()
    assert paths[f"syr2k_{sfx}_wide"] > 0
    assert paths[f"syr2k_{sfx}_narrow"] == 0
    assert torch.isfinite(res.evals).all()


# ---- batched buckets: CUDA graphs per piece ---------------------------------

BATCHED_N, BATCHED_S, BATCHED_B = 256, 6, 3


def _bucket(cuda, k=BATCHED_B):
    probs = [md_like(BATCHED_N, seed=500 + i, device=cuda) for i in range(k)]
    return (probs, torch.stack([p.A for p in probs]),
            torch.stack([p.B for p in probs]))


@pytest.mark.parametrize("variant,precision", [
    ("TD", "fp64"), ("TT", "fp64"), ("KE", "fp64"), ("KI", "fp64"),
    ("TT", "mixed"), ("KE", "mixed")])
def test_batched_bucket_matches_eager_solves(cuda, variant, precision):
    """One bucket per variant at n=256 through CUDA graphs against eager
    solves of its pencils: eigenvalues within 1e-10 max|lambda| (Table-3
    scale below fp64), the cold call captured and the warm one a cache
    hit, and for TD/TT batch times the eager launches in the graphs."""
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    probs, A, B = _bucket(cuda)
    krylov = variant in ("KE", "KI")
    kw = dict(variant=variant, band_width=16, invert=krylov,
              precision=precision, use_kernel=krylov)
    cold = batched.solve_batched(A, B, BATCHED_S, **kw)
    warm = batched.solve_batched(A, B, BATCHED_S, **kw)
    assert cold.info["cache_hit"] is False and cold.info["compile_s"] > 0
    assert warm.info["cache_hit"] is True and warm.info["compile_s"] == 0.0
    assert warm.info["path"] == "cuda_graphs"
    assert torch.equal(cold.evals, warm.evals)
    assert warm.converged.all() and warm.healthy.all()
    bar = 1e-10 if precision == "fp64" else 1e-11
    eager_launches = dict.fromkeys(kernels.launch_counts(), 0)
    for i, p in enumerate(probs):
        one = solve(p.A, p.B, BATCHED_S, variant=variant, band_width=16,
                    invert=krylov, precision=precision, use_kernel=krylov)
        scale = float(p.exact_evals.abs().max())
        assert float((warm.evals[i] - one.evals).abs().max()) <= bar * scale
        acc = accuracy_report(p.A, p.B, warm.X[i], warm.evals[i])
        assert float(acc.relative_residual) <= 1e-12
        assert float(acc.b_orthogonality) <= 1e-12
        for k, v in one.info["kernel_launches"].items():
            eager_launches[k] += v
    if not krylov:
        assert warm.info["kernel_launches"] == eager_launches
    else:
        per = warm.info["graph_launches"]["krylov_restart"]
        assert warm.info["graph_replays"]["krylov_restart"] == warm.info[
            "restarts"]
        assert sum(warm.info["kernel_launches"].values()) > 0
        assert per == {} or all(v > 0 for v in per.values())


def test_batched_capture_runs_no_collection(cuda):
    """A dropped bucket's graphs wait in a reference cycle for the
    collector; a collection inside the next bucket's capture destroys
    them mid-capture, which a capturing stream does not permit, and the
    capture fails (phase 4c of chip_smoke.py hit it once). With a
    collection due at every allocation, none may start while a stream
    captures."""
    import gc
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    probs, A, B = _bucket(cuda, k=2)
    during = []

    def note(phase, info):
        if phase == "start":
            during.append(torch.cuda.is_current_stream_capturing())

    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(note)
    try:
        res = batched.solve_batched(A, B, BATCHED_S, variant="KE",
                                    invert=True)
    finally:
        gc.callbacks.remove(note)
        gc.set_threshold(*old)
    assert during and not any(during), f"{sum(during)} of {len(during)}"
    assert res.info["path"] == "cuda_graphs"
    assert bool(res.converged.all())
    batched.clear_pipeline_cache()


def test_batched_cuda_call_never_takes_the_eager_path(cuda):
    """A warm call replays graphs only: with every piece's code replaced by
    one that raises, it still returns the same result."""
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    _, A, B = _bucket(cuda)
    first = batched.solve_batched(A, B, BATCHED_S, variant="KE", invert=True)
    (prog,) = batched._EXEC_CACHE.values()

    def boom():
        raise AssertionError("a piece ran eagerly on the card")

    prog._pieces = {name: boom for name in prog._pieces}
    again = batched.solve_batched(A, B, BATCHED_S, variant="KE", invert=True)
    assert torch.equal(first.evals, again.evals)
    assert again.info["cache_hit"] is True


def test_batched_failed_capture_raises(cuda, monkeypatch):
    """A host sync inside a piece fails its capture, which raises: no
    eager fallback, and nothing is cached."""
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    _, A, B = _bucket(cuda)
    sentinel = batched._output_sentinel

    def syncing(lam, X):
        ok = sentinel(lam, X)
        bool(ok)                       # a host read: illegal in a capture
        return ok

    monkeypatch.setattr(batched, "_output_sentinel", syncing)
    with pytest.raises(RuntimeError, match="capturing piece"):
        batched.solve_batched(A, B, BATCHED_S, variant="TD")
    assert batched.cache_stats()["exec_entries"] == 0


def test_batched_filter_bucket_matches_eager_solves(cuda):
    """A KE bucket with a Chebyshev start filter and a block of two: the
    probe's ``eigh`` split and the ``krylov_filter`` graph, against eager
    solves at the same knobs."""
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    probs, A, B = _bucket(cuda)
    kw = dict(variant="KE", invert=True, use_kernel=True, p=2,
              filter_degree=8)
    batched.solve_batched(A, B, BATCHED_S, **kw)
    warm = batched.solve_batched(A, B, BATCHED_S, **kw)
    assert warm.info["cache_hit"] is True
    assert warm.info["graph_replays"]["krylov_filter"] == 1
    assert warm.info["graph_launches"]["krylov_filter"]["symm_block"] > 0
    assert warm.converged.all() and warm.healthy.all()
    for i, p in enumerate(probs):
        one = solve(p.A, p.B, BATCHED_S, variant="KE", invert=True,
                    use_kernel=True, krylov_block=2, filter=8)
        scale = float(p.exact_evals.abs().max())
        assert float((warm.evals[i] - one.evals).abs().max()) <= 1e-10 * scale
        acc = accuracy_report(p.A, p.B, warm.X[i], warm.evals[i])
        assert float(acc.relative_residual) <= 1e-12
        assert float(acc.b_orthogonality) <= 1e-12


def _spectra(kind, cuda, k=BATCHED_B, seed=11):
    """(A, I, exact) stacks with a known spectrum: ``easy`` has its s
    lowest eigenvalues far below a tight cluster (one restart converges),
    ``hard`` is spread evenly over [1, 2] (many restarts)."""
    n, s = BATCHED_N, BATCHED_S
    g = np.random.default_rng(seed)
    As, exact = [], []
    for i in range(k):
        Q, _ = np.linalg.qr(g.standard_normal((n, n)))
        if kind == "easy":
            lam = np.concatenate([-1000.0 - 10.0 * np.arange(s) - i,
                                  1e-6 * g.random(n - s)])
        else:
            lam = g.uniform(1.0, 2.0, n)
        As.append((Q * lam) @ Q.T)
        exact.append(np.sort(lam)[:s])
    A = torch.tensor(np.stack(As), device=cuda)
    B = torch.eye(n, dtype=torch.float64, device=cuda).expand(k, n, n)
    return A, B.contiguous(), torch.tensor(np.stack(exact), device=cuda)


def test_batched_warm_call_replays_pieces_the_cold_call_skipped(cuda):
    """A KE bucket captured on pencils that converge in one restart (its
    loop never segments again) replays the segment's graph for pencils
    that need many restarts: every piece is captured, none runs eagerly."""
    from repro_torch.core import batched
    batched.clear_pipeline_cache()
    kw = dict(variant="KE", use_kernel=True)
    easy, B, _ = _spectra("easy", cuda)
    cold = batched.solve_batched(easy, B, BATCHED_S, **kw)
    assert cold.info["restarts"] == 1
    assert cold.info["graph_replays"].get("krylov_segment", 0) == 0
    (prog,) = batched._EXEC_CACHE.values()
    assert set(prog.graphs) == set(prog._pieces)

    def boom():
        raise AssertionError("a piece ran eagerly on the card")

    prog._pieces = {name: boom for name in prog._pieces}
    hard, B, exact = _spectra("hard", cuda)
    before = kernels.launch_counts()
    warm = batched.solve_batched(hard, B, BATCHED_S, **kw)
    assert kernels.launch_counts() == before      # nothing launched eagerly
    assert warm.info["cache_hit"] is True and warm.info["restarts"] > 1
    assert warm.info["graph_replays"]["krylov_segment"] == (
        warm.info["restarts"] - 1)
    assert warm.converged.all() and warm.healthy.all()
    assert float((warm.evals - exact).abs().max()) <= 1e-10 * 2.0



# ---- the distribution layer on the card (a one-rank NCCL mesh) ------------

def test_invit_solve_and_orth_launches_make_invit(cuda):
    """``invit``'s two launches called one by one (as the distributed TT3
    does) give ``invit``'s Z bit for bit, two launches a round."""
    d, e = _tridiag(300, 5, cuda)
    e2, scal = bisect_inputs(d, e)
    lam = kernel.bisect_sturm(d, e2, torch.arange(24, device=cuda), scal)
    cid = _cluster_ids(lam, _scale(d, e)).to(torch.int32)
    X0 = normalize_columns(start_block(300, 24, None, cuda))
    piv = _pivmin(d, e)
    Z = kernel.invit(d, e, lam, cid, piv, X0)
    kernel.reset_launches()
    Zs = X0.clone()
    for _ in range(3):
        kernel.invit_solve(d, e, lam, piv, Zs)
        kernel.invit_orth(Zs, cid)
    assert torch.equal(Zs, Z)
    assert kernel.launch_counts()["invit"] == 3 * kernel.LAUNCHES_PER_ROUND


def _mesh_solves_on_the_card(mesh, A, B):
    out = {}
    for variant in ("TT", "KE"):
        kernels.reset_launches()
        res = solve(A, B, 6, variant=variant, invert=variant == "KE",
                    mesh=mesh)
        out[variant] = (res.evals, res.X, dict(kernels.launch_counts()),
                        res.info)
    return out


def test_mesh_solves_on_a_one_rank_nccl_mesh(cuda):
    """``solve(mesh=)`` on a (1, 1) NCCL mesh: KE and TT on the card's
    single-device eigenvalues within 1e-10 max|lambda| and the Table-3
    bars; TT launched the panel, chase, replay and TD2 kernels; the
    process group is gone afterwards."""
    import torch.distributed as dist
    from repro_torch.dist.launcher import run_local
    p = md_like(400, device=cuda)
    got = run_local(_mesh_solves_on_the_card, (1, 1), "cuda", p.A, p.B)
    assert not dist.is_initialized()
    scale = float(p.exact_evals.abs().max())
    for variant, (evals, X, launches, info) in got.items():
        assert float((evals - p.exact_evals[:6]).abs().max()) <= 1e-10 * scale
        acc = accuracy_report(p.A, p.B, X, evals)
        assert float(acc.relative_residual) <= 1e-12
        assert float(acc.b_orthogonality) <= 1e-12
        assert info["mesh"] == [1, 1] and info["health"]["healthy"]
    tt = got["TT"][2]
    assert tt["house_panel"] == sbr._n_panels(400, 16)
    assert tt["chase_pass"] == tt["replay_pass"] == 15
    assert tt["bisect_sturm"] == 1 and tt["invit"] == 6


def test_audit_on_the_card(cuda):
    """``run_audit(quick=True)`` (all but the ``solve_batched`` buckets) on
    the card, its default device, the mesh entries on a (1, 1)
    NCCL mesh: every contract met, and every audited program's recorded
    kernel calls equal the launch counters' deltas instance by instance
    (no call on an audited path took the plain version)."""
    import torch.distributed as dist
    from repro_torch.launch.audit import run_audit
    payload = run_audit(quick=True, mesh_shape=(1, 1))    # the card
    assert not dist.is_initialized()
    assert payload["ok"], [(e["name"], e["violations"])
                           for e in payload["entries"] if not e["ok"]]
    assert payload["summary"]["skipped"] == 0
    for e in payload["entries"]:
        for prog in e["programs"] + e["probes"]:
            assert prog["kernel_calls"] == prog["launches"], (
                e["name"], prog["name"])
    launched = {k for e in payload["entries"] for prog in e["programs"]
                for k, v in prog["launches"].items() if v}
    assert {"bisect_sturm", "invit", "symv", "symm_block", "house_panel",
            "syr2k", "rot_apply", "chase_pass", "replay_pass", "gemm",
            "trsm_tile", "band_mv"} <= launched


def test_lm_decode_on_the_card_matches_the_host(cuda):
    """The gemma3-1b smoke config (fp32, local and global layers, rings of
    16 slots) decodes 24 tokens on the card within 1e-4 * max|logit| of the
    same decode on the host, from the same weights."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as lm
    cfg = smoke_config("gemma3-1b")
    params = lm.init_params(0, cfg, device=cuda)
    host = lm.LM(cfg, device="cpu")
    host.load_state_dict(params.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    on_card = lm.init_decode_state(cfg, 2, capacity=32, device=cuda)
    on_host = lm.init_decode_state(cfg, 2, capacity=32, device="cpu")
    for t in range(toks.shape[1]):
        got, on_card = lm.decode_step(params, toks[:, t:t + 1].to(cuda),
                                      on_card, cfg)
        want, on_host = lm.decode_step(host, toks[:, t:t + 1], on_host, cfg)
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (t, err)
