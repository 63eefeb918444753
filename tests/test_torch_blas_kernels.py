"""The gemm, trsm and band_mv entry points of the PyTorch port against the
JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
public entry points (``repro.kernels.{gemm,trsm,band_mv}.ops``, which run
their Pallas kernels in interpret mode off the TPU, as
``tests/test_kernels.py`` and ``tests/test_band_mv.py`` run them), its
``ref.py`` oracles, and the port's entry points on CPU tensors, which
take the plain versions. Each tolerance is stated where it is used, with
its reason. The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import band_storage as j_bs
from repro.kernels.band_mv.ops import band_mv as j_band_mv
from repro.kernels.band_mv.ref import band_mv_ref as j_band_mv_ref
from repro.kernels.band_mv.ref import band_to_dense as j_band_to_dense
from repro.kernels.band_mv.ref import dense_to_band as j_dense_to_band
from repro.kernels.gemm.ops import gemm as j_gemm
from repro.kernels.gemm.ref import gemm_accum_ref as j_gemm_accum_ref
from repro.kernels.trsm.kernel import trsm_tile as j_trsm_tile
from repro.kernels.trsm.ops import trsm as j_trsm
from repro.kernels.trsm.ref import trsm_ref as j_trsm_ref
from repro_torch.core import band_storage as bs
from repro_torch.kernels.band_mv import kernel as bmv_kernel
from repro_torch.kernels.band_mv import ops as bmv_ops
from repro_torch.kernels.band_mv import ref as bmv_ref
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm import ref as gemm_ref
from repro_torch.kernels.trsm import kernel as trsm_kernel
from repro_torch.kernels.trsm import ops as trsm_ops
from repro_torch.kernels.trsm import ref as trsm_ref

U64 = np.finfo(np.float64).eps / 2


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _gamma(k):
    return k * U64 / (1 - k * U64)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ gemm --

GEMM_SHAPES = [(32, 32, 32), (64, 128, 96), (100, 70, 50), (8, 8, 8),
               (129, 257, 65), (1, 5, 1)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_matches_reference(m, k, n):
    A = _rng(m * k).standard_normal((m, k))
    B = _rng(k * n + 1).standard_normal((k, n))
    got = gemm_ops.gemm(_t(A), _t(B)).numpy()
    ref = np.asarray(j_gemm(jnp.asarray(A), jnp.asarray(B), bm=32, bn=32,
                            bk=32))
    # each within gamma_k |A||B| of the exact product, for any order of
    # summation; the two against each other within twice that
    bound = _gamma(k) * (np.abs(A) @ np.abs(B))
    assert np.all(np.abs(got - ref) <= 2 * bound)
    assert np.all(np.abs(got - A @ B) <= 2 * bound)


@pytest.mark.parametrize("alpha", [1.0, -0.5])
def test_gemm_accum_on_views_matches_reference(alpha):
    # C a block of a larger matrix, A a transposed view: the forms the
    # blocked trsm, Cholesky and DSYGST updates use
    big = _rng(3).standard_normal((90, 80))
    At = _rng(4).standard_normal((40, 30))          # A = At^T, (30, 40)
    B = _rng(5).standard_normal((40, 25))
    M = _t(big)
    out = gemm_ops.gemm_accum(M[10:40, 50:75], _t(At).mT, _t(B), alpha=alpha)
    assert out.data_ptr() == M[10:40, 50:75].data_ptr()
    want = np.asarray(j_gemm_accum_ref(jnp.asarray(big[10:40, 50:75]),
                                       jnp.asarray(At.T), jnp.asarray(B),
                                       alpha))
    bound = _gamma(41) * (np.abs(big[10:40, 50:75])
                          + abs(alpha) * (np.abs(At.T) @ np.abs(B)))
    assert np.all(np.abs(M[10:40, 50:75].numpy() - want) <= 2 * bound)
    rest = M.numpy().copy()
    rest[10:40, 50:75] = big[10:40, 50:75]
    np.testing.assert_array_equal(rest, big)        # nothing else moved
    np.testing.assert_allclose(
        gemm_ref.gemm_accum_ref(_t(big[:30, :25]), _t(At.T), _t(B),
                                alpha).numpy(),
        big[:30, :25] + alpha * (At.T @ B), rtol=0, atol=1e-12)


def test_gemm_kernel_knobs_and_layouts():
    # the knobs map onto the compiled menu: 128 x 128 or 64 x 64 output
    # tiles, and the K a block covers rounded up to SPLIT_K (32)
    plan = gemm_kernel.plan
    assert gemm_kernel.TILES == (128, 64)
    assert plan(9997, 9997, 9997, bm=128).tile == 128
    assert plan(60, 9997, 9997, bm=128).tile == 64      # m fits in 64 rows
    assert plan(9997, 9997, 9997, bm=48, bn=64).tile == 64
    assert plan(9997, 9997, 9997, bm=16, bn=128).tile == 128
    assert plan(257, 129, 333, bm=128, bn=128, bk=128) == (128, 128, 3)
    assert plan(257, 129, 333, bm=16, bn=16, bk=8) == (64, 32, 11)
    assert plan(257, 129, 333, bm=128, bn=32, bk=24) == (128, 32, 11)
    # bk never asks for more than MAX_SPLITS spans
    assert plan(128, 100, 9869, bk=16).splits <= gemm_kernel.MAX_SPLITS
    assert plan(128, 100, 9869, bk=16).kspan == 160
    # a launch, and one more for the reduce pass of a split
    assert plan(128, 100, 13).launches == 1
    assert plan(128, 100, 9869).launches == 2
    # every K is covered by exactly the splits the kernel launches
    for m, n, k in ((1, 1, 0), (5, 7, 3), (128, 100, 9869), (300, 130, 1000)):
        p = plan(m, n, k)
        assert p.kspan % gemm_kernel.SPLIT_K == 0
        assert p.splits == max(1, -(-k // p.kspan))
        assert (p.splits - 1) * p.kspan < max(k, 1)
    X = torch.zeros((50, 40), dtype=torch.float64)
    assert gemm_kernel.layout(X) == (False, 40)
    assert gemm_kernel.layout(X[5:20, 3:9]) == (False, 40)
    assert gemm_kernel.layout(X[5:20, 3:9].mT) == (True, 40)
    assert gemm_kernel.layout(X[:, 7:8]) == (False, 40)
    assert gemm_kernel.layout(X[::2, ::2]) is None


# (m, n, k) of the products the MD stages launch (n = 9997, s = 100), and
# the plan pinned for each: (tile, kspan, splits)
STAGE_PLANS = [
    # BT1: the last block row's update, U[k0:k1, k1:] X[k1:], K = 9869
    ((128, 100, 9869), (64, 160, 62)),
    # GS2 sygst: a trailing solve's update with 256 columns, K = 9741
    ((128, 256, 9741), (64, 320, 31)),
    # GS1: the first SYRK update M[k1:, k1:] -= row^T row, K = 256 (short
    # K: the 64 x 64 tile, 23716 blocks)
    ((9741, 9741, 256), (64, 256, 1)),
    # the full product 9997^3
    ((9997, 9997, 9997), (128, 10016, 1)),
    # the product with a 100-column block, (9997^2, 100): 79 big tiles,
    # each K split in 5 (395 blocks, three whole waves of 132)
    ((9997, 100, 9997), (128, 2016, 5)),
]


@pytest.mark.parametrize("shape,want", STAGE_PLANS)
def test_gemm_plan_at_the_stage_shapes(shape, want):
    p = gemm_kernel.plan(*shape)
    assert tuple(p) == want
    # at least a block an SM wherever the output alone is short of it
    m, n, _ = shape
    blocks = -(-m // p.tile) * -(-n // p.tile) * p.splits
    assert blocks >= gemm_kernel.SMS
    assert p.launches == 1 + (p.splits > 1)


def test_trsm_launch_plan_at_the_md_size():
    # 79 tile solves; of the 78 updates the long-K ones are split (two
    # launches), the shallow ones near the start of the sweep are not
    n = 9997
    assert trsm_ops.launches(n, 100) == {"trsm_tile": 79, "gemm": 154}
    assert trsm_ops.launches(n, 100, trans=True) == {"trsm_tile": 79,
                                                     "gemm": 155}
    # the GS2-shape solve (9997 columns): big tiles, K split where it is
    # at least BIG_TILE_K (71 of the 78 updates)
    assert trsm_ops.launches(n, n, trans=True) == {"trsm_tile": 79,
                                                   "gemm": 149}
    assert trsm_ops.launches(n, 0) == {"trsm_tile": 0, "gemm": 0}
    # a block of columns a warp each: >= 25 blocks at s = 100
    assert trsm_kernel.warps(100) == 4 and -(-100 // 4) >= 25
    assert trsm_kernel.warps(9997) == 19
    assert trsm_kernel.warps(10 ** 6) == trsm_kernel.MAX_WARPS


def test_gemm_wrappers_refuse_what_they_do_not_run():
    A = torch.ones((4, 4), dtype=torch.float64)
    # the launch wrapper never runs the plain version itself
    with pytest.raises(ValueError, match="CUDA tensor"):
        gemm_kernel.gemm(A, A)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(NotImplementedError, match="item 8"):
            gemm_ops.gemm(A.to(dt), A.to(dt))
        with pytest.raises(NotImplementedError, match="item 8"):
            gemm_ops.gemm_accum(A.to(dt), A.to(dt), A.to(dt))


# ------------------------------------------------------------------ trsm --

def _upper(n, seed):
    # the reference tests' matrices: kappa(U) < 10
    return np.triu(_rng(seed).standard_normal((n, n))) + n * np.eye(n)


def _close(got, ref):
    # two backward-stable solves of a system with kappa(U) < 10 agree to
    # ~n u kappa of max|X| (<= 1e-13 here); the bar leaves ten times that
    return np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


# the grid of tests/test_kernels.py::test_trsm_matches_ref at n <= 96
# (ragged last blocks at n = 65), plus a one-block and a one-row case
TRSM_GRID = [(32, 4, 16), (96, 8, 32), (65, 5, 32), (20, 3, 128), (1, 2, 16)]


@pytest.mark.parametrize("n,s,block", TRSM_GRID)
@pytest.mark.parametrize("trans", [False, True])
def test_trsm_matches_reference(n, s, block, trans):
    U = _upper(n, n * s)
    B = _rng(n * s + 1).standard_normal((n, s))
    got = trsm_ops.trsm(_t(U), _t(B), trans=trans, block=block).numpy()
    ref = np.asarray(j_trsm(jnp.asarray(U), jnp.asarray(B), trans=trans,
                            block=block))
    lib = np.asarray(j_trsm_ref(jnp.asarray(U), jnp.asarray(B), trans=trans))
    assert _close(got, ref) and _close(got, lib)
    np.testing.assert_allclose(
        trsm_ref.trsm_ref(_t(U), _t(B), trans=trans).numpy(), lib, rtol=0,
        atol=1e-12 * np.abs(lib).max())


@pytest.mark.parametrize("trans", [False, True])
def test_trsm_vector_rhs(trans):
    n = 48
    U = _upper(n, 1)
    b = _rng(2).standard_normal(n)
    got = trsm_ops.trsm(_t(U), _t(b), trans=trans, block=16)
    assert got.shape == (n,)
    ref = np.asarray(j_trsm(jnp.asarray(U), jnp.asarray(b), trans=trans,
                            block=16))
    assert _close(got.numpy(), ref)
    Uc = U.T if trans else U
    np.testing.assert_allclose(Uc @ got.numpy(), b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("trans", [False, True])
def test_trsm_reads_transposed_and_sliced_operands(trans):
    # U as the transpose of a lower-triangular array, B as a column slice
    # of a wider matrix and as a transposed view; n = 70 leaves a ragged
    # last block of 6
    n, block = 70, 32
    L = _upper(n, 7).T.copy()
    W = _rng(8).standard_normal((n, 12))
    Bt = _rng(9).standard_normal((5, n))
    for B_np, B_t in ((W[:, 3:8], _t(W)[:, 3:8]), (Bt.T, _t(Bt).mT)):
        got = trsm_ops.trsm(_t(L).mT, B_t, trans=trans, block=block).numpy()
        ref = np.asarray(j_trsm(jnp.asarray(L.T), jnp.asarray(B_np),
                                trans=trans, block=block))
        assert _close(got, ref)
    # the input is left as it was
    np.testing.assert_array_equal(_t(W)[:, 3:8].numpy(), W[:, 3:8])


@pytest.mark.parametrize("b,s", [(32, 5), (17, 1), (1, 3)])
@pytest.mark.parametrize("trans", [False, True])
def test_trsm_tile_ref_matches_the_reference_tile(b, s, trans):
    U = _upper(b, b + s)
    B = _rng(b * s).standard_normal((b, s))
    got = trsm_ref.trsm_tile_ref(_t(U), _t(B), trans=trans).numpy()
    ref = np.asarray(j_trsm_tile(jnp.asarray(U), jnp.asarray(B), trans=trans))
    assert _close(got, ref)


def test_blocked_schedule_counts_at_the_md_size():
    # 9997 = 78 * 128 + 13: 79 diagonal tiles and 78 product updates in
    # either direction; shapes only (meta tensors hold no data)
    n = 9997
    U = torch.empty((n, n), dtype=torch.float64, device="meta")
    for trans in (False, True):
        X = torch.empty((n, 100), dtype=torch.float64, device="meta")
        seen = {"tile": [], "update": []}
        trsm_ref.blocked_solve(
            U, X, trans, 128,
            lambda Uk, Xk, t: seen["tile"].append(tuple(Uk.shape)),
            lambda Xk, A, Xj: seen["update"].append((tuple(Xk.shape),
                                                     tuple(A.shape))))
        assert len(seen["tile"]) == 79 and len(seen["update"]) == 78
        assert (13, 13) in seen["tile"]
        # each update reads every row already solved: K = k0 going
        # forward, n - k1 going backward
        ks = sorted(a[1] for _, a in seen["update"])
        want = [128 * i for i in range(1, 79)] if trans else \
            [n - 128 * i for i in range(1, 79)]
        assert ks == sorted(want)


def test_trsm_wrappers_refuse_what_they_do_not_run():
    U = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trsm_kernel.trsm_tile(U, U.clone())
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(NotImplementedError, match="item 8"):
            trsm_ops.trsm(U.to(dt), U.to(dt))


# --------------------------------------------------------------- band_mv --

def _band_problem(n, w, seed):
    M = _rng(seed).standard_normal((n, n))
    A = 0.5 * (M + M.T)
    idx = np.arange(n)
    A = np.where(np.abs(idx[:, None] - idx[None, :]) <= w, A, 0.0)
    x = _rng(seed + 1).standard_normal(n)
    return A, np.asarray(j_dense_to_band(jnp.asarray(A), w)), x


# w = 0, 1, 16 and the grid of tests/test_band_mv.py
BAND_GRID = [(64, 0, 16), (80, 1, 16), (256, 16, 64), (64, 4, 16),
             (128, 8, 32), (96, 3, 32)]


@pytest.mark.parametrize("n,w,bm", BAND_GRID)
def test_band_mv_matches_reference(n, w, bm):
    A, band, x = _band_problem(n, w, n + w)
    got = bmv_ops.band_mv(_t(band), _t(x), w, bm=bm).numpy()
    ref = np.asarray(j_band_mv(jnp.asarray(band), jnp.asarray(x), w=w,
                               bm=bm))
    oracle = np.asarray(j_band_mv_ref(jnp.asarray(band), jnp.asarray(x)))
    # each within gamma_(2w+1) |A||x| of the exact product (at most 2w+1
    # nonzero terms a row); two results within twice that
    bound = 2 * _gamma(2 * w + 1) * (np.abs(A) @ np.abs(x))
    assert np.all(np.abs(got - ref) <= bound)
    assert np.all(np.abs(got - oracle) <= bound)


def test_band_mv_band_wider_than_the_matrix():
    # w >= n: the diagonals at d >= n hold no entry of A. The reference's
    # kernel needs w < n, so it gets the same band cut to w = n - 1
    n, w = 20, 25
    A, band, x = _band_problem(n, n - 1, 5)
    wide = np.concatenate([band, _rng(6).standard_normal((n, w - n + 1))],
                          axis=1)
    got = bmv_ops.band_mv(_t(wide), _t(x), w).numpy()
    ref = np.asarray(j_band_mv(jnp.asarray(band), jnp.asarray(x), w=n - 1))
    bound = 2 * _gamma(2 * n - 1) * (np.abs(A) @ np.abs(x))
    assert np.all(np.abs(got - ref) <= bound)
    assert np.all(np.abs(got - A @ x) <= bound)


def test_band_layout_helpers_match_the_reference():
    A, band, _ = _band_problem(48, 5, 0)
    np.testing.assert_array_equal(
        bmv_ref.dense_to_band(_t(A), 5).numpy(), band)
    np.testing.assert_array_equal(
        bmv_ref.band_to_dense(_t(band)).numpy(),
        np.asarray(j_band_to_dense(jnp.asarray(band))))
    # the TT pipeline's (w+1, n) lower band through to_band_mv_layout, a
    # transposed view, as chip_smoke.py feeds the kernel
    Wb = bs.pack_band(_t(A), 5)
    x = _rng(1).standard_normal(48)
    got = bmv_ops.band_mv(bs.to_band_mv_layout(Wb), _t(x), 5).numpy()
    j_Wb = j_bs.pack_band(jnp.asarray(A), 5)
    np.testing.assert_array_equal(bs.to_band_mv_layout(Wb).numpy(),
                                  np.asarray(j_bs.to_band_mv_layout(j_Wb)))
    bound = 2 * _gamma(11) * (np.abs(A) @ np.abs(x))
    assert np.all(np.abs(got - bs.unpack_band(Wb).numpy() @ x) <= bound)


def test_band_mv_wrappers_refuse_what_they_do_not_run():
    band = torch.ones((6, 3), dtype=torch.float64)
    x = torch.ones(6, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bmv_kernel.band_mv(band, x, 2)
    with pytest.raises(ValueError, match="w\\+1"):
        bmv_ops.band_mv(band, x, 3)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(NotImplementedError, match="item 8"):
            bmv_ops.band_mv(band.to(dt), x.to(dt), 2)


@pytest.mark.parametrize("n,w,bm,want", [
    (9997, 16, 128, 8 * (17 * 145 + 160)),   # the MD band: 144 rows, padded
    (9997, 16, 64, 8 * (17 * 81 + 96)),
    (1, 0, 128, 8 * (3 + 1)),                # one row, one diagonal
    (20, 25, 64, 8 * (20 * 26 + 2 + 20)),    # w >= n: the run is wider
    (1000, 3, 1, 8 * (4 * 5 + 7)),
    (9997, 60, 128, 0),                      # past 48 KB: the direct kernel
    (5000, 5000, 128, 0),
])
def test_band_mv_plan(n, w, bm, want):
    """Shared memory of a staged block: the band rows [r0 - w, r0 + bm) in
    the larger of their layouts (the contiguous run plus two words, or
    diagonal-major with the rows padded to odd) and x[r0 - w, r0 + bm + w);
    0 (the direct kernel) past ``STAGED_SMEM_MAX``."""
    assert bmv_kernel.band_mv_plan(n, w, bm) == want
    assert want <= bmv_kernel.STAGED_SMEM_MAX
