"""The one-triangle symmetric product of the PyTorch port against the JAX
reference, on the CPU.

The same inputs, made with numpy from a seed (a symmetric upper triangle
with garbage strictly below it), go through the reference's
``symv_upper_ref``/``symm_block_upper_ref``, through its Pallas kernels in
interpret mode (via ``repro.kernels.symv.ops``, which pads as the
reference does), and through the port's plain versions — the code a CPU
tensor runs. The tolerance is 1e-12 relative to the largest entry of the
result: the orders of summation differ, the operands are O(1).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.symv import ops as j_ops
from repro.kernels.symv import ref as j_ref
from repro.kernels.symv.kernel import triangle_indices
from repro_torch import kernels
from repro_torch.core.precision import padded_copy
from repro_torch.kernels import _launches
from repro_torch.kernels.symv import kernel, ops, ref

TOL = 1e-12
NS = [5, 33, 100, 129]
PS = [1, 3, 4]


def _inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, n))
    G = 1e6 * rng.standard_normal((n, n))
    A = np.triu(R) + np.tril(G, -1)
    X = rng.standard_normal((n, p))
    return A, X


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= TOL * max(1.0, np.abs(y_ref).max())


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_symm_block_plain_vs_reference(n, p):
    A, X = _inputs(n, p, 10 * n + p)
    _close(ref.symm_block_upper_ref(_t(A), _t(X)).numpy(),
           j_ref.symm_block_upper_ref(jnp.asarray(A), jnp.asarray(X)))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_symm_block_plain_vs_pallas_interpret(n, p):
    A, X = _inputs(n, p, 10 * n + p + 1)
    _close(ref.symm_block_upper_ref(_t(A), _t(X)).numpy(),
           j_ops.symm_block(jnp.asarray(A), jnp.asarray(X),
                            force_interpret=True))


@pytest.mark.parametrize("n", NS)
def test_symv_plain_vs_reference_and_pallas_interpret(n):
    A, X = _inputs(n, 1, n + 2)
    x = X[:, 0]
    y = ref.symv_upper_ref(_t(A), _t(x)).numpy()
    _close(y, j_ref.symv_upper_ref(jnp.asarray(A), jnp.asarray(x)))
    _close(y, j_ops.symv(jnp.asarray(A), jnp.asarray(x),
                         force_interpret=True))


def test_plain_versions_read_only_the_upper_triangle():
    A, X = _inputs(40, 3, 5)
    A2 = np.triu(A) + np.tril(np.full_like(A, np.nan), -1)
    Y = ref.symm_block_upper_ref(_t(A), _t(X))
    assert torch.equal(Y, ref.symm_block_upper_ref(_t(A2), _t(X)))
    assert torch.equal(ref.symv_upper_ref(_t(A2), _t(X[:, 0])),
                       ref.symv_upper_ref(_t(A), _t(X[:, 0])))
    sym = np.triu(A) + np.triu(A, 1).T
    assert np.abs(Y.numpy() - sym @ X).max() <= 1e-12 * np.abs(sym @ X).max()


def test_ops_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")
    monkeypatch.setattr(kernel, "symv", boom)
    monkeypatch.setattr(kernel, "symm_block", boom)
    A, X = _inputs(33, 4, 8)
    assert torch.equal(ops.symm_block(_t(A), _t(X)),
                       ref.symm_block_upper_ref(_t(A), _t(X)))
    assert torch.equal(ops.symv(_t(A), _t(X[:, 1])),
                       ref.symv_upper_ref(_t(A), _t(X[:, 1])))


def test_ops_take_a_column_slice_of_the_basis():
    A, X = _inputs(50, 9, 11)
    V = _t(X)
    Xs = V[:, 4:8]
    assert not Xs.is_contiguous()
    assert torch.equal(ops.symm_block(_t(A), Xs),
                       ref.symm_block_upper_ref(_t(A), Xs.contiguous()))


@pytest.mark.parametrize("fn", ["symv", "symm_block"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    A, X = _inputs(8, 2, 0)
    rhs = _t(X[:, 0]) if fn == "symv" else _t(X)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernel, fn)(_t(A), rhs)


def test_launch_counters_reset_and_read():
    kernel.symv.launches = 3
    kernel.reset_launches()
    assert kernel.launch_counts() == {f"{k}{s}": 0
                                      for k in ("symv", "symm_block")
                                      for s in ("", "_fp32", "_bf16")}


@pytest.mark.parametrize("nb", [1, 2, 3, 64, 157, 270])
def test_tile_map_follows_the_reference_triangle_order(nb):
    # warp t of the kernel's triangle grid takes tile_of(t, nb): every
    # upper tile exactly once, in the order of triangle_indices
    ib, jb = triangle_indices(nb)
    got = [kernel.tile_of(t, nb) for t in range(len(ib))]
    assert got == list(zip(ib.tolist(), jb.tolist()))


@pytest.mark.parametrize("n,p,kc", [(1, 1, 1), (64, 2, 2), (65, 3, 4),
                                    (9997, 1, 1), (9997, 4, 4),
                                    (17243, 5, 4), (100, 8, 4)])
def test_plan_sizes(n, p, kc):
    pl = kernel.plan(n, p)
    nb = -(-n // kernel.TILE)
    assert pl == kernel.Plan(nb, nb * (nb + 1) // 2, kc, (nb + 1, n, p))


@pytest.mark.parametrize("n", [1, 64, 65, 200])
def test_scratch_slots_are_written_once(n):
    # tile (i, j) writes its row part to slot j, rows of block i, and its
    # mirror to slot i, rows of block j (the diagonal tile's to slot nb):
    # every (slot, row block) of the (nb + 1, n, p) scratch exactly once
    pl = kernel.plan(n, 1)
    seen = np.zeros((pl.scratch[0], pl.nb), dtype=int)
    for t in range(pl.ntiles):
        i, j = kernel.tile_of(t, pl.nb)
        seen[j, i] += 1
        seen[pl.nb if i == j else i, j] += 1
    assert np.all(seen == 1)


# ----------------------------------------- the 16-byte kernel's paths, plan --

@pytest.mark.parametrize("esize,views,want", [
    (2, [(0, 9997)], "narrow"),             # odd row stride (bf16)
    (2, [(0, 10000)], "wide"),              # 20000 B rows
    (2, [(2, 10000)], "narrow"),            # pointer off by one entry
    (2, [(16 * 7, 8)], "wide"),
    (4, [(0, 9996)], "wide"),
    (4, [(0, 9998)], "narrow"),             # 39992 B rows: 8 mod 16
    (4, [(0, 64), (48, 68)], "wide"),
    (4, [(0, 64), (52, 68)], "narrow"),     # one of two views misaligned
])
def test_load_path_rule(esize, views, want):
    # wide only when every pointer and every row's step in bytes is a
    # multiple of 16, so each 16-byte vector of a row is aligned
    assert _launches.load_path(esize, *views) == want


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [5, 75, 128, 129])
def test_product_path_follows_the_matrix_layout(n, dt):
    # fp32 and bf16 take the 16-byte kernel, wide on a padded copy and
    # narrow on a plain one whose row stride or start is not 16-byte
    # aligned; fp64 keeps the 8-byte kernel whatever the layout
    A = _t(_inputs(n, 1, n)[0])
    per = 16 // torch.empty((), dtype=dt).element_size()
    padded = padded_copy(A, dt)
    assert padded.stride(0) % per == 0 and torch.equal(padded, A.to(dt))
    assert kernel.product_path(padded) == "wide"
    plain = A.to(dt)
    assert kernel.product_path(plain) == ("wide" if n % per == 0
                                          else "narrow")
    big = padded_copy(torch.zeros(n + 1, n + 1), dt)
    assert kernel.product_path(big[1:, 1:]) == "narrow"   # off a boundary
    assert kernel.product_path(padded_copy(A, torch.float64)) == "tiles"
    assert kernel.product_path(A) == "tiles"


def test_path_counters_reset_and_read():
    kernel.symm_block.paths["bf16_wide"] = 5
    kernel.symv.paths["bf16_narrow"] = 2
    assert kernel.path_counts()["symm_block_bf16_wide"] == 5
    assert kernels.path_counts()["symv_bf16_narrow"] == 2
    kernels.reset_launches()
    assert kernel.path_counts() == {f"{k}_{s}_{p}": 0
                                    for k in ("symv", "symm_block")
                                    for s in ("fp32", "bf16")
                                    for p in ("wide", "narrow")}
