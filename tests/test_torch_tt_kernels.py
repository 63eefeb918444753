"""The TT kernels' plain versions and band storage of the PyTorch port
against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
Pallas kernels in interpret mode (``force_kernel=True,
force_interpret=True``, as its own tests run them), its ``ref.py``
oracles, and the port's plain versions — the code a CPU tensor runs.
Each tolerance is stated where it is used, with its reason. The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import band_storage as j_bs
from repro.core import sbr as j_sbr
from repro.core.linalg_utils import givens as j_givens
from repro.core.linalg_utils import qr_wy_masked as j_qr_wy_masked
from repro.kernels.house_panel.ops import house_panel as j_house_panel
from repro.kernels.house_panel.ref import house_panel_ref as j_house_ref
from repro.kernels.rot_apply.ops import rot_apply as j_rot_apply
from repro.kernels.syr2k.ops import syr2k as j_syr2k
from repro_torch.core import band_storage as bs
from repro_torch.core.linalg_utils import givens, qr_wy_masked
from repro_torch.kernels.house_panel import kernel as hp_kernel
from repro_torch.kernels.house_panel import ops as hp_ops
from repro_torch.kernels.rot_apply import kernel as rot_kernel
from repro_torch.kernels.rot_apply import ops as rot_ops
from repro_torch.kernels.rot_apply import ref as rot_ref
from repro_torch.kernels.rot_apply import schedule as rot_sched
from repro_torch.kernels.syr2k import kernel as syr2k_kernel
from repro_torch.kernels.syr2k import ops as syr2k_ops

U = np.finfo(np.float64).eps / 2


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _sym(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (A + A.T)


# ------------------------------------------------------------ band storage --

BAND_GRID = [(17, 3), (32, 8), (5, 7), (1, 2), (40, 40), (12, 11)]


@pytest.mark.parametrize("n,w", BAND_GRID)
def test_band_storage_bitwise_vs_reference(n, w):
    A = np.random.default_rng(n * 31 + w).standard_normal((n, n))
    for sym in (False, True):
        band = bs.pack_band(_t(A), w, symmetrize=sym)
        j_band = j_bs.pack_band(jnp.asarray(A), w, symmetrize=sym)
        np.testing.assert_array_equal(band.numpy(), np.asarray(j_band))
        np.testing.assert_array_equal(bs.unpack_band(band).numpy(),
                                      np.asarray(j_bs.unpack_band(j_band)))
    raw = _t(np.random.default_rng(n).standard_normal((w + 1, n)))
    np.testing.assert_array_equal(
        bs.clean_band(raw).numpy(),
        np.asarray(j_bs.clean_band(jnp.asarray(raw.numpy()))))
    d, e = bs.band_extract_tridiag(raw)
    jd, je = j_bs.band_extract_tridiag(jnp.asarray(raw.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    bm = bs.to_band_mv_layout(raw)
    np.testing.assert_array_equal(
        bm.numpy(), np.asarray(j_bs.to_band_mv_layout(jnp.asarray(raw.numpy()))))
    np.testing.assert_array_equal(bs.from_band_mv_layout(bm).numpy(),
                                  raw.numpy())


# ---------------------------------------------------------- house_panel --

# the grid of tests/test_house_panel.py: odd rows, b not dividing rows,
# the rows < b tail panel, and the pivot-past-the-end case
HOUSE_GRID = [(37, 5, 10), (40, 8, 0), (33, 4, 7), (12, 8, 8), (21, 16, 9),
              (33, 4, 32)]


def _panel(rows, b, seed):
    return np.random.default_rng(seed).standard_normal((rows, b))


@pytest.mark.parametrize("rows,b,row_start", HOUSE_GRID)
def test_house_panel_plain_vs_pallas_interpret_and_ref(rows, b, row_start):
    E = _panel(rows, b, rows * 100 + b + row_start)
    V, T = hp_ops.house_panel(_t(E), row_start)
    # |v| <= 1 and |tau| <= 2: entries agree to the rounding of O(rows)
    # sums, far inside 1e-13
    for jV, jT in (j_house_panel(jnp.asarray(E), row_start, force_kernel=True,
                                 force_interpret=True),
                   j_house_ref(jnp.asarray(E), row_start)):
        np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("rows,b,row_start", HOUSE_GRID)
def test_house_panel_plain_invariants(rows, b, row_start):
    E = _panel(rows, b, rows * 31 + b)
    V, T = (x.numpy() for x in hp_ops.house_panel(_t(E), row_start))
    Q = np.eye(rows) - V @ T @ V.T
    np.testing.assert_allclose(Q.T @ Q, np.eye(rows), atol=1e-12)
    R = Q.T @ E
    for j in range(b):
        p = row_start + j
        if p + 1 < rows:
            np.testing.assert_allclose(R[p + 1:, j], 0.0, atol=1e-12)
    np.testing.assert_array_equal(V[:row_start], 0.0)


def test_qr_wy_masked_vs_reference():
    E = _panel(29, 6, 5)
    got = qr_wy_masked(_t(E), 7)
    want = j_qr_wy_masked(jnp.asarray(E), 7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)


# ---------------------------------------------------------------- syr2k --

@pytest.mark.parametrize("n,k", [(1, 1), (9, 4), (33, 16), (100, 17),
                                 (130, 8)])
def test_syr2k_plain_vs_pallas_interpret(n, k):
    rng = np.random.default_rng(n + k)
    C, V, W = (rng.standard_normal(s) for s in ((n, n), (n, k), (n, k)))
    got = syr2k_ops.syr2k(_t(C), _t(V), _t(W), alpha=-1.0).numpy()
    want = np.asarray(j_syr2k(jnp.asarray(C), jnp.asarray(V), jnp.asarray(W),
                              alpha=-1.0, force_interpret=True))
    # each entry is C + alpha (2k products): any order of summation is
    # within gamma_{2k+1} (|C| + |alpha| (|V||W|^T + |W||V|^T)) of the
    # exact value, so two orders are within twice that
    m = 2 * k + 1
    gamma = m * U / (1 - m * U)
    bound = gamma * (np.abs(C) + np.abs(V) @ np.abs(W).T
                     + np.abs(W) @ np.abs(V).T)
    assert np.all(np.abs(got - want) <= 2 * bound)


def test_syr2k_symmetrize_and_out_in_place():
    rng = np.random.default_rng(3)
    C = _t(_sym(20, 3))
    V, W = _t(rng.standard_normal((20, 4))), _t(rng.standard_normal((20, 4)))
    R = syr2k_ops.syr2k(C, V, W, alpha=-0.5)
    S = syr2k_ops.syr2k(C, V, W, alpha=-0.5, symmetrize=True)
    torch.testing.assert_close(S, 0.5 * (R + R.mT), rtol=0, atol=0)
    out = C.clone()
    assert syr2k_ops.syr2k(out, V, W, alpha=-0.5, symmetrize=True,
                           out=out) is out
    torch.testing.assert_close(out, S, rtol=0, atol=0)


@pytest.mark.parametrize("dt,ld,offset,want", [
    (torch.float64, 33, 0, "tiles"),
    (torch.float32, 36, 0, "wide"),
    (torch.float32, 33, 0, "narrow"),      # 132 B rows
    (torch.float32, 36, 1, "narrow"),      # a window 4 B past a boundary
    (torch.float32, 36, 4, "wide"),        # window origin o = 4: o (ld + 1)
    (torch.bfloat16, 40, 8, "wide"),       # entries from 16-B aligned rows
    (torch.bfloat16, 40, 4, "narrow"),
])
def test_syr2k_update_path_follows_the_window(dt, ld, offset, want):
    # the reduced update takes the wide path only where both C's and out's
    # pointers and row strides are 16-byte aligned; a TT1 window M[o:, o:]
    # of a padded working copy starts o (ld + 1) entries in
    n = 32
    M = torch.empty_strided((n, n), (ld, 1), dtype=dt)
    win = M[offset:, offset:]
    assert syr2k_kernel.update_path(win, win) == want
    if want == "wide":
        other = torch.empty_strided((n - offset, n - offset), (ld + 1, 1),
                                    dtype=dt)
        assert syr2k_kernel.update_path(win, other) == "narrow"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("n,w", [(75, 8), (130, 16)])
def test_tt1_working_copy_rows_are_16_byte_aligned_below_fp64(monkeypatch,
                                                              dtype, n, w):
    # every window the sweep hands to syr2k: below fp64 a view of a padded
    # working copy (row stride a multiple of 16 bytes, each window on the
    # wide path); fp64 keeps C's own layout; the band is the same as on an
    # unpadded copy, bit for bit
    from repro_torch.core import sbr
    seen = []
    real = sbr.syr2k

    def spy(Mt, V, Z, **kw):
        seen.append((Mt.stride(0), Mt.element_size(),
                     syr2k_kernel.update_path(Mt, kw["out"])))
        return real(Mt, V, Z, **kw)

    C = _t(_sym(n, n)).to(dtype)
    monkeypatch.setattr(sbr, "syr2k", spy)
    band = sbr.reduce_to_band(C, w=w, n_chunks=3)     # windows at o > 0
    assert len({ld for ld, _, _ in seen}) == 1 and len(seen) > 3
    for ld, es, path in seen:
        if dtype == torch.float64:
            assert ld == n and path == "tiles"
        else:
            assert ld * es % 16 == 0 and ld - n < 16 // es and path == "wide"
    monkeypatch.setattr(sbr, "padded_copy", lambda M, dt: M.clone())
    assert torch.equal(sbr.reduce_to_band(C, w=w, n_chunks=3).Wb, band.Wb)


# ------------------------------------------------------------ rot_apply --

@pytest.mark.parametrize("G,L", [(1, 1), (7, 5), (64, 8), (209, 36)])
def test_rot_apply_plain_vs_pallas_interpret(G, L):
    rng = np.random.default_rng(G * 7 + L)
    pairs = rng.standard_normal((G, 2, L))
    cs = rng.standard_normal((G, 2))
    got = rot_ops.rot_apply(_t(pairs), _t(cs)).numpy()
    want = np.asarray(j_rot_apply(jnp.asarray(pairs), jnp.asarray(cs),
                                  force_kernel=True, force_interpret=True))
    # XLA may contract c x0 + s x1 into an FMA, the port never does. Each
    # side is within 2u (|c||x0| + |s||x1|) of the exact value (a product
    # and the sum rounded, or all three), so the two are within twice that
    c, s = np.abs(cs[:, :1]), np.abs(cs[:, 1:])
    x0, x1 = np.abs(pairs[:, 0]), np.abs(pairs[:, 1])
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= 4 * U * (c * x0 + s * x1))
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 4 * U * (s * x0 + c * x1))


@pytest.mark.parametrize("G,L", [(1, 1), (7, 5), (1000, 8), (209, 36),
                                 (625, 100), (3, 257), (517, 131),
                                 (1000, 1), (300, 2)])
def test_rot_apply_launch_shape_covers_every_entry_once(G, L):
    # the kernel's grid walk, in Python: block (bx, by), thread (x, y)
    # takes pair bx ty + y and columns by tx + x, by tx + x + gy tx, ...
    tx, ty, gx, gy = rot_kernel.launch_shape(G, L)
    assert tx * ty == rot_kernel.ROT_THREADS and tx >= min(L, 256)
    assert gy <= rot_kernel.MAX_GRID_Y
    # ... after staging its 2 ty (c, s) entries, thread tid taking
    # tid, tid + tx ty, ...: every entry of every pair exactly once
    staged = np.zeros((G, 2), dtype=int)
    for bx in range(gx):
        for tid in range(tx * ty):
            for i in range(tid, 2 * ty, tx * ty):
                if bx * ty + i // 2 < G:
                    staged[bx * ty + i // 2, i % 2] += 1
    assert np.all(staged == 1)
    seen = np.zeros((G, L), dtype=int)
    for bx in range(gx):
        for y in range(ty):
            g = bx * ty + y
            if g >= G:
                continue
            for by in range(gy):
                for x in range(tx):
                    seen[g, by * tx + x:L:gy * tx] += 1
    assert np.all(seen == 1)


def test_rot_apply_launch_shape_strides_past_the_grid_limit():
    L = rot_kernel.MAX_GRID_Y * 256 + 3
    tx, ty, gx, gy = rot_kernel.launch_shape(1, L)
    assert (tx, ty, gx, gy) == (256, 1, 1, rot_kernel.MAX_GRID_Y)
    assert gy * tx < L <= 2 * gy * tx     # the kernel's column loop


def test_rot_apply_launch_shape_refuses_64_bit_offsets():
    rot_kernel.launch_shape(2 ** 15, 2 ** 16 - 1)
    with pytest.raises(ValueError, match="2\\^31"):
        rot_kernel.launch_shape(2 ** 15, 2 ** 16)


def test_givens_vs_reference():
    rng = np.random.default_rng(11)
    a = np.concatenate([rng.standard_normal(200), [0.0, 0.0, 3.0]])
    b = np.concatenate([rng.standard_normal(200), [0.0, 2.0, 0.0]])
    c, s = givens(_t(a), _t(b))
    jc, js = j_givens(jnp.asarray(a), jnp.asarray(b))
    # an FMA in a*a + b*b moves r by an ulp: c and s agree to a few ulps
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=4 * U, atol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=4 * U, atol=0)
    assert (c[200].item(), s[200].item()) == (1.0, 0.0)


@pytest.mark.parametrize("n,w", [(40, 4), (37, 7)])
def test_replay_pass_plain_vs_reference(n, w):
    # the reference's own chase tables, replayed by both packages onto the
    # same rows: the same rotations, so only the rounding of each differs
    C = _sym(n, n + w)
    band = j_sbr.reduce_to_band(jnp.asarray(C), w=w)
    chase = j_sbr.band_chase(band.Wb, w)
    X = np.random.default_rng(1).standard_normal((n + 2, 5))
    X[-2:] = 0.0
    for reverse in (False, True):
        got, want = _t(X), jnp.asarray(X)
        passes = j_sbr._executed_passes(n, w)
        order = zip(passes, chase.cs)
        if reverse:
            order = zip(reversed(passes), reversed(chase.cs))
        for b, CS in order:
            rot_ops.replay_pass(got, _t(CS), b, n, reverse)
            want = j_sbr._replay_pass(want, CS, b, n, reverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13)


def test_chase_pass_plain_keeps_the_reference_table_layout():
    n, w = 30, 5
    C = _sym(n, 8)
    band = j_sbr.reduce_to_band(jnp.asarray(C), w=w)
    Wp = torch.zeros((w + 2, 2 + n + 3 * w + 8), dtype=torch.float64)
    Wp[: w + 1, 2: 2 + n] = _t(band.Wb)
    CS = rot_ops.chase_pass(Wp, w, w, n)
    g, T_pass, G, J, K0 = j_sbr._pass_schedule(n, w)
    assert tuple(CS.shape) == (J + 1, K0 + 1, 2)
    # slots past each sweep's end keep the identity rotation
    for j in range(J):
        Kj = (n - 1 - j - w) // w + 1
        assert torch.equal(CS[j, Kj:, 0], torch.ones(K0 + 1 - Kj,
                                                     dtype=torch.float64))
        assert torch.equal(CS[j, Kj:, 1], torch.zeros(K0 + 1 - Kj,
                                                      dtype=torch.float64))
    # the pass leaves bandwidth w-1: the annihilated diagonals are zero
    assert torch.equal(Wp[w:], torch.zeros_like(Wp[w:]))


@pytest.mark.parametrize("n,w", [(9, 7), (30, 5), (61, 8), (100, 16)])
def test_chase_pass_lanes_plain_is_the_window_plain_in_fp64(n, w):
    # the in-place form (the CUDA chase's lanes and stagger, the plain
    # version of its fp32/bf16 instances) gives the window form's bits
    band = j_sbr.reduce_to_band(jnp.asarray(_sym(n, n)), w=w)
    W1 = rot_sched.padded_band(_t(band.Wb), w)
    W2 = W1.clone()
    for b in j_sbr._executed_passes(n, w):
        assert torch.equal(rot_ref.chase_pass_ref(W1, b, w, n),
                           rot_ref.chase_pass_lanes_ref(W2, b, w, n))
    assert torch.equal(W1, W2)


# ------------------------------------------------- the slab replay's order --

def _random_table(n, b, seed):
    """A (J+1, K0+1, 2) table: random rotations (c, s) in the live slots
    (k < K_j), the identity past each sweep's end."""
    _, _, _, J, K0 = rot_sched.pass_schedule(n, b)
    CS = rot_sched.identity_table(J, K0, torch.zeros(1, dtype=torch.float64))
    rng = np.random.default_rng(seed)
    for j in range(J):
        Kj = (n - 1 - j - b) // b + 1
        theta = rng.uniform(0.0, 6.3, Kj)
        CS[j, :Kj] = _t(np.stack([np.cos(theta), np.sin(theta)], 1))
    return CS


def _shuffled(seed):
    rng = np.random.default_rng(seed)
    return lambda lanes: [lanes[i] for i in rng.permutation(len(lanes))]


@pytest.mark.parametrize("n", [20, 37, 101])
@pytest.mark.parametrize("reverse", [False, True])
def test_replay_chunk_order_bitwise_vs_plain(n, reverse):
    """The slab kernel's order (chunks of b-1 sweeps, each lane's rotations
    in sweep order through one carried row, the lanes in any order) gives
    the sequential replay's bits, b = 2..16: n=20 is below 2b for b > 10,
    and no n here is a multiple of most b. Rows past n stay untouched."""
    for b in range(2, 17):
        if n - b <= 0:
            continue
        CS = _random_table(n, b, n * 17 + b)
        X = _t(np.random.default_rng(b).standard_normal((n + 3, 4)))
        want = rot_ref.replay_pass_ref(X.clone(), CS, b, n, reverse)
        got = rot_sched.replay_chunked(X.clone(), CS, b, n, reverse,
                                       lane_order=_shuffled(n + b))
        assert torch.equal(got, want), (n, b, reverse)
        assert torch.equal(got[n:], X[n:])


@pytest.mark.parametrize("n,w", [(40, 4), (37, 7), (20, 16)])
def test_replay_chunk_order_vs_reference(n, w):
    # the reference's own chase tables through all passes, both directions:
    # the chunk order is bitwise the port's plain replay, and within 1e-13
    # of the reference's _replay_pass, whose XLA build rounds each rotation
    # its own way (as test_replay_pass_plain_vs_reference)
    C = _sym(n, n + w)
    band = j_sbr.reduce_to_band(jnp.asarray(C), w=w)
    chase = j_sbr.band_chase(band.Wb, w)
    X = np.random.default_rng(1).standard_normal((n + 2, 5))
    X[-2:] = 0.0
    passes = j_sbr._executed_passes(n, w)
    for reverse in (False, True):
        got, plain, want = _t(X), _t(X), jnp.asarray(X)
        order = list(zip(passes, chase.cs))
        for b, CS in (order[::-1] if reverse else order):
            rot_sched.replay_chunked(got, _t(CS), b, n, reverse,
                                     lane_order=_shuffled(b))
            rot_ref.replay_pass_ref(plain, _t(CS), b, n, reverse)
            want = j_sbr._replay_pass(want, CS, b, n, reverse)
        assert torch.equal(got, plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("n", [9, 20, 37, 64, 101])
def test_replay_chunk_windows_disjoint_and_cover_each_touched_row_once(n):
    """In every chunk of b-1 sweeps, the lanes' b-row windows are disjoint;
    each rotation of the chunk's sweeps lies in its own lane's window and
    in no other, and is counted by that lane; so each touched row is in
    exactly one window."""
    for b in range(2, 17):
        if n - b <= 0:
            continue
        J = n - b
        for j0 in range(0, J, b - 1):
            mc = min(b - 1, J - j0)
            lanes = rot_sched.chunk_lanes(n, b, j0, mc)
            windows = [set(range(w, w + b)) for _, w, _ in lanes]
            assert sum(map(len, windows)) == len(set().union(*windows))
            assert [k for k, _, _ in lanes] == list(range(len(lanes)))
            rotations = 0
            for j in range(j0, j0 + mc):
                for k in range((n - 1 - j - b) // b + 1):
                    r = j + (k + 1) * b
                    owners = [i for i, win in enumerate(windows)
                              if {r - 1, r} <= win]
                    assert owners == [k], (n, b, j, k)
                    assert r - 1 - lanes[k][1] == j - j0 < lanes[k][2]
                    rotations += 1
            assert rotations == sum(cnt for _, _, cnt in lanes)


@pytest.mark.parametrize("n,ncols,aligned,path,ctas", [
    (9997, 100, True, "slab", 100),       # MD TT4: (9997, 100)
    (17243, 448, True, "slab", 448),      # DFT TT4: in waves
    (9997, 9997, True, "slab", 9997),     # accumulate_q2
    (9997, 132, True, "slab", 132),       # as many columns as SMs
    (9997, 133, True, "slab", 133),       # one more
    (300, 13, True, "slab", 13),
    (97, 1, True, "slab", 1),
    (26992, 100, True, "slab", 100),      # the longest column that fits
    (26993, 100, True, "sweep", 0),       # and one row more
    (30000, 100, True, "sweep", 0),
    (9997, 100, False, "sweep", 0)])      # a table not 16-byte aligned
def test_replay_plan_by_size(n, ncols, aligned, path, ctas):
    """The slab path, one CTA a column, where a column (rows rounded up to
    16) fits a CTA's shared memory beside two table slices of at least 512
    lanes each; else the sweep path, which also takes a table that
    cp.async.bulk cannot read (not 16-byte aligned)."""
    plan = rot_kernel.replay_plan(n, ncols, aligned)
    assert (plan.path, plan.ctas) == (path, ctas)
    if path == "slab":
        assert plan.stage % 16 == 0
        assert plan.stage >= 16 * rot_kernel.REPLAY_CONSUMERS
        assert plan.smem == rot_kernel.replay_smem(n, plan.stage)
        assert plan.smem <= rot_kernel.SMEM_MAX
        # the slices take what the column leaves, to within 16 bytes each
        assert rot_kernel.SMEM_MAX - plan.smem < 16 * rot_kernel.REPLAY_SLOTS
    else:
        assert plan == rot_kernel.SWEEP


@pytest.mark.parametrize("active,b,path,csize,rpc", [
    (9981, 16, "cluster", 16, 624),       # the first MD panel
    (17227, 16, "cluster", 16, 1077),     # the first DFT panel
    (17211, 32, "cooperative", 0, 0),     # w=32 at DFT: 4.4 MB
    (9997, 128, "cooperative", 0, 0),     # b=128
    (640, 16, "cluster", 1, 640),         # the edge of one CTA
    (641, 16, "cluster", 2, 321),
    (16, 16, "cluster", 1, 16),           # the last, short panels
    (0, 16, "cluster", 1, 1),
    (200, 64, "cluster", 1, 200),
    (28432, 16, "cluster", 16, 1777),     # the largest that 16 CTAs hold
    (28433, 16, "cooperative", 0, 0)])
def test_house_plan_by_panel_size(active, b, path, csize, rpc):
    """The cluster path where the active rows fit 16 CTAs' shared memory
    (rows and T, partial slots and sums): the fewest CTAs holding at most
    640 rows each, else 16; the cooperative kernel past that."""
    plan = hp_kernel.house_plan(active, b)
    assert (plan.path, plan.csize, plan.rpc) == (path, csize, rpc)
    if path == "cluster":
        assert plan.csize * plan.rpc >= active
        assert plan.smem == 8 * (rpc * b + hp_kernel.cluster_extra_doubles(b))
        assert plan.smem <= hp_kernel.SMEM_MAX
        # a card that runs no cluster of 16
        small = hp_kernel.house_plan(active, b, lambda c: c < 16)
        assert small.path == ("cluster" if csize < 16 else "cooperative")


# ------------------------------------------------------------- dispatch --

def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")
    for mod, name in ((hp_kernel, "house_panel"), (syr2k_kernel, "syr2k"),
                      (rot_kernel, "rot_apply"), (rot_kernel, "chase_pass"),
                      (rot_kernel, "replay_pass")):
        monkeypatch.setattr(mod, name, boom)
    E = _t(_panel(12, 3, 1))
    hp_ops.house_panel(E, 2)
    syr2k_ops.syr2k(_t(_sym(6, 1)), E[:6], E[6:])
    rot_ops.rot_apply(_t(np.ones((2, 2, 3))), _t(np.ones((2, 2))))
    n, w = 12, 3
    Wp = torch.zeros((w + 2, 2 + n + 3 * w + 8), dtype=torch.float64)
    CS = rot_ops.chase_pass(Wp, w, w, n)
    rot_ops.replay_pass(torch.zeros((n, 2), dtype=torch.float64), CS, w, n,
                        True)


@pytest.mark.parametrize("call", [
    lambda x: hp_kernel.house_panel(x, 0),
    lambda x: syr2k_kernel.syr2k(x, x[:, :2], x[:, :2]),
    lambda x: rot_kernel.rot_apply(x[:2, :2].reshape(1, 2, 2), x[0, :2][None]),
    lambda x: rot_kernel.chase_pass(x, 2, 2, 3),
    lambda x: rot_kernel.replay_pass(x, x[None], 2, 4, False),
])
def test_kernel_wrappers_refuse_a_cpu_tensor(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros((4, 4), dtype=torch.float64))


def test_rot_apply_launch_counters_reset_and_read():
    rot_kernel.rot_apply.launches = 2
    rot_kernel.replay_pass.launches = 5
    rot_kernel.chase_pass.reduced["bf16"] = 3
    rot_kernel.reset_launches()
    assert rot_kernel.launch_counts() == {
        f"{k}{s}": 0 for k in ("rot_apply", "chase_pass", "replay_pass")
        for s in ("", "_fp32", "_bf16")}


@pytest.mark.parametrize("call", [
    lambda x: hp_ops.house_panel(x, 0),
    lambda x: syr2k_ops.syr2k(x, x[:, :2], x[:, :2]),
    lambda x: rot_ops.rot_apply(x[:2, :2].reshape(1, 2, 2), x[0, :2][None]),
    # a padded band of n=3, w=2: (w+2, P_LEFT + n + 3w + 8)
    lambda x: rot_ops.chase_pass(x.new_zeros((4, 19)), 2, 2, 3),
    lambda x: rot_ops.replay_pass(x, x[None], 2, 4, False),
])
def test_lower_precisions_run_the_plain_versions(call):
    # fp32 storage runs (the fp32 instances' plain versions on the CPU) and
    # returns fp32
    out = call(torch.zeros((4, 4), dtype=torch.float32))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == torch.float32 for o in outs)


@pytest.mark.parametrize("n", [9, 40, 97])
def test_chase_stagger_keeps_lane_footprints_disjoint(n):
    # the CUDA chase runs at a tighter stagger than the reference: a lane
    # at plane (r-1, r) touches only packed columns r-b-2 .. r, so lanes in
    # flight at one step must own disjoint column ranges (a footprint only
    # moves forward, by b a step, so the sweep ahead then stays ahead)
    for b in range(2, 17):
        if n - b <= 0:
            continue
        g, T_pass, G, J, K0 = rot_sched.pass_schedule(
            n, b, rot_sched.chase_stagger(b))
        assert g <= rot_sched.pass_schedule(n, b)[0]
        for t in range(T_pass):
            spans = []
            for l in range(G):
                j = min(t // g, J - 1) - l
                k = t - g * j
                if j >= 0 and 0 <= k < (n - 1 - j - b) // b + 1:
                    r = j + (k + 1) * b
                    spans.append((r - b - 2, r))
            spans.sort()
            for (_, hi), (lo, _) in zip(spans, spans[1:]):
                assert hi < lo, (n, b, t, spans)


@pytest.mark.parametrize("n,w", [(9, 7), (97, 16), (200, 5), (1001, 16)])
def test_cluster_ctas_take_every_active_lane_once(n, w):
    """At every step of every pass, the lanes that the cluster chase's CTAs
    take (``cta_lanes``, the kernel's decode) cover each active lane of the
    wavefront schedule exactly once, in the CTA that holds its plane, and
    each lane's footprint lies in that CTA's columns or the previous
    CTA's."""
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    for b in range(w, 1, -1):
        g = rot_sched.chase_stagger(b)
        _, T_pass, G, J, K0 = rot_sched.pass_schedule(n, b, g)
        plan = rot_kernel.chase_plan(npad, w, b)
        csize, cpc = plan.csize, plan.cpc
        assert plan.path == "cluster"
        assert csize * cpc >= npad and cpc >= w + 3
        for t in range(T_pass):
            jtop = min(t // g, J - 1)
            want = {j for j in range(max(jtop - G + 1, 0), jtop + 1)
                    if t - g * j < (n - 1 - j - b) // b + 1}
            got = []
            for rank in range(csize):
                c0 = rank * cpc
                for j in rot_sched.cta_lanes(t, c0, min(npad, c0 + cpc), b,
                                             g, J):
                    r = j + (t - g * j + 1) * b
                    if r <= n - 1:          # the kernel's k < K_j
                        assert c0 <= r + rot_sched.P_LEFT < c0 + cpc
                        # the footprint: this CTA's columns or the last's
                        assert r - b - 2 + rot_sched.P_LEFT >= c0 - cpc
                        got.append(j)
            assert sorted(got) == sorted(want)


@pytest.mark.parametrize("n,w,path,csize", [
    (9997, 16, "cluster", 16), (17243, 16, "cluster", 16),
    (17243, 32, "cooperative", 0), (4500, 100, "cooperative", 0),
    (512, 16, "cluster", 16), (9, 7, "cluster", 4)])
def test_chase_plan_by_band_size(n, w, path, csize):
    """The band in one cluster's distributed shared memory where a CTA's
    share (its columns and its lanes' (c, s)) fits and holds w+3 columns
    or more, else the cooperative kernel; a cluster size the card cannot
    run is skipped."""
    npad = rot_sched.P_LEFT + n + 3 * w + 8
    for b in (w, 2):
        plan = rot_kernel.chase_plan(npad, w, b)
        assert (plan.path, plan.csize) == (path, csize)
        if path == "cluster":
            assert plan.smem <= rot_kernel.SMEM_MAX
            assert plan.csize * plan.cpc >= npad
    if path == "cluster":     # a card that runs clusters of 8 only
        eight = rot_kernel.chase_plan(npad, w, w, lambda c, smem: c == 8)
        cpc, smem = rot_kernel.cluster_share(npad, w, w, 8)
        fits = smem <= rot_kernel.SMEM_MAX and cpc >= w + 3
        assert (eight.path, eight.csize) == (
            ("cluster", 8) if fits else ("cooperative", 0))


def test_pass_schedule_matches_the_reference():
    for n in (3, 9, 40, 97, 9997):
        for b in range(2, 17):
            if n - b > 0:
                assert rot_sched.pass_schedule(n, b) == \
                    j_sbr._pass_schedule(n, b)


@pytest.mark.parametrize("n,w", [(3, 2), (40, 4), (97, 16)])
def test_padded_band_layout(n, w):
    # the chase's storage: Wb in place, column-major, zero everywhere else
    Wb = torch.arange(1.0, (w + 1) * n + 1, dtype=torch.float64).reshape(
        w + 1, n)
    Wp = rot_sched.padded_band(Wb, w)
    P = rot_sched.P_LEFT
    assert tuple(Wp.shape) == (w + 2, P + n + 3 * w + 8)
    assert Wp.stride() == (1, w + 2)
    assert torch.equal(Wp[: w + 1, P: P + n], Wb)
    Wp[: w + 1, P: P + n] = 0.0
    assert not bool(Wp.any())
