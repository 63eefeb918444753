"""The TT stages of the PyTorch port (``core/sbr.py``) against the JAX
reference (``repro.core.sbr``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs as its own tests run it on the CPU (its jnp expressions;
the Pallas kernels' interpret-mode parity is in
``tests/test_torch_tt_kernels.py``).

Tolerances. The chase annihilates entries that are rounding residue, so
the angles of later rotations depend on the last bits of earlier ones:
two correct implementations of the same rotation sequence (and XLA
contracts the rotations into FMAs where the port does not) agree in d
and e only as far as T's forward sensitivity allows, which on some
inputs is far above u ||W||. The spectrum of T is the stable invariant:
it is held to 1e-12 ||W||_2, and d and e to the larger of that and the
reference's own wavefront-vs-dense spread on the same input. Q1, Q2 and
the replayed slabs are orthogonal transforms of O(1) entries and are
held to 1e-12 absolutely.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sbr as j_sbr
from repro.core.band_storage import unpack_band as j_unpack
from repro_torch.core import sbr
from repro_torch.core.band_storage import unpack_band

TOL = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _sym(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (A + A.T)


def _tri(d, e):
    d, e = np.asarray(d), np.asarray(e)
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _norm2(M):
    return float(np.abs(np.linalg.eigvalsh(M)).max())


# ------------------------------------------------------ static schedules --

def test_default_n_chunks_at_the_reference_points():
    # tests/test_house_panel.py's points, and agreement over a grid
    points = {(128, 8): 1, (128, 32): 1, (255, 8): 1, (256, 8): 4,
              (256, 32): 1, (512, 8): 4, (512, 32): 4, (300, 200): 1,
              (300, 128): 1, (16, 8): 1, (9997, 16): 4}
    for (n, w), want in points.items():
        assert sbr.default_n_chunks(n, w) == want == j_sbr.default_n_chunks(
            n, w)
    for n in (3, 17, 100, 257, 300, 511, 700):
        for w in (2, 5, 8, 16, 32):
            assert sbr.default_n_chunks(n, w) == j_sbr.default_n_chunks(n, w)
            assert sbr._n_panels(n, w) == j_sbr._n_panels(n, w)
            for c in (1, 2, 4, 7):
                assert sbr._chunk_bounds(sbr._n_panels(n, w), c) == \
                    j_sbr._chunk_bounds(j_sbr._n_panels(n, w), c)
            assert sbr._executed_passes(n, w) == j_sbr._executed_passes(n, w)


def test_md_size_schedule():
    # the TT1 ladder and the TT2 passes at the paper's MD size
    n, w = 9997, 16
    assert sbr._n_panels(n, w) == 624
    assert len(sbr._chunk_bounds(624, sbr.default_n_chunks(n, w))) == 4
    passes = sbr._executed_passes(n, w)
    assert passes == list(range(16, 1, -1))
    assert sum(sbr._pass_schedule(n, b)[1] for b in passes) == 489403


# ------------------------------------------------------------------ TT1 --

@pytest.mark.parametrize("n,w,n_chunks", [(40, 4, 1), (65, 8, 1),
                                          (96, 16, 1), (128, 16, 1),
                                          (256, 8, None)])
def test_reduce_to_band_vs_reference(n, w, n_chunks):
    C = _sym(n, n * 3 + w)
    ref = j_sbr.reduce_to_band(jnp.asarray(C), w=w, n_chunks=n_chunks)
    got = sbr.reduce_to_band(_t(C), w=w, n_chunks=n_chunks)
    # the band is O(||C||): a backward-stable sweep agrees to u ||C|| times
    # the depth of the panel updates; Q1 is orthogonal, entries O(1)
    scale = max(1.0, _norm2(C))
    assert np.abs(got.Wb.numpy() - np.asarray(ref.Wb)).max() <= TOL * scale
    assert np.abs(got.Q1.numpy() - np.asarray(ref.Q1)).max() <= TOL
    if n_chunks is None:
        assert sbr.default_n_chunks(n, w) == 4 and sbr._n_panels(n, w) == 31


def test_rank2_update_is_the_two_sided_wy_update():
    # the sweep's update (syr2k of (V, Z), symmetrized, in place) against
    # linalg_utils.apply_wy_two_sided_syr2k and the reference's form; the
    # expressions round apart by u ||C||
    from repro.core.linalg_utils import apply_wy_two_sided_syr2k as j_wy
    from repro_torch.core.linalg_utils import apply_wy_two_sided_syr2k
    from repro_torch.kernels.house_panel.ops import house_panel
    C = _t(_sym(40, 2))
    V, T = house_panel(C[:, :5], 5)
    want = apply_wy_two_sided_syr2k(C, V, T)
    M = C.clone()
    sbr._wy_rank2_update(M, V, T)
    torch.testing.assert_close(M, want, rtol=0, atol=1e-13 * _norm2(C.numpy()))
    assert torch.equal(M, M.mT)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(j_wy(jnp.asarray(C.numpy()),
                                      jnp.asarray(V.numpy()),
                                      jnp.asarray(T.numpy()))),
        rtol=0, atol=1e-13 * _norm2(C.numpy()))


def test_replay_refuses_a_stream_of_another_size():
    C = _t(_sym(20, 4))
    band = sbr.reduce_to_band(C, w=4)
    chase = sbr.band_chase(band.Wb, 4)
    with pytest.raises(ValueError, match="rotation tables"):
        sbr.apply_q2(chase, torch.zeros((20, 2), dtype=torch.float64), 5)


def test_reduce_to_band_invariants_and_window_ladder():
    n, w = 80, 8
    C = _t(_sym(n, 99))
    full = sbr.reduce_to_band(C, w=w, n_chunks=1)
    win = sbr.reduce_to_band(C, w=w, n_chunks=4)
    torch.testing.assert_close(win.Wb, full.Wb, rtol=0, atol=1e-11)
    torch.testing.assert_close(win.Q1, full.Q1, rtol=0, atol=1e-11)
    torch.testing.assert_close(win.Q1.mT @ C @ win.Q1, win.dense(), rtol=0,
                               atol=1e-12 * _norm2(C.numpy()))
    torch.testing.assert_close(win.Q1.mT @ win.Q1,
                               torch.eye(n, dtype=torch.float64), rtol=0,
                               atol=1e-13)


def test_reduce_to_band_leaves_c_alone_and_counts_sweeps():
    C = _t(_sym(30, 1))
    C0 = C.clone()
    sbr.reset_dispatch_count()
    sbr.reduce_to_band(C, w=4)
    sbr.reduce_to_band(C, w=40)          # no panel: packs C as it is
    assert sbr.dispatch_count() == 2
    assert torch.equal(C, C0)


# ------------------------------------------------------------------ TT2 --

# the PARITY_GRID of tests/test_band_sbr.py: odd/even n, w | n and w not |
# n, and the n <= w+2 degenerate corner
PARITY_GRID = [(40, 4), (41, 5), (64, 8), (65, 8), (37, 7), (96, 16),
               (9, 7), (10, 8), (6, 8)]


def _reference_band(n, w, seed):
    C = _sym(n, seed)
    return C, j_sbr.reduce_to_band(jnp.asarray(C), w=w)


@pytest.mark.parametrize("n,w", PARITY_GRID)
def test_band_chase_vs_reference(n, w):
    C, band = _reference_band(n, w, n * 100 + w)
    ref = j_sbr.band_chase(band.Wb, w)
    got = sbr.band_chase(_t(band.Wb), w)
    bar = TOL * max(1.0, _norm2(C))
    # T is forward-sensitive to rounding: the reference's own wavefront
    # and dense chases (the same rotations in two orders) differ by 1.5e-9
    # in d at (96, 16) on this input, where its eigenvalues agree to 4e-14.
    # So d and e are held to the larger of 1e-12 ||W|| and twice that
    # spread, and the spectrum of T to 1e-12 ||W||
    dense = j_sbr.band_to_tridiag_dense(j_unpack(band.Wb), band.Q1, w)
    for x, x_ref, x_dense in ((got.d, ref.d, dense.d),
                              (got.e, ref.e, dense.e)):
        x_ref = np.asarray(x_ref)
        spread = np.abs(x_ref - np.asarray(x_dense)).max(initial=0.0)
        assert np.abs(x.numpy() - x_ref).max(initial=0.0) <= max(
            bar, 2 * spread)
    np.testing.assert_allclose(np.linalg.eigvalsh(_tri(got.d, got.e)),
                               np.linalg.eigvalsh(_tri(ref.d, ref.e)),
                               rtol=0, atol=bar)
    assert len(got.cs) == len(ref.cs)
    for a, b in zip(got.cs, ref.cs):
        assert tuple(a.shape) == b.shape     # (J+1, K0+1, 2) per pass
    # the replay against the reference's, both on the reference's stream:
    # the same rotations, rounded apart by ulps
    s = min(4, n)
    Z = np.random.default_rng(n).standard_normal((n, s))
    chase_ref_cs = sbr.BandChaseResult(d=got.d, e=got.e,
                                       cs=tuple(_t(c) for c in ref.cs))
    np.testing.assert_allclose(
        sbr.apply_q2(chase_ref_cs, _t(Z), w).numpy(),
        np.asarray(j_sbr.apply_q2(ref, jnp.asarray(Z), w)), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        sbr.accumulate_q2(chase_ref_cs, _t(band.Q1), w).numpy(),
        np.asarray(j_sbr.accumulate_q2(ref, band.Q1, w)), rtol=0, atol=TOL)


@pytest.mark.parametrize("n,w", [(40, 4), (37, 7), (64, 8), (9, 7), (6, 8)])
def test_chase_and_replay_vs_the_dense_oracle(n, w):
    # the port's wavefront chase, explicit Q and Q2-applied slab against
    # the port's dense oracle (the reference test's comparison)
    C = _t(_sym(n, n * 17 + w))
    band = sbr.reduce_to_band(C, w=w)
    dense = sbr.band_to_tridiag_dense(unpack_band(band.Wb), band.Q1, w)
    got = sbr.band_to_tridiag(band.Wb, band.Q1, w)
    bar = TOL * max(1.0, _norm2(C.numpy()))
    assert float((got.d - dense.d).abs().max()) <= bar
    assert float((got.e - dense.e).abs().max()) <= bar
    assert float((got.Q - dense.Q).abs().max()) <= TOL
    Z = _t(np.random.default_rng(2).standard_normal((n, 3)))
    chase = sbr.band_chase(band.Wb, w)
    assert float((band.Q1 @ sbr.apply_q2(chase, Z, w)
                  - dense.Q @ Z).abs().max()) <= TOL
    # the invariants: Q orthogonal, Q^T C Q = tridiag(d, e)
    T = torch.diag(got.d) + torch.diag(got.e, 1) + torch.diag(got.e, -1)
    torch.testing.assert_close(got.Q.mT @ got.Q,
                               torch.eye(n, dtype=torch.float64), rtol=0,
                               atol=TOL)
    torch.testing.assert_close(got.Q.mT @ C @ got.Q, T, rtol=0, atol=bar)


@pytest.mark.parametrize("n,w", [(40, 4), (9, 7)])
def test_dense_oracle_vs_reference(n, w):
    C, band = _reference_band(n, w, n + w)
    ref = j_sbr.band_to_tridiag_dense(j_unpack(band.Wb), band.Q1, w)
    got = sbr.band_to_tridiag_dense(unpack_band(_t(band.Wb)), _t(band.Q1),
                                    w)
    bar = TOL * max(1.0, _norm2(C))
    assert np.abs(got.d.numpy() - np.asarray(ref.d)).max() <= bar
    assert np.abs(got.e.numpy() - np.asarray(ref.e)).max() <= bar
    assert np.abs(got.Q.numpy() - np.asarray(ref.Q)).max() <= TOL


def test_degenerate_bands_skip_the_chase():
    for n, w in ((2, 4), (1, 3), (5, 1), (5, 0)):
        Wb = _t(np.random.default_rng(n).standard_normal((w + 1, n)))
        got = sbr.band_chase(Wb, w)
        ref = j_sbr.band_chase(jnp.asarray(Wb.numpy()), w)
        assert got.cs == () == ref.cs
        np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d))
        np.testing.assert_array_equal(got.e.numpy(), np.asarray(ref.e))
        Z = _t(np.ones((n, 2)))
        assert torch.equal(sbr.apply_q2(got, Z, w), Z)


def test_two_stage_tridiagonalize_preserves_the_spectrum():
    n = 70
    C = _t(_sym(n, 5))
    d, e, Q = sbr.two_stage_tridiagonalize(C, w=6)
    T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    torch.testing.assert_close(torch.linalg.eigvalsh(T),
                               torch.linalg.eigvalsh(C), rtol=0,
                               atol=TOL * _norm2(C.numpy()))
    torch.testing.assert_close(Q.mT @ C @ Q, T, rtol=0,
                               atol=TOL * _norm2(C.numpy()))
    jax_d, jax_e, _ = j_sbr.two_stage_tridiagonalize(jnp.asarray(C.numpy()),
                                                     w=6)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(
        np.diag(jax_d) + np.diag(jax_e, 1) + np.diag(jax_e, -1))),
        torch.linalg.eigvalsh(T).numpy(), rtol=0,
        atol=TOL * _norm2(C.numpy()))


def test_info_of_band_result():
    C = _t(_sym(12, 3))
    band = sbr.reduce_to_band(C, w=3)
    assert band.Wb.shape == (4, 12)
    assert torch.equal(band.dense(), unpack_band(band.Wb))
