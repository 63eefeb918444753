"""TT1/TT2 — two-stage tridiagonalization (SBR toolbox analogue).

Stage 1 (``reduce_to_band``, DSYRDB): dense -> band of width w by panel QR
and compact-WY two-sided updates. Each panel is one ``house_panel``
launch (the compact-WY (V, T) of the panel), and the trailing update is
one SYR2K of rank 2w (``syr2k``, symmetrized in the same launch) against
the panels (V, Z) of ``linalg_utils.wy_syr2k_panel``; Q1 is accumulated
explicitly by GEMMs, as the paper describes. The panels run over the
reference's shrinking-window ladder (``default_n_chunks``): the
reflectors of panel k are zero above row (k+1) w, so the two-sided update
is the identity before the window and only the (S, S) trailing window
can change. The reference compiles the sweep into one program; here it
is a host loop that queues its launches without waiting on the card.

Stage 2 (``band_chase``, DSBRDT): band -> tridiagonal by Givens bulge
chasing over packed band storage (``core.band_storage``), in the
Schwarz/Kaufman wavefront schedule: per time step every in-flight column
sweep advances one chase step, and those rotations are disjoint by the
stagger of the schedule. One bandwidth pass is ONE ``chase_pass`` launch
on the card (the plain version is the reference's gather / rotate /
scatter loop). The (c, s) stream is recorded per pass and replayed by
``replay_pass``, onto Q1^T for the explicit Q (``band_to_tridiag``) or
onto the thin (n, s) eigenvector slab (``apply_q2``, the production path).

``band_to_tridiag_dense`` is the dense one-rotation-at-a-time oracle.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.house_panel.ops import house_panel
from repro_torch.kernels.rot_apply import ops as rot_ops
# the pass schedule lives beside the chase kernel, which decodes it
from repro_torch.kernels.rot_apply.schedule import P_LEFT as _P_LEFT
from repro_torch.kernels.rot_apply.schedule import padded_band
from repro_torch.kernels.rot_apply.schedule import \
    pass_schedule as _pass_schedule  # noqa: F401
from repro_torch.kernels.syr2k.ops import syr2k

from .band_storage import clean_band, pack_band, unpack_band
from .instrument import DispatchCounter
from .linalg_utils import (extract_tridiag, givens, rotate_cols, rotate_rows,
                           symmetrize, wy_syr2k_panel)
from .precision import matmul_acc, padded_copy


class BandResult(NamedTuple):
    Wb: torch.Tensor  # (w+1, n) packed band (core.band_storage), W = Q1^T C Q1
    Q1: torch.Tensor  # (n, n) explicit orthogonal factor

    def dense(self) -> torch.Tensor:
        """The banded matrix expanded to dense (n, n) — tests."""
        return unpack_band(self.Wb)


_dispatch = DispatchCounter()

#: TT1 sweeps entered (one per ``reduce_to_band`` call) since the last
#: ``reset_dispatch_count()``; the kernel launches of a sweep are in
#: ``repro_torch.kernels.launch_counts()``
dispatch_count = _dispatch.count
reset_dispatch_count = _dispatch.reset


def _chunk_bounds(n_panels: int, n_chunks: int):
    """Static panel ranges for the shrinking-window ladder."""
    n_chunks = max(1, min(n_chunks, n_panels))
    bounds = [round(c * n_panels / n_chunks) for c in range(n_chunks + 1)]
    return [(bounds[c], bounds[c + 1]) for c in range(n_chunks)
            if bounds[c + 1] > bounds[c]]


def _n_panels(n: int, w: int) -> int:
    return len(range(0, max(n - w - 1, 0), w))


# the reference's thresholds (measured there: the ladder's extra windows
# cost more than its ~1/3 flop saving at small n or with few panels)
_WINDOW_MIN_N = 256        # below: never ladder
_WINDOW_AUTO_N = 512       # at/above: always ladder
_WINDOW_MIN_PANELS = 16    # in between: need enough panels to amortize


def default_n_chunks(n: int, w: int) -> int:
    """Auto-sized shrinking-window ladder: up to 4 trailing windows once
    the problem is big enough (``n >= 512``, or ``n >= 256`` with at least
    16 panels); 1 (full-matrix updates) otherwise."""
    n_panels = _n_panels(n, w)
    if n_panels == 0:
        return 1
    if n >= _WINDOW_AUTO_N or (n >= _WINDOW_MIN_N
                               and n_panels >= _WINDOW_MIN_PANELS):
        return min(4, n_panels)
    return 1


def _wy_rank2_update(Mt: torch.Tensor, V: torch.Tensor,
                     T: torch.Tensor) -> torch.Tensor:
    """Q^T Mt Q with Q = I - V T V^T, IN PLACE on ``Mt``: the SYR2K form
    symmetrize(syr2k(Mt, V, Z, alpha=-1)), one ``syr2k`` launch on the
    card (the reference's TPU branch), the plain version on the CPU."""
    Z = wy_syr2k_panel(Mt, V, T)
    return syr2k(Mt, V, Z, alpha=-1.0, symmetrize=True, out=Mt)


def _reduce_to_band_sweep(C: torch.Tensor, w: int,
                          n_chunks: int) -> BandResult:
    n = C.shape[0]
    Q1 = torch.eye(n, dtype=C.dtype, device=C.device)
    n_panels = _n_panels(n, w)
    if n_panels == 0:
        return BandResult(Wb=pack_band(C, w, symmetrize=True), Q1=Q1)
    # below fp64 the working copy's rows start on 16-byte boundaries, so
    # every window M[o:, o:] (o a multiple of w) takes the reduced syr2k's
    # 16-byte path; fp64 keeps C's layout
    M = C.clone() if C.dtype == torch.float64 else padded_copy(C, C.dtype)
    for p0, p1 in _chunk_bounds(n_panels, n_chunks):
        o = p0 * w                 # window origin
        Mt = M[o:, o:]             # views: the window is updated in place
        Q1t = Q1[:, o:]
        for p in range(p0, p1):
            c0 = p * w - o         # panel start inside the window
            V, T = house_panel(Mt[:, c0: c0 + w], c0 + w)
            _wy_rank2_update(Mt, V, T)
            # explicit Q1 accumulation: Q1t <- Q1t - ((Q1t V) T) V^T
            Q1t.addmm_(matmul_acc(matmul_acc(Q1t, V), T), V.mT, alpha=-1.0)
    return BandResult(Wb=pack_band(M, w, symmetrize=True), Q1=Q1)


def reduce_to_band(C: torch.Tensor, w: int = 32,
                   n_chunks: int | None = None) -> BandResult:
    """Stage 1: Q1^T C Q1 = W with bandwidth w. Panel QR + WY updates.

    Panels are grouped into a ladder of trailing windows (``n_chunks``;
    ``None`` auto-sizes it with :func:`default_n_chunks`, 1 is the
    full-(n, n) update). The windows are views of one working copy of C
    and of Q1, and every update runs in place on them; C itself is not
    changed. Returns the band in packed (w+1, n) storage plus Q1.
    """
    if n_chunks is None:
        n_chunks = default_n_chunks(C.shape[0], w)
    return _dispatch(_reduce_to_band_sweep, C, w, n_chunks)


class TridiagFromBandResult(NamedTuple):
    d: torch.Tensor   # (n,)
    e: torch.Tensor   # (n-1,)
    Q: torch.Tensor   # (n, n) accumulated Q1*Q2


class BandChaseResult(NamedTuple):
    """Chase output with the rotation stream kept implicit.

    ``cs[i]`` is the (J+1, K0+1, 2) (c, s) table of the i-th executed pass
    (bandwidths ``_executed_passes(n, w)``); slot (j, k) is chase step k of
    column j's sweep, unused slots hold the identity rotation.
    """
    d: torch.Tensor
    e: torch.Tensor
    cs: Tuple[torch.Tensor, ...]


def _executed_passes(n: int, w: int):
    return [b for b in range(w, 1, -1) if n - b > 0]


def band_chase(Wb: torch.Tensor, w: int) -> BandChaseResult:
    """TT2 without explicit Q: chase the band, keep the rotation stream.

    One ``chase_pass`` per executed bandwidth (b = w..2) over the padded
    storage of ``rot_apply.schedule.padded_band``. Each pass leaves an
    exact bandwidth-(b-1) matrix.
    """
    wp1, n = Wb.shape
    if w <= 1 or n <= 2:
        e = (Wb[1, : n - 1] if w >= 1
             else Wb.new_zeros((max(n - 1, 0),)))
        return BandChaseResult(d=Wb[0, :].clone(), e=e.clone(), cs=())
    if wp1 != w + 1:
        raise ValueError(f"Wb must be (w+1, n) = ({w + 1}, n), got "
                         f"{tuple(Wb.shape)}")
    Wp = padded_band(clean_band(Wb), w)
    cs = tuple(rot_ops.chase_pass(Wp, b, w, n)
               for b in _executed_passes(n, w))
    d = Wp[0, _P_LEFT: _P_LEFT + n].clone()
    e = Wp[1, _P_LEFT: _P_LEFT + n - 1].clone()
    return BandChaseResult(d=d, e=e, cs=cs)


def _check_stream(chase: BandChaseResult, n: int, w: int):
    """The executed passes of an (n, w) chase, which ``chase`` must hold."""
    passes = _executed_passes(n, w)
    if len(passes) != len(chase.cs):
        raise ValueError(f"the chase holds {len(chase.cs)} rotation tables; "
                         f"n={n}, w={w} needs {len(passes)}")
    return passes


def _rows(X: torch.Tensor) -> torch.Tensor:
    """A row-major copy for the replay, which updates it in place."""
    return X.clone(memory_format=torch.contiguous_format)


def apply_q2(chase: BandChaseResult, Z: torch.Tensor, w: int) -> torch.Tensor:
    """Compute Q2 @ Z from the recorded rotation stream (Z is (n, s)).

    Rotations recorded as Q <- Q G hit Z from the LAST one: passes in
    reverse (b = 2..w), sweeps within a pass in reverse, each (c, s)
    transposed. One ``replay_pass`` per pass.
    """
    n = Z.shape[0]
    passes = _check_stream(chase, n, w)
    Y = _rows(Z)
    for b, CS in zip(reversed(passes), reversed(chase.cs)):
        rot_ops.replay_pass(Y, CS, b, n, reverse=True)
    return Y


def accumulate_q2(chase: BandChaseResult, Q1: torch.Tensor,
                  w: int) -> torch.Tensor:
    """Explicit Q1 @ Q2 by replaying the stream onto Q1^T in chase order."""
    n = Q1.shape[1]
    passes = _check_stream(chase, n, w)
    Qt = _rows(Q1.mT)
    for b, CS in zip(passes, chase.cs):
        rot_ops.replay_pass(Qt, CS, b, n, reverse=False)
    return Qt.mT


def band_to_tridiag(Wb: torch.Tensor, Q1: torch.Tensor,
                    w: int) -> TridiagFromBandResult:
    """Stage 2 with explicit Q: wavefront chase + Q2 accumulated onto Q1
    (pass ``torch.eye(n)`` for Q2 alone). When only s << n vectors are
    needed, use :func:`band_chase` + :func:`apply_q2` instead."""
    chase = band_chase(Wb, w)
    if not chase.cs:
        return TridiagFromBandResult(d=chase.d, e=chase.e, Q=Q1)
    return TridiagFromBandResult(d=chase.d, e=chase.e,
                                 Q=accumulate_q2(chase, Q1, w))


def band_to_tridiag_dense(W: torch.Tensor, Q1: torch.Tensor,
                          w: int) -> TridiagFromBandResult:
    """Dense-storage TT2 oracle: one row/column rotation per chase step,
    in the sequential order, on copies of the dense (n, n) W and Q1."""
    n = W.shape[0]
    M = W.clone()
    Q = Q1.clone()
    idx = torch.arange(n, device=W.device)
    dist = torch.abs(idx[:, None] - idx[None, :])
    for b in range(w, 1, -1):
        if n - b <= 0:
            continue
        for j in range(n - b):
            r, c = j + b, j
            while r < n:
                # annihilate M[r, c] with rows (r-1, r)
                cth, sth = givens(M[r - 1, c], M[r, c])
                rotate_rows(M, r - 1, r, cth, sth)
                rotate_cols(M, r - 1, r, cth, sth)
                # pin the upper copy of the (r-1, r) pair to the lower one,
                # so M stays exactly symmetric (packed storage holds one)
                M[r - 1, r] = M[r, r - 1]
                rotate_cols(Q, r - 1, r, cth, sth)
                r, c = r + b, r - 1
        # zero the annihilated diagonals' O(eps) residue
        M = torch.where(dist >= b, 0.0, M)
    d, e = extract_tridiag(symmetrize(M))
    return TridiagFromBandResult(d=d, e=e, Q=Q)


def two_stage_tridiagonalize(C: torch.Tensor, w: int = 32):
    """TT1+TT2 composed: returns (d, e, Q) with Q^T C Q = T, Q explicit."""
    band = reduce_to_band(C, w=w)
    return band_to_tridiag(band.Wb, band.Q1, w)


__all__ = ["BandResult", "BandChaseResult", "TridiagFromBandResult",
           "reduce_to_band", "default_n_chunks", "band_chase", "apply_q2",
           "accumulate_q2", "band_to_tridiag", "band_to_tridiag_dense",
           "two_stage_tridiagonalize", "dispatch_count",
           "reset_dispatch_count"]
