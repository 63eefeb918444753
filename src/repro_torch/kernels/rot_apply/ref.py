"""Plain PyTorch versions of the Givens rotations of TT2 and TT4.

- ``rot_apply_ref``: G rotations of G row pairs, (c x0 + s x1, -s x0 + c x1)
  — ``linalg_utils.rotate_rows`` on G disjoint pairs at once.
- ``chase_pass_ref``: one wavefront bandwidth pass of the bulge chase, the
  reference's ``_chase_pass`` (``repro/core/sbr.py``) written in torch: per
  time step a dense window gather, ``givens``, two rotations (rows, then
  columns) and a scatter. A host loop of ``T_pass`` steps.
- ``replay_pass_ref``: one pass of the recorded rotations applied to row
  storage, sweep by sweep (the reference's ``_replay_pass``).

The CPU tests use the plain versions; on the card
only ``chip_smoke.py``'s comparison runs them (on CPU copies).
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg_utils import givens

from .schedule import P_LEFT, identity_table, pass_schedule

def rot_apply_ref(pairs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """pairs (G, 2, L), cs (G, 2): out0 = c x0 + s x1, out1 = -s x0 + c x1."""
    c = cs[:, 0][:, None]
    s = cs[:, 1][:, None]
    x0 = pairs[:, 0, :]
    x1 = pairs[:, 1, :]
    return torch.stack([c * x0 + s * x1, -s * x0 + c * x1], dim=1)


def chase_pass_ref(Wp: torch.Tensor, b: int, w: int, n: int) -> torch.Tensor:
    """One bandwidth-b pass (b -> b-1) over the padded band ``Wp``
    (w+2, npad), IN PLACE; returns the pass's (J+1, K0+1, 2) table.

    ``Wp[d, P_LEFT + i] = W[i+d, i]``, with one spare diagonal for the
    bulge and zero margins; idle lanes work on an all-zero dump window at
    the right end, which stays zero.
    """
    g, T_pass, G, J, K0 = pass_schedule(n, b)
    L = 2 * b + 4                  # local window: columns [r-b-2, r+b+1]
    dev = Wp.device
    dump = Wp.shape[1] - L
    ar = torch.arange(L, device=dev)
    pgrid, qgrid = ar[:, None], ar[None, :]
    dd = torch.abs(pgrid - qgrid)                   # (L, L) |row - col|
    mm = torch.minimum(pgrid, qgrid)                # (L, L) min(row, col)
    dvalid = dd <= w + 1
    dclip = torch.clamp(dd, 0, w + 1)
    drow = torch.arange(w + 2, device=dev)[:, None]
    in_win = (drow + qgrid) < L                     # packed entry in window
    rowsel = torch.clamp(drow + qgrid, 0, L - 1)
    qcols = qgrid.expand(w + 2, L)
    lanes = torch.arange(G, device=dev)
    CS = identity_table(J, K0, Wp)

    for t in range(T_pass):
        j = min(t // g, J - 1) - lanes              # lane l rides jtop - l
        k = t - g * j                               # chase step of the lane
        Kj = torch.div(n - 1 - j - b, b, rounding_mode="floor") + 1
        active = (j >= 0) & (k >= 0) & (k < Kj)
        r = j + (k + 1) * b                         # rotation plane (r-1, r)
        sk = (k > 0).to(j.dtype)                    # bulge (1) or first (0)
        i0 = torch.where(active, r - b - 2 + P_LEFT, dump)

        # each lane's local dense (L, L) window from packed storage
        local = torch.where(dvalid, Wp[dclip, i0[:, None, None] + mm], 0.0)

        # annihilate local[b+2, 2-sk] against local[b+1, 2-sk]
        tcol = (2 - sk)[:, None]
        a_piv = torch.gather(local[:, b + 1, :], 1, tcol)[:, 0]
        a_ann = torch.gather(local[:, b + 2, :], 1, tcol)[:, 0]
        cth, sth = givens(a_piv, a_ann)
        cs = torch.stack([cth, sth], dim=1)         # (G, 2)
        CS[torch.where(active, j, J), torch.where(active, k, K0)] = cs

        # two-sided rotation of local rows, then columns (b+1, b+2)
        local[:, b + 1: b + 3, :] = rot_apply_ref(local[:, b + 1: b + 3, :],
                                                  cs)
        cols = rot_apply_ref(local[:, :, b + 1: b + 3].transpose(1, 2), cs)
        local[:, :, b + 1: b + 3] = cols.transpose(1, 2)

        # scatter the packed windows back (lane windows are disjoint)
        wcols = i0[:, None] + ar[None, :]           # (G, L)
        old_win = Wp[:, wcols].movedim(1, 0)        # (G, w+2, L)
        new_win = torch.where(in_win, local[:, rowsel, qcols], old_win)
        Wp[:, wcols] = new_win.movedim(0, 1)
    # the annihilated diagonals carry O(eps) residue: zero them
    Wp[b:, :] = 0.0
    return CS


def replay_pass_ref(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                    reverse: bool) -> torch.Tensor:
    """Apply one pass's recorded rotations to the rows of ``Xp`` IN PLACE.

    Sweep-major: the rotations of one column sweep touch pairwise disjoint
    row pairs (planes b >= 2 apart), so a sweep is one batched rotation;
    sweeps run forward (chase order, for Q1 Q2) or backward (for Q2 Z,
    each (c, s) flipped to (c, -s)). Slots past a sweep's end hold the
    identity and are skipped.
    """
    J, K0 = CS.shape[0] - 1, CS.shape[1] - 1
    flip = torch.tensor([1.0, -1.0], dtype=CS.dtype, device=CS.device)
    for i in range(J):
        j = (J - 1 - i) if reverse else i
        Kj = (n - 1 - j - b) // b + 1
        r = j + (torch.arange(Kj, device=Xp.device) + 1) * b
        rows = torch.stack([r - 1, r], dim=1)       # (Kj, 2)
        cs = CS[j, :Kj]
        if reverse:
            cs = cs * flip
        Xp[rows] = rot_apply_ref(Xp[rows], cs)
    return Xp


__all__ = ["rot_apply_ref", "chase_pass_ref", "replay_pass_ref"]
