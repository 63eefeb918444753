"""Plain PyTorch versions of the Givens rotations of TT2 and TT4.

- ``rot_apply_ref``: G rotations of G row pairs, (c x0 + s x1, -s x0 + c x1)
  — ``linalg_utils.rotate_rows`` on G disjoint pairs at once.
- ``chase_pass_ref``: one wavefront bandwidth pass of the bulge chase, the
  reference's ``_chase_pass`` (``repro/core/sbr.py``) written in torch: per
  time step a dense window gather, ``givens``, two rotations (rows, then
  columns) and a scatter. A host loop of ``T_pass`` steps.
- ``replay_pass_ref``: one pass of the recorded rotations applied to row
  storage, sweep by sweep (the reference's ``_replay_pass``).
- ``chase_pass_lanes_ref``: the same pass in the CUDA chase's form: in
  place on the packed band, each lane rotating only the entries it
  changes, at the CUDA stagger (``schedule.chase_stagger``). It is what a
  CPU tensor runs (``ops.chase_pass``), the plain version of every chase
  instance; in fp64 it gives ``chase_pass_ref``'s bits, which the tests
  hold it to.

Below fp64 (float32 or bfloat16 storage) every version computes in fp32
and rounds to the storage dtype where the kernels store: each rotated
entry; (c, s), computed in fp32 from the stored pivot and target; and the
chase's 2 x 2 block between its row and its column rotation.

The CPU tests use the plain versions; on the card
only ``chip_smoke.py``'s comparison runs them (on CPU copies, or on the
card where the host would take minutes).
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg_utils import givens

from .schedule import P_LEFT, chase_stagger, identity_table, pass_schedule


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of a storage dtype: fp64 in kind, else fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rot_apply_ref(pairs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """pairs (G, 2, L), cs (G, 2): out0 = c x0 + s x1, out1 = -s x0 + c x1,
    computed in ``acc_dtype`` and stored in the pairs' dtype."""
    acc = acc_dtype(pairs.dtype)
    c = cs[:, 0][:, None].to(acc)
    s = cs[:, 1][:, None].to(acc)
    x0 = pairs[:, 0, :].to(acc)
    x1 = pairs[:, 1, :].to(acc)
    return torch.stack([c * x0 + s * x1, -s * x0 + c * x1],
                       dim=1).to(pairs.dtype)


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


def chase_pass_lanes_ref(Wp: torch.Tensor, b: int, w: int,
                         n: int) -> torch.Tensor:
    """One bandwidth-b pass over the padded band ``Wp`` IN PLACE, as the
    cooperative CUDA chase runs it; returns the (J+1, K0+1, 2) table.

    At step t the active lanes are the columns j whose plane (r-1, r), r =
    (t+1) b - j (g b - 1), lies inside the band; each loads its pivot and
    target, its 2 x 2 block, and its row pairs (rows r-1, r left of the
    block: b+1 packed columns) and column pairs (columns r-1, r below it);
    entries below the w+2 stored diagonals read as zero and are not
    written. All loads of a step come before its stores, and the lanes'
    footprints are disjoint (``schedule.chase_stagger``).
    """
    g, T_pass, _, J, K0 = pass_schedule(n, b, chase_stagger(b))
    dt = Wp.dtype
    acc = acc_dtype(dt)
    dev = Wp.device
    CS = identity_table(J, K0, Wp)
    D = g * b - 1

    def rnd(x):
        return x.to(dt).to(acc)

    # A lane's loads, as (diagonal, packed column - c0) with c0 = r-b-2+P_LEFT:
    # its 2b+2 pairs (rows r-1, r at columns c0 + q, q <= b; then columns
    # r-1, r below the block), first entries then second entries; the
    # pivot and target (columns c0 + 2 - sk, diagonals b-1+sk and b+sk);
    # and the block W[r-1, r-1], W[r, r-1], W[r, r]. Diagonals past w+1
    # are not stored: they read as zero and are not written.
    q = torch.arange(2 * b + 2, device=dev)
    row = q <= b
    d = torch.cat([torch.where(row, b + 1 - q, q + 1 - b),
                   torch.where(row, b + 2 - q, q - b),
                   torch.tensor([b - 1, b, 0, 1, 0], device=dev)])
    o = torch.cat([torch.where(row, q, b + 1), torch.where(row, q, b + 2),
                   torch.tensor([2, 2, b + 1, b + 1, b + 2], device=dev)])
    # the pivot and target move one diagonal down, one column left, when
    # k > 0 (the chased bulge)
    dsk = torch.zeros_like(d)
    dsk[-5:-3] = 1
    stored = d <= w + 1
    d = d.clamp(max=w + 1)
    P = 2 * b + 2
    # what a step writes: the stored pairs, then the block
    out = torch.cat([torch.nonzero(stored[:2 * P])[:, 0],
                     torch.arange(2 * P + 2, 2 * P + 5, device=dev)])
    lanes = torch.arange(J, device=dev)
    for t in range(T_pass):
        jhi = min(t // g, J - 1)
        jlo = max(0, -(-((t + 1) * b - (n - 1)) // D))
        if jlo > jhi:
            continue
        j = lanes[jlo:jhi + 1]
        k = t - g * j
        sk = (k > 0).long()[:, None]
        c0 = ((t + 1) * b - j * D - b - 2 + P_LEFT)[:, None]
        rows = d + sk * dsk
        cols = c0 + o - sk * dsk
        x = torch.where(stored, Wp[rows, cols], 0.0).to(acc)
        c, s = givens(x[:, 2 * P], x[:, 2 * P + 1])
        c, s = rnd(c)[:, None], rnd(s)[:, None]
        CS[j, k] = torch.cat([c, s], dim=1).to(dt)
        # the pairs, and the block's rows (a11, a21) and (a21, a22)
        x0 = torch.cat([x[:, :P], x[:, 2 * P + 2:2 * P + 4]], dim=1)
        x1 = torch.cat([x[:, P:2 * P], x[:, 2 * P + 3:2 * P + 5]], dim=1)
        y0 = c * x0 + s * x1
        y1 = -s * x0 + c * x1
        # the block's rows are stored before its columns rotate:
        # (r11, r21) -> (n11, n21), then n22 from (r21, r22)
        b0 = rnd(torch.stack([y0[:, P], y1[:, P]], dim=1))
        b1 = rnd(torch.stack([y0[:, P + 1], y1[:, P + 1]], dim=1))
        n0 = c * b0 + s * b1
        n22 = -s[:, 0] * b0[:, 1] + c[:, 0] * b1[:, 1]
        # in x's layout (the pivot and target columns are not written)
        vals = torch.cat([y0[:, :P], y1[:, :P], x[:, 2 * P:2 * P + 2], n0,
                          n22[:, None]], dim=1)
        Wp[rows[:, out], cols[:, out]] = vals[:, out].to(dt)
    # the annihilated diagonals: zero them
    Wp[b:, :] = 0.0
    return CS


__all__ = ["rot_apply_ref", "chase_pass_ref", "replay_pass_ref",
           "chase_pass_lanes_ref", "acc_dtype"]
