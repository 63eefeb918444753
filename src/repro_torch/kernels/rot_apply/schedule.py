"""The static schedule of a TT2 bandwidth pass, which the plain versions
and the CUDA kernels of this package decode, and the padded band's
layout."""
from __future__ import annotations

import torch

#: left column margin of the padded chase storage
P_LEFT = 2


def padded_band(Wb: torch.Tensor, w: int) -> torch.Tensor:
    """The chase's padded storage of the packed band Wb (w+1, n): a
    (w+2, P_LEFT + n + 3w + 8) view of column-major memory (the chase
    kernel reads a column's diagonals together), with one spare diagonal
    for the bulge, zero margins on both column edges, and at the right an
    all-zero dump window for the plain version's idle lanes."""
    n = Wb.shape[1]
    Wp = Wb.new_zeros((P_LEFT + n + 3 * w + 8, w + 2)).mT
    Wp[: w + 1, P_LEFT: P_LEFT + n] = Wb
    return Wp


def pass_schedule(n: int, b: int, g: int | None = None):
    """Static schedule of the bandwidth-b pass: (stagger, steps, lanes, J, K0).

    Column j's sweep annihilates W[j+b, j] and chases the bulge down in
    K_j steps of b; it starts at time step g*j. The reference's stagger
    (the default) is the smallest g with g*b - 1 >= 2b + 4, so the dense
    (2b+4)-wide windows of all sweeps in flight at one step are disjoint.
    """
    J = n - b                      # columns j = 0..J-1 annihilate W[j+b, j]
    if g is None:
        g = 2 + -(-5 // b)         # smallest g with g*b - 1 >= 2b + 4
    K0 = (n - 1 - b) // b + 1      # chase steps of the longest (first) sweep
    T_pass = g * (J - 1) + 1       # last column starts at g(J-1), runs 1 step
    G = K0 // g + 1                # max simultaneously active sweeps
    return g, T_pass, G, J, K0


def chase_stagger(b: int) -> int:
    """The CUDA chase's stagger: the smallest g with g*b - 1 >= b + 3.

    A lane of the in-place chase reads and writes only the packed columns
    r-b-2 .. r of its plane (r-1, r) — the rows r-1, r to the left of the
    2 x 2 block and the columns r-1, r below it — not the reference's
    2b+4 window columns. Lanes one sweep apart sit g*b - 1 columns apart,
    so at this stagger their footprints are disjoint within a step; and a
    sweep's later steps only move further from the sweep behind it, so
    every entry sees the sweeps in their sequential order. The result is
    the sequential rotation sequence, bit for bit, in about 2/3 of the
    reference's steps.
    """
    return -(-(b + 4) // b)


def cta_lanes(t: int, c0: int, c1: int, b: int, g: int, J: int) -> range:
    """The columns j of the lanes that a chase CTA holding packed columns
    [c0, c1) takes at step t (``chase_cluster_kernel``'s jlo..jhi): those
    with k = t - g j >= 0 whose plane column r + P_LEFT, r = (t+1) b -
    j (g b - 1), it holds. A lane whose sweep has ended (k >= K_j, that
    is r > n-1) is in the range too; the kernel skips it."""
    D = g * b - 1
    A = (t + 1) * b + P_LEFT
    jhi = min((A - c0) // D, t // g, J - 1)
    jlo = max((A - c1) // D + 1, 0)
    return range(jlo, jhi + 1)


def identity_table(J: int, K0: int, like: torch.Tensor) -> torch.Tensor:
    """The (J+1, K0+1, 2) rotation table with every slot at (1, 0)."""
    CS = like.new_zeros((J + 1, K0 + 1, 2))
    CS[..., 0] = 1.0
    return CS


def chunk_lanes(n: int, b: int, j0: int, mc: int):
    """The lanes of the replay chunk of sweeps [j0, j0 + mc) (mc <= b-1),
    as ``replay_slab_kernel`` takes them: (k, w, cnt) per lane k < K_{j0},
    whose rotation at chunk-local sweep i < cnt acts on rows w + i, w + i + 1
    (w = j0 + (k+1) b - 1), so that lane k touches only its b-row window
    [w, w + b), disjoint from every other lane's."""
    return [(k, j0 + (k + 1) * b - 1, min(mc, n - j0 - (k + 1) * b))
            for k in range((n - 1 - j0) // b)]


def replay_chunked(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                   reverse: bool, lane_order=None) -> torch.Tensor:
    """Plain emulation of ``replay_slab_kernel``'s order, IN PLACE: chunks
    of b-1 sweeps (the last may be shorter; in reverse the chunks run
    backward), and in each chunk every lane's rotations in sweep order
    (backward with (c, -s) in reverse), one lane after another, carrying
    one row as the kernel's thread does. ``lane_order(lanes)`` may permute
    a chunk's lanes (the kernel runs them in no fixed order). The
    arithmetic is ``rotate``'s in ``ref.acc_dtype``, both rows of each
    rotation rounded to the storage dtype (the stored one and the carried
    one, as the sweep-by-sweep replay stores and reloads both), so the
    result is the sequential replay's bits. For tests: the main path never
    calls it."""
    from .ref import acc_dtype

    J = CS.shape[0] - 1
    m = b - 1
    dt = Xp.dtype
    acc = acc_dtype(dt)
    nchunks = -(-J // m)
    for ci in range(nchunks):
        j0 = (nchunks - 1 - ci if reverse else ci) * m
        lanes = chunk_lanes(n, b, j0, min(m, J - j0))
        for k, w, cnt in (lane_order(lanes) if lane_order else lanes):
            if not reverse:
                carry = Xp[w].to(acc, copy=True)
                for i in range(cnt):
                    c, s = CS[j0 + i, k].to(acc)
                    x1 = Xp[w + i + 1].to(acc)
                    Xp[w + i] = c * carry + s * x1
                    carry = (-s * carry + c * x1).to(dt).to(acc)
                Xp[w + cnt] = carry
            else:
                carry = Xp[w + cnt].to(acc, copy=True)
                for i in range(cnt - 1, -1, -1):
                    c, s = CS[j0 + i, k].to(acc)
                    s = s * -1.0
                    x0 = Xp[w + i].to(acc)
                    Xp[w + i + 1] = -s * x0 + c * carry
                    carry = (c * x0 + s * carry).to(dt).to(acc)
                Xp[w] = carry
    return Xp
