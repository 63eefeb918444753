"""ctypes launch wrappers for ``csrc/rot_apply.cu`` (TT2 chase, TT4 replay).

``rot_apply``, ``chase_pass`` and ``replay_pass`` all replace
``rot_apply_pallas`` (``repro/kernels/rot_apply/kernel.py``): the first
computes its function, the other two fuse the reference's per-step and
per-sweep calls of it into one launch per bandwidth pass. The source note
in the ``.cu`` file says what bounds each and what the design does about
it. Each wrapper checks device, dtype, shapes and strides, allocates with
``torch.empty`` (the rotation table: filled with the identity first; the
cooperative chase's grid-barrier counter: zeroed),
launches on the current stream, raises if ``cudaGetLastError`` is not 0,
and adds one to the count of the instance it launched
(``kernels/_launches.py``).

Each wrapper also takes float32 and bfloat16 storage (computed in fp32),
the kernels' reduced instances; every kernel below has all three. The
plans size shared memory by the entry: the cluster chase holds its band as
fp32 values at both reduced dtypes (``CHASE_ENTRY``), the slab replay its
column in the storage dtype. The reduced launches also count by path
(``path_counts``: ``chase_pass_fp32_cluster``, ``replay_pass_bf16_slab``,
...).

``chase_pass`` and ``replay_pass`` each have two hand-written paths, chosen
by size by ``chase_plan`` and ``replay_plan`` (pure Python, reached by the
CPU tests); all four are bitwise equal to the plain versions. The chase:
the band in the distributed shared memory of one thread-block cluster
where it fits, else the cooperative kernel with the band in global memory
and a grid barrier a step. The replay: the slab's columns in shared
memory, one a CTA, b-1 sweeps a barrier, the rotation table staged in
slices through shared memory, where a column fits; else the sweep kernel,
the slab in global memory and a barrier a sweep.

``rot_apply`` is a few microseconds of device work at the chase's shapes,
so its host cost is the call's cost: the library handle is cached, the
stream is read as a raw handle (``device.current_stream``), and
``launch_shape`` (pure Python, reached by the CPU tests) is cached per
shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import current_stream
from repro_torch.kernels import _launches
from repro_torch.kernels._build import load

from .schedule import chase_stagger, identity_table, pass_schedule

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ROT = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_COOP = [_P, _L, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SWEEP = [_P, _L, _I, _P, _I, _I, _I, _I, _I, _P]
_CLUSTER = [_P, _L, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _P]
_SLAB = [_P, _L, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_SIGS = {}
#: the suffix of each instance's C entry points
_SFX = {torch.float64: "fp64", torch.float32: "fp32", torch.bfloat16: "bf16"}
for _sfx in _SFX.values():
    _SIGS[f"rot_apply_{_sfx}"] = _ROT
    _SIGS[f"chase_pass_coop_{_sfx}"] = _COOP
    _SIGS[f"chase_pass_cluster_{_sfx}"] = _CLUSTER
    _SIGS[f"chase_cluster_capacity_{_sfx}"] = [_I, _I]
    _SIGS[f"replay_pass_{_sfx}"] = _SWEEP
    _SIGS[f"replay_slab_{_sfx}"] = _SLAB


#: threads of a ``rot_apply`` block, and the most column chunks of its grid
ROT_THREADS = 256
MAX_GRID_Y = 65535

#: the chase's cluster sizes, tried in order at every dtype (16 is
#: non-portable; at MD it measured faster than 8 in fp64, fp32 and bf16:
#: PERF.md), and the largest dynamic shared memory of a CTA on the card
CLUSTER_SIZES = (16, 8, 4, 2, 1)
SMEM_MAX = 232448
#: bytes of a band entry in the cluster chase's shared memory: the compute
#: type's (csrc/rot_apply.cu holds bf16 entries as rounded fp32 values)
CHASE_ENTRY = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 4}
#: ``mode`` of the chase entry points: the pass, or a timing variant (the
#: last three for the cluster kernel only)
FULL, BARRIER_ONLY, NO_BARRIER, LOCAL_ONLY, NO_GIVENS, NO_BLOCK_SYNC = range(6)


class ChasePlan(NamedTuple):
    path: str      # "cluster" (band in distributed shared memory) or
    #                "cooperative" (band in global memory, grid barrier)
    csize: int     # CTAs of the cluster (0 on the cooperative path)
    cpc: int       # packed columns a CTA holds
    smem: int      # bytes of dynamic shared memory a CTA


def cluster_share(npad: int, w: int, b: int, csize: int,
                  esize: int = 8) -> tuple:
    """(columns, bytes) a CTA holds when ``csize`` CTAs share a padded band
    of npad columns and w+2 diagonals at pass b: its columns, and the (c,
    s) of the lanes whose planes lie in them (consecutive lanes sit g b - 1
    columns apart), at ``esize`` bytes an entry (``CHASE_ENTRY``)."""
    cpc = -(-npad // csize)
    lanes = cpc // (chase_stagger(b) * b - 1) + 2
    return cpc, esize * (cpc * (w + 2) + 2 * lanes)


def chase_plan(npad: int, w: int, b: int, capacity=None,
               dtype: torch.dtype = torch.float64) -> ChasePlan:
    """The cluster path when the band of ``dtype`` fits the distributed
    shared memory of one cluster the card can run (``capacity(csize,
    smem)``, the clusters of that instance it holds at once; None counts
    every fitting size as runnable), trying ``CLUSTER_SIZES`` in order,
    else the cooperative path. A CTA holds at least w+3 columns, so
    a lane's footprint reaches no further than the previous CTA's."""
    for csize in CLUSTER_SIZES:
        cpc, smem = cluster_share(npad, w, b, csize, CHASE_ENTRY[dtype])
        if smem <= SMEM_MAX and cpc >= w + 3 and (
                capacity is None or capacity(csize, smem) > 0):
            return ChasePlan("cluster", csize, cpc, smem)
    return COOPERATIVE


#: the cooperative kernel's plan
COOPERATIVE = ChasePlan("cooperative", 0, 0, 0)

#: the slab replay's consumer threads (a table slice holds a multiple of
#: them in lanes) and its table slices in flight (the kernel's kSlabSlots)
REPLAY_CONSUMERS = 512
REPLAY_SLOTS = 2
#: ``mode`` of ``replay_launch``: the pass, or a timing variant of the slab
#: kernel (no table, a fixed rotation; no barrier between chunks; lane 0
#: alone)
REPLAY_FULL, NO_TABLE, REPLAY_NO_BARRIER, ONE_LANE = range(4)


class ReplayPlan(NamedTuple):
    path: str      # "slab" (columns in shared memory, b-1 sweeps a
    #                barrier) or "sweep" (slab in global memory)
    ctas: int      # CTAs of the launch, one a column
    stage: int     # bytes of one table slice
    smem: int      # bytes of dynamic shared memory a CTA


#: the sweep kernel's plan
SWEEP = ReplayPlan("sweep", 0, 0, 0)


def slab_entries(n: int, b: int, esize: int) -> int:
    """Entries of the slab replay's column (``slab_entries``): n rounded up
    to 16 at 8 bytes an entry; below, b ceil(n / b) (the column stored b
    rows to a stride) rounded up to a multiple of 16 bytes."""
    if esize == 8:
        return -(-n // 16) * 16
    per = 16 // esize
    return -(-(b * -(-n // b)) // per) * per


def slice_pad(esize: int) -> int:
    """Bytes a table slice row takes beyond its pairs: 16 below fp64, where
    a row's copy starts on the 16-byte boundary at or below its first
    pair (``slab_geom``)."""
    return 0 if esize == 8 else 16


def replay_smem(n: int, stage: int, dtype: torch.dtype = torch.float64,
                b: int | None = None) -> int:
    """Dynamic shared memory of the slab replay (``replay_slab_smem``): the
    table slices, a column of n rows of ``dtype`` (whose layout below fp64
    depends on the pass's b), the barriers."""
    esize = torch.empty((), dtype=dtype).element_size()
    if esize != 8 and b is None:
        raise ValueError("the reduced slab column's size depends on b")
    return (REPLAY_SLOTS * stage + esize * slab_entries(n, b, esize)
            + 16 * REPLAY_SLOTS)


def replay_plan(n: int, ncols: int, aligned: bool = True,
                dtype: torch.dtype = torch.float64,
                b: int | None = None) -> ReplayPlan:
    """The slab path, one CTA a column (a slab wider than the card runs in
    waves), where a column of n rows of ``dtype`` (at pass b below fp64)
    fits a CTA's shared memory beside two table slices of at least a sweep
    of 512 lanes each, as large as the rest allows; else the sweep path,
    which also takes a table whose start is not 16-byte aligned
    (``aligned`` False: cp.async.bulk needs it). The table's rows may start
    anywhere: the kernel stages each from the boundary at or below it."""
    esize = torch.empty((), dtype=dtype).element_size()
    least = 2 * esize * REPLAY_CONSUMERS + slice_pad(esize)
    stage = (SMEM_MAX - replay_smem(n, 0, dtype, b)) // REPLAY_SLOTS \
        // 16 * 16
    if not aligned or stage < least:
        return SWEEP
    return ReplayPlan("slab", ncols, stage, replay_smem(n, stage, dtype, b))


class SlabGeom(NamedTuple):
    m: int         # sweeps a chunk (b - 1)
    L: int         # lanes a slice
    h: int         # sweeps a slice
    nchunks: int
    P: int         # bytes of a slice row (one sweep's L pairs and the pad)


def slab_geom(n: int, b: int, J: int, stage: int, esize: int) -> SlabGeom:
    """The slab replay's table staging at entries of ``esize`` bytes, as
    ``slab_geom`` in the kernel computes it."""
    pb, pad = 2 * esize, slice_pad(esize)
    m = b - 1
    L = min((stage - pad) // pb // REPLAY_CONSUMERS * REPLAY_CONSUMERS,
            (n - 1) // b)
    P = -(-L * pb // 16) * 16 + pad
    hmax = max(1, min(m, stage // P))
    h = -(-m // -(-m // hmax))
    return SlabGeom(m, L, h, -(-J // m), P)


def slab_slices(n: int, b: int, K0: int, stage: int, esize: int,
                reverse: bool):
    """The slices of one slab replay pass in the kernel's order, as its
    producer copies them and its consumers read them: per slice (j0, i0,
    hh, k0, Lc, copies, reads), the sweeps j0 + i0 .. j0 + i0 + hh - 1 by
    the lanes k0 .. k0 + Lc - 1; ``copies`` the producer's cp.async.bulk
    per sweep, (slice byte, table byte, bytes); ``reads`` the byte of the
    slice where a consumer reads sweep j0 + i0 + u's pair k0 (pair k0 + kk
    at that + kk * 2 esize). For the CPU tests: the twin of the kernel's
    index arithmetic."""
    J = n - b
    g = slab_geom(n, b, J, stage, esize)
    pb = 2 * esize
    step = (K0 + 1) * pb
    for ci in range(g.nchunks):
        j0 = (g.nchunks - 1 - ci if reverse else ci) * g.m
        mc = min(g.m, J - j0)
        Kc = (n - 1 - j0) // b
        nsb = -(-mc // g.h)
        for k0 in range(0, Kc, g.L):
            Lc = min(g.L, Kc - k0)
            for si in range(nsb):
                i0 = (nsb - 1 - si if reverse else si) * g.h
                hh = min(g.h, mc - i0)
                off0 = ((j0 + i0) * (K0 + 1) + k0) * pb
                copies, reads = [], []
                for i in range(hh):       # the producer
                    off = off0 + i * step
                    pre = off % 16
                    copies.append((i * g.P, off - pre,
                                   -(-(pre + Lc * pb) // 16) * 16))
                for u in range(hh):       # the consumers
                    reads.append(u * g.P + (off0 + u * step) % 16)
                yield j0, i0, hh, k0, Lc, copies, reads


@functools.cache
def cluster_capacity(csize: int, smem: int,
                     dtype: torch.dtype = torch.float64) -> int:
    """Clusters of ``csize`` CTAs of the ``dtype`` instance with ``smem``
    bytes each that the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = f"chase_cluster_capacity_{_SFX[dtype]}"
    got = getattr(_lib(), fn)(csize, smem)
    if got < 0:
        raise RuntimeError(f"{fn} failed with cudaError {-got}")
    return got


@functools.cache
def launch_shape(G: int, L: int) -> tuple:
    """(tx, ty, gx, gy) of ``rot_apply`` on (G, 2, L): tx threads a pair,
    the next power of two >= L up to ``ROT_THREADS``; ty = ROT_THREADS /
    tx pairs a block; gx blocks over the pairs, gy over column chunks of
    tx (at most ``MAX_GRID_Y``; the kernel strides over the rest). The
    kernel's offsets are 32-bit, so G L must stay below 2^31."""
    if G * L >= 2 ** 31:
        raise ValueError(f"rot_apply takes G L < 2^31 (32-bit offsets), "
                         f"got G={G}, L={L}")
    tx = min(ROT_THREADS, 1 << max(L - 1, 0).bit_length())
    ty = ROT_THREADS // tx
    return tx, ty, -(-G // ty), min(-(-L // tx), MAX_GRID_Y)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("rot_apply")
    for fn, argtypes in _SIGS.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.replay_slab_smem.argtypes = [_I, _I, _I, _I]
    lib.replay_slab_smem.restype = ctypes.c_int64
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple | None = None,
           dtype=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _SFX or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} must be "
                         f"{dtype or tuple(_SFX)}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def _row_major(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must be 2-D row-major with unit column "
                         f"stride, got shape {tuple(t.shape)} and strides "
                         f"{t.stride()}")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with cudaError {err}")


def rot_apply(pairs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """(G, 2, L) row pairs rotated by (G, 2) (c, s), in one launch."""
    _check("pairs", pairs)
    if pairs.dim() != 3 or pairs.shape[1] != 2:
        raise ValueError(f"pairs must be (G, 2, L), got {tuple(pairs.shape)}")
    G, _, L = pairs.shape
    _check("cs", cs, (G, 2), pairs.dtype)
    pairs, cs = pairs.contiguous(), cs.contiguous()
    out = torch.empty_like(pairs)
    if out.numel() == 0:
        return out
    tx, _, gx, gy = launch_shape(G, L)
    fn = f"rot_apply_{_SFX[pairs.dtype]}"
    err = getattr(_lib(), fn)(pairs.data_ptr(), cs.data_ptr(),
                              out.data_ptr(), G, L, tx, gx, gy,
                              current_stream(pairs.device))
    _launches.count(rot_apply, pairs.dtype)
    _raise_on(err, fn)
    return out


_launches.with_reduced(rot_apply)


def chase_pass(Wp: torch.Tensor, b: int, w: int, n: int) -> torch.Tensor:
    """One bandwidth-b pass over the padded band ``Wp`` (w+2, npad) in
    place, in one launch of the path ``chase_plan`` picks; returns the
    (J+1, K0+1, 2) rotation table. Wp may have any positive strides: the
    chase keeps it column-major."""
    _check("Wp", Wp)
    if Wp.dim() != 2 or min(Wp.stride()) < 1:
        raise ValueError(f"Wp must be 2-D with positive strides, got shape "
                         f"{tuple(Wp.shape)} and strides {Wp.stride()}")
    if Wp.shape[0] != w + 2 or Wp.shape[1] < n + 2 or not 2 <= b <= w \
            or n - b <= 0:
        raise ValueError(f"chase_pass needs Wp (w+2, >= n+2) and "
                         f"2 <= b <= w < n; got Wp {tuple(Wp.shape)}, "
                         f"b={b}, w={w}, n={n}")
    dt = Wp.dtype
    plan = chase_plan(Wp.shape[1], w, b,
                      lambda csize, smem: cluster_capacity(csize, smem, dt),
                      dt)
    CS = chase_launch(Wp, b, w, n, plan, FULL)
    _launches.count(chase_pass, dt)
    if dt != torch.float64:
        _launches.count_path(chase_pass, dt, plan.path)
    return CS


def chase_launch(Wp: torch.Tensor, b: int, w: int, n: int, plan: ChasePlan,
                 mode: int) -> torch.Tensor:
    """One launch of the chase kernel of ``plan`` (``COOPERATIVE`` forces
    that path) in ``mode`` (a timing variant unless FULL); raises on a
    CUDA error. Counts nothing: ``chase_pass`` counts the main path's
    launches, and comparisons and timings call this directly."""
    g, T_pass, G, J, K0 = pass_schedule(n, b, chase_stagger(b))
    CS = identity_table(J, K0, Wp)
    stream = current_stream(Wp.device)
    if plan.path == "cluster":
        fn = f"chase_pass_cluster_{_SFX[Wp.dtype]}"
        err = getattr(_lib(), fn)(
            Wp.data_ptr(), Wp.stride(0), Wp.stride(1), Wp.shape[1],
            CS.data_ptr(), n, b, w, g, T_pass, J, K0, plan.csize, plan.cpc,
            plan.smem, mode, stream)
        _raise_on(err, fn)
        return CS
    bar = torch.zeros((1,), dtype=torch.int32, device=Wp.device)
    fn = f"chase_pass_coop_{_SFX[Wp.dtype]}"
    err = getattr(_lib(), fn)(Wp.data_ptr(), Wp.stride(0), Wp.stride(1),
                              Wp.shape[1], CS.data_ptr(), bar.data_ptr(), n,
                              b, w, g, T_pass, G, J, K0, mode, stream)
    _raise_on(err, fn)
    return CS


_launches.with_reduced(chase_pass)
_launches.with_paths(chase_pass, ("cluster", "cooperative"))


def replay_pass(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                reverse: bool) -> torch.Tensor:
    """One pass of the table ``CS`` applied in place to the first n rows
    of ``Xp`` (rows past n are left alone), in one launch of the path
    ``replay_plan`` picks."""
    _check("Xp", Xp)
    _row_major("Xp", Xp)
    _check("CS", CS, dtype=Xp.dtype)
    if CS.dim() != 3 or CS.shape[2] != 2 or not CS.is_contiguous():
        raise ValueError(f"CS must be a contiguous (J+1, K0+1, 2) table, "
                         f"got {tuple(CS.shape)}")
    J, K0 = CS.shape[0] - 1, CS.shape[1] - 1
    if Xp.shape[0] < n or (J, K0) != pass_schedule(n, b)[3:]:
        raise ValueError(f"the table {tuple(CS.shape)} and rows "
                         f"{Xp.shape[0]} do not fit n={n}, b={b}")
    dt = Xp.dtype
    plan = replay_plan(n, Xp.shape[1], CS.data_ptr() % 16 == 0, dt, b)
    replay_launch(Xp, CS, b, n, reverse, plan, REPLAY_FULL)
    _launches.count(replay_pass, dt)
    if dt != torch.float64:
        _launches.count_path(replay_pass, dt, plan.path)
    return Xp


def replay_launch(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                  reverse: bool, plan: ReplayPlan, mode: int) -> None:
    """One launch of the replay kernel of ``plan`` (``SWEEP`` forces that
    path) in ``mode`` (a timing variant of the slab kernel unless
    REPLAY_FULL); raises on a CUDA error. Counts nothing, as
    ``chase_launch``."""
    J, K0 = CS.shape[0] - 1, CS.shape[1] - 1
    stream = current_stream(Xp.device)
    if plan.path == "slab":
        fn = f"replay_slab_{_SFX[Xp.dtype]}"
        err = getattr(_lib(), fn)(
            Xp.data_ptr(), Xp.stride(0), Xp.shape[1], CS.data_ptr(), n, b, J,
            K0, int(reverse), plan.stage, mode, stream)
        _raise_on(err, fn)
        return
    fn = f"replay_pass_{_SFX[Xp.dtype]}"
    err = getattr(_lib(), fn)(Xp.data_ptr(), Xp.stride(0), Xp.shape[1],
                              CS.data_ptr(), n, b, J, K0, int(reverse),
                              stream)
    _raise_on(err, fn)


_launches.with_reduced(replay_pass)
_launches.with_paths(replay_pass, ("slab", "sweep"))

#: every kernel wrapper of this module, by name
WRAPPERS = {"rot_apply": rot_apply, "chase_pass": chase_pass,
            "replay_pass": replay_pass}


def reset_launches() -> None:
    _launches.reset(WRAPPERS)


def launch_counts() -> dict:
    return _launches.read(WRAPPERS)


def path_counts() -> dict:
    return _launches.read_paths(WRAPPERS)
