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
the kernels' reduced instances. The cluster chase and the slab replay lay
out their shared memory for fp64, so below fp64 the chase takes the
cooperative kernel (``REDUCED_CHASE``) and the replay the sweep kernel
(``REDUCED_REPLAY``).

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
_SIGS = {
    "chase_pass_cluster_fp64": [_P, _L, _L, _L, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _P],
    "chase_cluster_capacity": [_I, _I],
    "replay_slab_fp64": [_P, _L, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
#: the suffix of each instance's C entry points
_SFX = {torch.float64: "fp64", torch.float32: "fp32", torch.bfloat16: "bf16"}
for _sfx in _SFX.values():
    _SIGS[f"rot_apply_{_sfx}"] = _ROT
    _SIGS[f"chase_pass_coop_{_sfx}"] = _COOP
    _SIGS[f"replay_pass_{_sfx}"] = _SWEEP


#: threads of a ``rot_apply`` block, and the most column chunks of its grid
ROT_THREADS = 256
MAX_GRID_Y = 65535

#: the chase's cluster sizes, tried in order (16 is non-portable), and the
#: largest dynamic shared memory of a CTA on the card
CLUSTER_SIZES = (16, 8, 4, 2, 1)
SMEM_MAX = 232448
#: ``mode`` of the chase entry points: the pass, or a timing variant (the
#: last three for the cluster kernel only)
FULL, BARRIER_ONLY, NO_BARRIER, LOCAL_ONLY, NO_GIVENS, NO_BLOCK_SYNC = range(6)


class ChasePlan(NamedTuple):
    path: str      # "cluster" (band in distributed shared memory) or
    #                "cooperative" (band in global memory, grid barrier)
    csize: int     # CTAs of the cluster (0 on the cooperative path)
    cpc: int       # packed columns a CTA holds
    smem: int      # bytes of dynamic shared memory a CTA


def cluster_share(npad: int, w: int, b: int, csize: int) -> tuple:
    """(columns, bytes) a CTA holds when ``csize`` CTAs share a padded band
    of npad columns and w+2 diagonals at pass b: its columns, and the (c,
    s) of the lanes whose planes lie in them (consecutive lanes sit g b - 1
    columns apart)."""
    cpc = -(-npad // csize)
    lanes = cpc // (chase_stagger(b) * b - 1) + 2
    return cpc, 8 * (cpc * (w + 2) + 2 * lanes)


def chase_plan(npad: int, w: int, b: int, capacity=None) -> ChasePlan:
    """The cluster path when the band fits the distributed shared memory of
    one cluster the card can run (``capacity(csize, smem)``, the clusters
    it holds at once; None counts every fitting size as runnable), else
    the cooperative path. A CTA holds at least w+3 columns, so a lane's
    footprint reaches no further than the previous CTA's."""
    for csize in CLUSTER_SIZES:
        cpc, smem = cluster_share(npad, w, b, csize)
        if smem <= SMEM_MAX and cpc >= w + 3 and (
                capacity is None or capacity(csize, smem) > 0):
            return ChasePlan("cluster", csize, cpc, smem)
    return COOPERATIVE


#: the cooperative kernel's plan
COOPERATIVE = ChasePlan("cooperative", 0, 0, 0)
#: the chase's plan below fp64: the cooperative kernel's instances
REDUCED_CHASE = COOPERATIVE

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
#: the replay's plan below fp64: the sweep kernel's instances
REDUCED_REPLAY = SWEEP


def replay_smem(n: int, stage: int) -> int:
    """Dynamic shared memory of the slab replay (``replay_slab_smem``): the
    table slices, a column of n rows rounded up to 16, the barriers."""
    return REPLAY_SLOTS * stage + 8 * (-(-n // 16) * 16) + 16 * REPLAY_SLOTS


def replay_plan(n: int, ncols: int, aligned: bool = True) -> ReplayPlan:
    """The slab path, one CTA a column (a slab wider than the card runs in
    waves), where a column of n rows fits a CTA's shared memory beside two
    table slices of at least a sweep of 512 lanes each, as large as the
    rest allows; else the sweep path, which also takes a table that is not
    16-byte aligned (``aligned`` False: cp.async.bulk needs it)."""
    stage = (SMEM_MAX - replay_smem(n, 0)) // REPLAY_SLOTS // 16 * 16
    if not aligned or stage < 16 * REPLAY_CONSUMERS:
        return SWEEP
    return ReplayPlan("slab", ncols, stage, replay_smem(n, stage))


@functools.cache
def cluster_capacity(csize: int, smem: int) -> int:
    """Clusters of ``csize`` CTAs with ``smem`` bytes each that the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    got = _lib().chase_cluster_capacity(csize, smem)
    if got < 0:
        raise RuntimeError(f"chase_cluster_capacity failed with cudaError "
                           f"{-got}")
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
    plan = (chase_plan(Wp.shape[1], w, b, cluster_capacity)
            if Wp.dtype == torch.float64 else REDUCED_CHASE)
    CS = chase_launch(Wp, b, w, n, plan, FULL)
    _launches.count(chase_pass, Wp.dtype)
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
    if Wp.dtype != torch.float64 and plan.path != "cooperative":
        raise ValueError("the fp32 and bf16 chase are the cooperative "
                         "kernel's instances")
    if plan.path == "cluster":
        err = _lib().chase_pass_cluster_fp64(
            Wp.data_ptr(), Wp.stride(0), Wp.stride(1), Wp.shape[1],
            CS.data_ptr(), n, b, w, g, T_pass, J, K0, plan.csize, plan.cpc,
            plan.smem, mode, stream)
        _raise_on(err, "chase_pass_cluster_fp64")
        return CS
    bar = torch.zeros((1,), dtype=torch.int32, device=Wp.device)
    fn = f"chase_pass_coop_{_SFX[Wp.dtype]}"
    err = getattr(_lib(), fn)(Wp.data_ptr(), Wp.stride(0), Wp.stride(1),
                              Wp.shape[1], CS.data_ptr(), bar.data_ptr(), n,
                              b, w, g, T_pass, G, J, K0, mode, stream)
    _raise_on(err, fn)
    return CS


_launches.with_reduced(chase_pass)


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
    plan = (replay_plan(n, Xp.shape[1], CS.data_ptr() % 16 == 0)
             if Xp.dtype == torch.float64 else REDUCED_REPLAY)
    replay_launch(Xp, CS, b, n, reverse, plan, REPLAY_FULL)
    _launches.count(replay_pass, Xp.dtype)
    return Xp


def replay_launch(Xp: torch.Tensor, CS: torch.Tensor, b: int, n: int,
                  reverse: bool, plan: ReplayPlan, mode: int) -> None:
    """One launch of the replay kernel of ``plan`` (``SWEEP`` forces that
    path) in ``mode`` (a timing variant of the slab kernel unless
    REPLAY_FULL); raises on a CUDA error. Counts nothing, as
    ``chase_launch``."""
    J, K0 = CS.shape[0] - 1, CS.shape[1] - 1
    stream = current_stream(Xp.device)
    if Xp.dtype != torch.float64 and plan.path != "sweep":
        raise ValueError("the fp32 and bf16 replay are the sweep kernel's "
                         "instances")
    if plan.path == "slab":
        err = _lib().replay_slab_fp64(
            Xp.data_ptr(), Xp.stride(0), Xp.shape[1], CS.data_ptr(), n, b, J,
            K0, int(reverse), plan.stage, mode, stream)
        _raise_on(err, "replay_slab_fp64")
        return
    fn = f"replay_pass_{_SFX[Xp.dtype]}"
    err = getattr(_lib(), fn)(Xp.data_ptr(), Xp.stride(0), Xp.shape[1],
                              CS.data_ptr(), n, b, J, K0, int(reverse),
                              stream)
    _raise_on(err, fn)


_launches.with_reduced(replay_pass)

#: every kernel wrapper of this module, by name
WRAPPERS = {"rot_apply": rot_apply, "chase_pass": chase_pass,
            "replay_pass": replay_pass}


def reset_launches() -> None:
    _launches.reset(WRAPPERS)


def launch_counts() -> dict:
    return _launches.read(WRAPPERS)
