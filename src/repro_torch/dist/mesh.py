"""The device mesh and its collectives, seen from one rank.

The reference's ``jax.make_mesh(shape, ("data", "model"))`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same dimension
names (``make_mesh``). The programming model is SPMD: every rank runs the
same code on replicated inputs and holds its own tiles.

``Tiling`` is a mesh's (rows x 'model') decomposition from one rank's
side, as the reference's ``_row_spec``/``_n_row_shards`` see it: the row
axes are every name except ``"model"``, merged in mesh order, and
``"model"`` must be the last axis when it is present. A matrix of n rows
is split in row blocks of ``ceil(n / R)`` (the last ones shorter, or
empty); its columns over ``'model'`` the same way. JAX's collectives map
as: ``psum`` over an axis -> ``all_reduce`` on that dimension's group; a
tiled ``all_gather`` -> ``all_gather`` of equal pieces (the short ones
padded) concatenated; ``psum_scatter`` -> ``reduce_scatter``. Every
collective carries float32 or float64 (a bfloat16 tensor travels as its
exact float32 copy) and adds one to ``Tiling.counts`` under its kind.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: the reference's mesh axis names
DEFAULT_NAMES = ("data", "model")


def make_mesh(shape: Sequence[int], names: Sequence[str] = DEFAULT_NAMES,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the initialized process group
    (``launcher.run_local`` makes one). ``device_type`` ``None`` is the
    card; ``"cpu"`` runs the mesh on gloo processes."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launcher.run_local builds one)")
    shape, names = tuple(int(d) for d in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _split(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of piece i of n split in ``parts`` pieces of ceil(n/parts)."""
    size = -(-n // parts)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


class Tiling:
    """One rank's view of a mesh: its row-block index ``r`` of ``R``, its
    'model' index ``c`` of ``cm``, the groups of its row (``row_group``,
    the merged row axes at fixed 'model' index), of its 'model' axis
    (``model_group``) and of the whole mesh (``mesh_group``, flattened in
    mesh order), each ``None`` where the axis is absent. ``counts`` holds
    the collectives issued through it, by kind."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        if "model" in names and names[-1] != "model":
            raise ValueError(f"'model' must be the last mesh axis, got "
                             f"{names}")
        grid = mesh.mesh.reshape(-1)
        if not bool(torch.all(grid[1:] > grid[:-1])):
            raise ValueError("the mesh's ranks must ascend in mesh order")
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.cm = mesh.shape[-1] if "model" in names else 1
        self.R = mesh.size() // self.cm
        g = mesh.mesh.reshape(self.R, self.cm)
        pos = (g == dist.get_rank()).nonzero()
        if pos.shape[0] != 1:
            raise ValueError("this rank is not in the mesh")
        self.r, self.c = (int(v) for v in pos[0])
        self._grid = g
        rows = [a for a in names if a != "model"]
        self.row_group = None
        if len(rows) == 1:
            self.row_group = mesh.get_group(rows[0])
        elif len(rows) > 1:
            # the merged row axes: one group per 'model' index
            self.row_group, _ = dist.new_subgroups_by_enumeration(
                [g[:, c].tolist() for c in range(self.cm)])
        self.model_group = (mesh.get_group("model") if "model" in names
                            else None)
        self.mesh_group = (dist.group.WORLD
                           if mesh.size() == dist.get_world_size()
                           else dist.new_group(grid.tolist()))
        self.counts: Counter = Counter()

    # ---- partitions ------------------------------------------------------
    def rows(self, n: int, r: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of row block ``r`` (default this rank's) of n rows."""
        return _split(n, self.R, self.r if r is None else r)

    def cols(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's 'model' slice of n columns."""
        return _split(n, self.cm, self.c)

    def rank_of(self, r: int, c: Optional[int] = None) -> int:
        """Global rank at row block r, 'model' index c (default this
        rank's)."""
        return int(self._grid[r, self.c if c is None else c])

    # ---- collectives -----------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return x.to(torch.float32)
        if x.dtype not in (torch.float32, torch.float64, torch.int32,
                           torch.int64):
            raise TypeError(f"collectives carry float32/float64, got "
                            f"{x.dtype}")
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor, group, kind: str = "all_reduce",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum (or ``op``) of x over ``group``; x itself where the axis is
        absent."""
        if group is None:
            return x
        w = self._wire(x)
        w = w.clone() if w is x else w
        dist.all_reduce(w, op=op, group=group)
        self.counts[kind] += 1
        return w.to(x.dtype)

    def all_gather(self, x: torch.Tensor, group, dim: int = 0,
                   kind: str = "all_gather") -> torch.Tensor:
        """Concatenation along ``dim`` of every member's x (all of one
        shape), in group order."""
        if group is None:
            return x
        w = self._wire(x.movedim(dim, 0))
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, w, group=group)
        self.counts[kind] += 1
        return torch.cat(parts).to(x.dtype).movedim(0, dim)

    def gather_rows(self, x_loc: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) matrix from every row block's rows ``x_loc``: the
        short blocks padded to ceil(n / R) rows, gathered, cut to n."""
        if self.row_group is None:
            return x_loc
        size = -(-n // self.R)
        pad = size - x_loc.shape[0]
        if pad:
            x_loc = torch.cat([x_loc, x_loc.new_zeros((pad,) + tuple(
                x_loc.shape[1:]))])
        return self.all_gather(x_loc, self.row_group)[:n]

    def broadcast(self, x: torch.Tensor, src: int, group,
                  kind: str = "broadcast") -> torch.Tensor:
        """x of global rank ``src``, on every member of ``group``."""
        if group is None:
            return x
        w = self._wire(x)
        dist.broadcast(w, src=src, group=group)
        self.counts[kind] += 1
        return w.to(x.dtype)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """x of the mesh's first rank, on every rank (random starts)."""
        return self.broadcast(x, self.rank_of(0, 0), self.mesh_group)

    def barrier(self) -> None:
        dist.barrier(group=self.mesh_group)
        self.counts["barrier"] += 1


def tiling(mesh) -> Tiling:
    """The ``Tiling`` of ``mesh`` on this rank, made once per mesh and kept
    on it (the merged-row groups it creates are collective)."""
    got = getattr(mesh, "_repro_tiling", None)
    if got is None:
        got = Tiling(mesh)
        mesh._repro_tiling = got
    return got


__all__ = ["DEFAULT_NAMES", "make_mesh", "mesh_device", "Tiling", "tiling"]
