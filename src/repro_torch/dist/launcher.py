"""A world of local ranks around one SPMD function.

``run_local(fn, mesh_shape, device_type, *args)`` starts one process per
rank of the mesh (``spawn``), each of which joins a process group through
a ``FileStore`` in a fresh temporary directory (no TCP port, so worlds can
run side by side), builds the mesh with ``mesh.make_mesh`` and calls
``fn(mesh, *args)``; rank 0's result comes back. One rank runs in this
process, without a spawn. The backend is gloo on the CPU and NCCL on the
cards, one card a rank: a world larger than ``torch.cuda.device_count()``
raises. Every rank destroys its process group on the way out.

``fn`` and its arguments go to the ranks by pickle, so ``fn`` is a
module-level function. A rank that raises sends its exception back; the
parent re-raises rank 0's (or the lowest failing rank's), with the rank's
traceback as a note, and ends the ranks still waiting in a collective.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .mesh import DEFAULT_NAMES, make_mesh

#: seconds a collective may wait for a peer before the group gives up
TIMEOUT_S = 300
#: seconds the other ranks get to finish after one rank failed
GRACE_S = 10.0


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _run_rank(rank: int, world: int, tmp: str, fn: Callable,
              mesh_shape: Sequence[int], device_type: str,
              names: Sequence[str], args: tuple) -> Any:
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this "
                           "process")
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    # NCCL binds the group to this rank's card
    dist.init_process_group(
        _backend(device_type), store=store, rank=rank, world_size=world,
        timeout=timedelta(seconds=TIMEOUT_S),
        device_id=(torch.device("cuda", rank) if device_type == "cuda"
                   else None))
    try:
        mesh = make_mesh(mesh_shape, names, device_type)
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _child(rank: int, world: int, tmp: str, fn: Callable,
           mesh_shape: Sequence[int], device_type: str,
           names: Sequence[str], args: tuple) -> None:
    """A spawned rank: rank 0 writes its result, a failing rank its
    exception (or, if that cannot be pickled, the traceback as a
    ``RuntimeError``). The process then ends with ``os._exit`` (0 or 1):
    the interpreter's teardown, which has nothing left to do, can abort
    in the collective library's threads."""
    code = 1
    try:
        out = _run_rank(rank, world, tmp, fn, mesh_shape, device_type,
                        names, args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                f.write(pickle.dumps(out))
        code = 0
    except BaseException as err:  # noqa: BLE001 — reported to the parent
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((err, tb))
        except Exception:  # noqa: BLE001 — an unpicklable exception
            payload = pickle.dumps((RuntimeError(tb), tb))
        with open(os.path.join(tmp, f"error_{rank}.pkl"), "wb") as f:
            f.write(payload)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _wait(procs: list) -> None:
    """Join every rank; once one has failed, give the rest ``GRACE_S`` and
    end those still running."""
    deadline = None
    while any(p.exitcode is None for p in procs):
        wait([p.sentinel for p in procs if p.exitcode is None], timeout=0.5)
        if deadline is None and any(p.exitcode not in (None, 0)
                                    for p in procs):
            deadline = time.monotonic() + GRACE_S
        if deadline is not None and time.monotonic() > deadline:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join()


def run_local(fn: Callable, mesh_shape: Sequence[int], device_type: str,
              *args, names: Sequence[str] = DEFAULT_NAMES) -> Any:
    """``fn(mesh, *args)`` on every rank of a local world of
    ``prod(mesh_shape)`` ranks; returns rank 0's result."""
    world = math.prod(int(d) for d in mesh_shape)
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a {tuple(mesh_shape)} mesh needs {world} cards, "
                         f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        if world == 1:
            return _run_rank(0, 1, tmp, fn, mesh_shape, device_type, names,
                             args)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child, args=(
            rank, world, tmp, fn, tuple(mesh_shape), device_type,
            tuple(names), args)) for rank in range(world)]
        for p in procs:
            p.start()
        try:
            _wait(procs)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
                    p.join()
        for rank in range(world):
            path = os.path.join(tmp, f"error_{rank}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    err, tb = pickle.loads(f.read())
                err.add_note(f"rank {rank} of {world}:\n{tb}")
                raise err
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited without a result: {bad}")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.loads(f.read())


__all__ = ["run_local", "TIMEOUT_S"]
