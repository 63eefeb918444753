"""Run profiles of the port's entry points (``repro.analysis.static_audit
.profile`` in torch).

The reference lowers each solver program, never runs it, and walks its
jaxpr (a ``scan`` of static length multiplies what is inside it) and its
StableHLO text. The port has no program to lower: its entry points are
host code that queues kernels. So the port's audit RUNS each entry once,
at the small ``AuditSpec``, on the CPU through the plain versions and on
the card through the kernels, and counts what happened with:

* a ``TorchDispatchMode`` over every aten op: the dtypes of its outputs
  (and of the entry's tensor inputs), every float conversion edge
  (``aten._to_copy`` and ``aten.copy_`` from one floating dtype to
  another: ``float64->float32``, ``float64->bfloat16``, ...) with its
  count, the host reads behind ``.item()``/``bool()``/``float()``
  (``aten._local_scalar_dense``), and the collectives (``c10d.allreduce_``,
  ``c10d.allgather_``, ...) in the order they ran;
* a ``TorchFunctionMode`` for what the dispatcher does not show alike on
  both devices: ``torch.isfinite`` (a composite op, decomposed before any
  dispatch mode sees it) and the ``.tolist()``/``.numpy()`` host reads (on
  a CPU tensor they run no aten op);
* the kernel-call recording of ``kernels/_launches.py``: the hand-written
  kernels are called through ``ctypes`` pointers and are invisible to both
  modes, so each family's ops dispatch notes its launches, on the CPU
  branch as on the CUDA one. The profile also takes the launch counters'
  deltas, which on the card equal the recorded calls exactly when no call
  took the plain version (on the CPU they stay 0);
* the ``DispatchCounter``s of ``core.sbr``, ``core.lanczos`` and
  ``dist.eigensolver`` (stage entries);
* on a mesh, ``Tiling.counts``: the collectives by the kind their caller
  gave them (``matvec``, ``tt3``, ``verdict``, ...), whose total must
  equal the collectives the dispatch mode saw.

Kernel calls, stage entries, collectives and isfinite sites count the same
on both devices (the plain versions are called where the kernels are).
The profile's device is where the run's tensors were: the card if any
input tensor or any op's output lay on it. A profile of CUDA tensors thus
always gets the check of its recorded kernel calls against the launch
counters' deltas; no caller can label it otherwise.
The op-level counts (ops, conversions, host reads) follow the path that
ran: a plain version runs more ops than its kernel, and some read the
host (``ref.bisect_sturm_ref``'s ``tolist``); the dtype policy must hold
on both.

Steps: a count "per panel" or "per block step" splits the run at each
call of the kernel instance ``step_on`` names (a panel's ``house_panel``,
a round's ``invit``) or at each ``mark_step()`` (the audit's wrapper
around a KE block-step product), and keeps the collectives of each step.

No counterpart: the jaxpr walk's scan multiplication and unroll (a run
counts each trip as it happens), dynamic-while reporting (the port's loops
are Python loops), the ``pallas_call`` grid specs and the HLO text counts
(there is no lowered program).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels as _kernels
from repro_torch.kernels import _launches

#: ``c10d`` op name -> collective kind (the reference's HLO-level names)
COLLECTIVE_KINDS: Dict[str, str] = {
    "allreduce_": "all_reduce",
    "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather",
    "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "broadcast_": "broadcast",
    "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all",
    "barrier": "barrier",
}

_DOWNCAST_TARGETS = ("float32", "bfloat16", "float16")
#: aten ops that convert a tensor's dtype (the edge is input -> output)
_CONVERTS = ("_to_copy", "copy_")
#: Tensor methods that read a value back to the host without an aten op
#: on a CPU tensor
_HOST_METHODS = ("tolist", "numpy")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class ProgramProfile:
    """What one run of an entry's program did."""
    name: str
    device: str = "cpu"
    #: kernel launches the ops dispatches noted, by instance
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the launch counters' deltas (0 on the CPU: no kernel runs there)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: stage entries by counter (``sbr``, ``lanczos``, ``dist``)
    stage_entries: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: collectives by kind (``all_reduce``, ``all_gather``, ...)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: collectives by the kind label of ``Tiling.counts`` (mesh only)
    collective_labels: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: collectives of each step (empty when the entry defines no steps)
    step_collectives: List[int] = dataclasses.field(default_factory=list)
    converts: Dict[str, int] = dataclasses.field(default_factory=dict)
    input_dtypes: List[str] = dataclasses.field(default_factory=list)
    output_dtypes: List[str] = dataclasses.field(default_factory=list)
    isfinite_sites: int = 0
    host_reads: int = 0
    ops: int = 0
    seconds: float = 0.0
    #: what the program's ``summarize`` kept of its result
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---- derived views ---------------------------------------------------
    def total_collectives(self) -> int:
        return sum(self.collectives.values())

    def max_collectives_per_step(self) -> int:
        """The most collectives one step ran (the whole run where the
        entry defines no steps): the "per panel" / "per block step"
        number of the contracts."""
        if self.step_collectives:
            return max(self.step_collectives)
        return self.total_collectives()

    def f64_downcasts(self) -> Dict[str, int]:
        """Conversions demoting float64: precision leaks unless declared."""
        return {k: v for k, v in self.converts.items()
                if k.startswith("float64->")
                and k.split("->")[1] in _DOWNCAST_TARGETS}

    def dtypes_seen(self) -> List[str]:
        seen = set(self.input_dtypes) | set(self.output_dtypes)
        for k in self.converts:
            seen.update(k.split("->"))
        return sorted(seen)

    def as_json_dict(self) -> dict:
        return {
            "name": self.name, "device": self.device,
            "kernel_calls": dict(self.kernel_calls),
            "launches": dict(self.launches),
            "stage_entries": dict(self.stage_entries),
            "collective_counts": dict(self.collectives),
            "collective_labels": dict(self.collective_labels),
            "total_collectives": self.total_collectives(),
            "max_collectives_per_step": self.max_collectives_per_step(),
            "step_collectives": list(self.step_collectives),
            "converts": dict(self.converts),
            "f64_downcasts": self.f64_downcasts(),
            "dtypes_seen": self.dtypes_seen(),
            "isfinite_sites": self.isfinite_sites,
            "host_reads": self.host_reads, "ops": self.ops,
            "seconds": self.seconds, "extra": self.extra,
        }


class _Timeline:
    """The events of one run that steps are cut from: collectives, and the
    step marks (a call of ``step_on``, or ``mark_step()``)."""

    def __init__(self, step_on: Optional[str]):
        self.step_on = step_on
        self.steps: List[int] = []
        self.open = 0
        self.marked = False

    def mark(self) -> None:
        if self.marked or self.open:
            self.steps.append(self.open)
        self.marked, self.open = True, 0

    def collective(self) -> None:
        self.open += 1

    def kernel(self, instance: str, k: int) -> None:
        if instance == self.step_on:
            for _ in range(k):
                self.mark()

    def close(self) -> List[int]:
        """Every step's collectives; the collectives before the first mark
        are a step of their own."""
        if not self.marked:
            return []
        return self.steps + [self.open]


class _Ops(TorchDispatchMode):
    """Dtypes, conversions, host reads and collectives of every aten op."""

    def __init__(self, prof: ProgramProfile, timeline: _Timeline):
        super().__init__()
        self.prof, self.timeline = prof, timeline
        self.outputs: set = set()
        #: the devices of the ops' output tensors
        self.devices: set = set()
        self.converts: Counter = Counter()
        self.collectives: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.prof.ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                self.collectives[kind] += 1
                self.timeline.collective()
            return out
        if name == "_local_scalar_dense":
            self.prof.host_reads += 1
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.outputs.add(_dtype_name(t.dtype))
                self.devices.add(t.device)
        if name in _CONVERTS:
            src = args[1] if name == "copy_" else args[0]
            dst = out
            if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.dtype != dst.dtype and src.is_floating_point()
                    and dst.is_floating_point()):
                self.converts[f"{_dtype_name(src.dtype)}->"
                              f"{_dtype_name(dst.dtype)}"] += 1
        return out


class _Calls(TorchFunctionMode):
    """The isfinite sites and the host reads no aten op shows."""

    def __init__(self, prof: ProgramProfile):
        super().__init__()
        self.prof = prof

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name == "isfinite":
            self.prof.isfinite_sites += 1
        elif name in _HOST_METHODS:
            self.prof.host_reads += 1
        return func(*args, **(kwargs or {}))


def _stage_counters() -> Dict[str, Callable[[], int]]:
    from repro_torch.core import lanczos, sbr
    from repro_torch.dist import eigensolver
    return {"sbr": sbr.dispatch_count, "lanczos": lanczos.dispatch_count,
            "dist": eigensolver.dispatch_count}


_ACTIVE: List[_Timeline] = []


def mark_step() -> None:
    """Open a new step in every profile being taken (the audit's KE entries
    call it before each block-step product)."""
    for tl in _ACTIVE:
        tl.mark()


def _delta(after: dict, before: dict) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _run_device(inputs: List[torch.Tensor], outputs: set) -> str:
    """The card if any input or output tensor of the run lay on it, else
    the host."""
    cuda = [d for d in [t.device for t in inputs] + list(outputs)
            if d.type == "cuda"]
    return str(cuda[0]) if cuda else "cpu"


def profile_fn(fn: Callable, *args: Any, name: str = "",
               step_on: Optional[str] = None, tiling=None,
               summarize: Optional[Callable[[Any], dict]] = None,
               **kwargs: Any) -> ProgramProfile:
    """Run ``fn(*args, **kwargs)`` once and profile it (module docstring).

    The profile's ``device`` is where the run's tensors were (on ``cuda``
    its ``launches`` are the kernels'); ``step_on`` names the kernel
    instance whose calls open a step; ``tiling`` is the mesh's ``Tiling``
    whose label counts to take; ``summarize(result)`` keeps what the
    contract reads of the result in ``extra``."""
    prof = ProgramProfile(name=name or getattr(fn, "__name__", "fn"))
    inputs = [a for a in tree_leaves((args, kwargs))
              if isinstance(a, torch.Tensor)]
    prof.input_dtypes = sorted({_dtype_name(a.dtype) for a in args
                                if isinstance(a, torch.Tensor)})
    timeline = _Timeline(step_on)
    counters = _stage_counters()
    stages0 = {k: c() for k, c in counters.items()}
    launches0 = _kernels.launch_counts()
    labels0 = dict(tiling.counts) if tiling is not None else {}
    ops = _Ops(prof, timeline)
    _ACTIVE.append(timeline)
    t0 = time.perf_counter()
    try:
        with _launches.recording(timeline.kernel) as rec, _Calls(prof), ops:
            out = fn(*args, **kwargs)
        prof.device = _run_device(inputs, ops.devices)
        if prof.device.startswith("cuda"):
            torch.cuda.synchronize()
    finally:
        _ACTIVE.remove(timeline)
    prof.seconds = time.perf_counter() - t0
    prof.kernel_calls = dict(rec.calls)
    prof.launches = _delta(_kernels.launch_counts(), launches0)
    prof.stage_entries = _delta({k: c() for k, c in counters.items()},
                                stages0)
    prof.collectives = dict(ops.collectives)
    if tiling is not None:
        prof.collective_labels = _delta(dict(tiling.counts), labels0)
    prof.step_collectives = timeline.close()
    prof.converts = dict(ops.converts)
    prof.output_dtypes = sorted(ops.outputs)
    if summarize is not None:
        prof.extra = dict(summarize(out))
    return prof


__all__ = ["ProgramProfile", "profile_fn", "mark_step", "COLLECTIVE_KINDS"]
