"""The audit's registry: one budget contract per entry point of the port
(``repro.analysis.static_audit.registry`` in torch).

Each entry names the program(s) its solver path runs, each with the
inputs to run it on, and the :class:`BudgetContract` the run must meet.
``check_entry`` runs every program once under ``profile.profile_fn`` and
returns an :class:`EntryReport` whose ``violations`` list is empty iff the
contract holds.

The reference's ``max_dispatches`` and ``min_pallas_calls`` count
programs dispatched and ``pallas_call`` sites; here they become what the
port can count: kernel calls by instance (``exact_kernel_calls``,
``max_kernel_calls``), stage entries by ``DispatchCounter``
(``exact_stage_entries``, ``max_stage_entries``) and host reads
(``max_host_reads``). On the card every entry is also held to its
recorded kernel calls equalling the launch counters' deltas, instance by
instance: the proof that no call on the audited path took the plain
version. Whether a program ran on the card is read from its tensors
(``profile.profile_fn``), never from a label; an entry registered for the
card whose program ran no op there is a violation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .profile import ProgramProfile, profile_fn

#: dtypes every fp64 solver program may mention (loop counters, Sturm
#: index lanes, cluster ids and pivots, branch predicates ride along with
#: the float64 data): the reference's set in torch's names, without its
#: ``key<fry>`` (torch's generators hold no key tensors)
DEFAULT_ALLOWED_DTYPES: Tuple[str, ...] = (
    "float64", "int64", "int32", "uint32", "uint64", "bool",
)


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One program of an entry: what to run, on what, and how to count."""
    name: str
    fn: Callable
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the kernel instance whose calls open a step (``profile.profile_fn``)
    step_on: Optional[str] = None
    #: what the contract reads of the result, kept in ``extra``
    summarize: Optional[Callable[[Any], dict]] = None
    #: False for a probe: profiled and reported, outside the budget sums
    #: (the KE entry's whole distributed solve, which the cost-model
    #: cross-check reads)
    budgeted: bool = True


@dataclasses.dataclass(frozen=True)
class BudgetContract:
    """What an entry's run must show."""
    #: kernel launches by instance, exactly / at most
    exact_kernel_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    max_kernel_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: stage entries by counter (``sbr``, ``lanczos``, ``dist``), exactly /
    #: at most
    exact_stage_entries: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    max_stage_entries: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: host reads (``.item()``, ``bool()``, ``.tolist()``, ...) at most
    max_host_reads: Optional[int] = None
    #: collectives a single step may run ("per panel" / "per block step")
    max_collectives_per_step: Optional[int] = None
    #: the exact collective total of the budgeted programs
    exact_collectives: Optional[int] = None
    #: upper bound when an exact count is not pinned
    max_collectives: Optional[int] = None
    allowed_dtypes: Tuple[str, ...] = DEFAULT_ALLOWED_DTYPES
    #: forbid float64 -> float32/bf16/fp16 conversions
    forbid_f64_downcasts: bool = True
    #: downcast edges ("float64->float32", ...) the entry DECLARES as its
    #: precision policy (``core.precision.declared_downcasts``); empty for
    #: fp64 contracts, where every downcast stays a leak
    declared_downcasts: Tuple[str, ...] = ()
    #: at least this many ``isfinite`` sites over the budgeted programs:
    #: proof that the health sentinel is in the path (one that fell out
    #: would stop guarding)
    min_isfinite_sites: int = 0
    #: at least this many in EACH budgeted program (an entry of several
    #: stages, each with its own sentinel)
    min_isfinite_sites_per_program: int = 0
    #: host reads and stage entries the sentinels may ADD to the maxima
    #: above; pinned to 0 repo-wide: the verdicts stay device tensors
    #: inside the stages that run anyway
    sentinel_extra_dispatches: int = 0
    #: the bucket's second call is served from its cached program and
    #: builds (captures) nothing: the program named ``warm`` must show a
    #: cache hit, no pipeline or program built and the pieces the ``cold``
    #: call ran, as often; on the card every piece captured, each replay
    #: from a captured graph, and the graphs launching the kernels the
    #: ``cold`` call recorded
    bucket_reuse: bool = False
    notes: str = ""

    def as_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["allowed_dtypes"] = list(self.allowed_dtypes)
        d["declared_downcasts"] = list(self.declared_downcasts)
        return d


@dataclasses.dataclass(frozen=True)
class AuditEntry:
    name: str
    #: builds the ProgramSpecs (and their inputs) when the entry is
    #: checked; a mesh entry's takes the mesh
    build: Callable[..., Sequence[ProgramSpec]]
    contract: BudgetContract
    needs_mesh: bool = False
    tags: Tuple[str, ...] = ()
    #: the device the build puts the programs' tensors on (``None``:
    #: whatever the build gives); a program registered for ``cuda`` must
    #: run on the card
    device: Optional[str] = None


@dataclasses.dataclass
class EntryReport:
    name: str
    contract: BudgetContract
    profiles: List[ProgramProfile]
    kernel_calls: Dict[str, int]
    stage_entries: Dict[str, int]
    total_collectives: int
    max_collectives_per_step: int
    violations: List[str]
    skipped: bool = False
    isfinite_sites: int = 0
    host_reads: int = 0
    #: the profiles of the probes (``ProgramSpec.budgeted`` False)
    probes: List[ProgramProfile] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_json_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "skipped": self.skipped,
                "violations": self.violations,
                "kernel_calls": self.kernel_calls,
                "stage_entries": self.stage_entries,
                "isfinite_sites": self.isfinite_sites,
                "host_reads": self.host_reads,
                "total_collectives": self.total_collectives,
                "max_collectives_per_step": self.max_collectives_per_step,
                "contract": self.contract.as_json_dict(),
                "programs": [p.as_json_dict() for p in self.profiles],
                "probes": [p.as_json_dict() for p in self.probes]}


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, AuditEntry] = {}


def register(entry: AuditEntry) -> AuditEntry:
    _REGISTRY[entry.name] = entry
    return entry


def get_entry(name: str) -> AuditEntry:
    return _REGISTRY[name]


def entries(tags: Optional[Sequence[str]] = None) -> List[AuditEntry]:
    out = list(_REGISTRY.values())
    if tags:
        want = set(tags)
        out = [e for e in out if want & set(e.tags)]
    return out


def clear_registry() -> None:
    _REGISTRY.clear()


# --------------------------------------------------------------------------
# contract checking
# --------------------------------------------------------------------------

def _sum(dicts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _check_counts(what: str, got: Dict[str, int], exact: Dict[str, int],
                  most: Dict[str, int], slack: int = 0) -> List[str]:
    viol = []
    for k, want in exact.items():
        if got.get(k, 0) != want:
            viol.append(f"{what} {k} {got.get(k, 0)} != pinned {want}")
    for k, cap in most.items():
        if got.get(k, 0) > cap + slack:
            viol.append(f"{what} {k} {got.get(k, 0)} > budget {cap + slack}")
    return viol


def _check_graphs(cold: ProgramProfile, warm: ProgramProfile) -> List[str]:
    """The card's bucket: every piece captured, every replay of the second
    call from a captured graph, and the graphs launching exactly the
    instances the first call recorded (its warm-up run and its captures),
    each captured no more often than recorded. A replay runs no Python, so
    the second call's own recorded calls are none: this is what shows its
    kernels ran."""
    x = warm.extra
    viol = []
    captured = x.get("graph_launches", {})
    if len(captured) != x.get("graphs"):
        viol.append(f"{len(captured)} captured graph(s) for the program's "
                    f"{x.get('graphs')} piece(s)")
    loose = sorted(set(x.get("graph_replays", {})) - set(captured))
    if loose:
        viol.append(f"the second call replayed pieces without a captured "
                    f"graph: {loose}")
    in_graphs = _sum(captured.values())
    recorded = {k: v for k, v in cold.kernel_calls.items() if v}
    if set(in_graphs) != set(recorded):
        viol.append(f"the graphs launch {sorted(in_graphs)}, the first call "
                    f"recorded {sorted(recorded)}")
    over = {k: (v, recorded.get(k, 0)) for k, v in in_graphs.items()
            if v > recorded.get(k, 0)}
    if over:
        viol.append(f"captured launches above the first call's recorded "
                    f"calls (captured, recorded): {over}")
    return viol


def _check_reuse(profiles: List[ProgramProfile]) -> List[str]:
    by_name = {p.name: p for p in profiles}
    cold, warm = by_name.get("cold"), by_name.get("warm")
    if cold is None or warm is None:
        return ["bucket_reuse: the entry needs a 'cold' and a 'warm' program"]
    x = warm.extra
    viol = []
    if not x.get("cache_hit"):
        viol.append("the bucket's second call missed its cached program")
    if x.get("pipelines_built") or x.get("programs_built"):
        viol.append(f"the bucket's second call built "
                    f"{x.get('pipelines_built')} pipeline(s) and "
                    f"{x.get('programs_built')} program(s)")
    # the same pencils and starts: the same pieces, as often (a Krylov
    # bucket done after its first restart runs no segment on either call)
    if x.get("graph_replays") != cold.extra.get("graph_replays"):
        viol.append(f"the second call ran the pieces "
                    f"{x.get('graph_replays')}, the first "
                    f"{cold.extra.get('graph_replays')}")
    if not x.get("graph_replays"):
        viol.append("the second call ran no piece of the program")
    if x.get("path") == "cuda_graphs":
        viol += _check_graphs(cold, warm)
    return viol


def _check_contract(c: BudgetContract, profiles: List[ProgramProfile]
                    ) -> Tuple[dict, List[str]]:
    viol: List[str] = []
    calls = _sum(p.kernel_calls for p in profiles)
    stages = _sum(p.stage_entries for p in profiles)
    total_coll = sum(p.total_collectives() for p in profiles)
    per_step = max((p.max_collectives_per_step() for p in profiles),
                   default=0)
    isfinite = sum(p.isfinite_sites for p in profiles)
    host_reads = sum(p.host_reads for p in profiles)
    slack = c.sentinel_extra_dispatches
    viol += _check_counts("kernel calls", calls, c.exact_kernel_calls,
                          c.max_kernel_calls)
    viol += _check_counts("stage entries", stages, c.exact_stage_entries,
                          c.max_stage_entries, slack)
    if c.max_host_reads is not None and host_reads > c.max_host_reads + slack:
        viol.append(f"host reads {host_reads} > budget "
                    f"{c.max_host_reads + slack} (base {c.max_host_reads} "
                    f"+ sentinel allowance {slack})")
    if isfinite < c.min_isfinite_sites:
        viol.append(f"{isfinite} isfinite site(s) < required "
                    f"{c.min_isfinite_sites} (health sentinel missing from "
                    f"the path)")
    low = [p.name for p in profiles
           if p.isfinite_sites < c.min_isfinite_sites_per_program]
    if low:
        viol.append(f"program(s) {low} with fewer than "
                    f"{c.min_isfinite_sites_per_program} isfinite site(s) "
                    f"(a stage's health sentinel missing from its path)")
    if (c.max_collectives_per_step is not None
            and per_step > c.max_collectives_per_step):
        viol.append(f"collectives per step {per_step} > budget "
                    f"{c.max_collectives_per_step}")
    if c.exact_collectives is not None and total_coll != c.exact_collectives:
        viol.append(f"collective total {total_coll} != pinned "
                    f"{c.exact_collectives}")
    if c.max_collectives is not None and total_coll > c.max_collectives:
        viol.append(f"collective total {total_coll} > budget "
                    f"{c.max_collectives}")
    for p in profiles:
        if p.collective_labels and (sum(p.collective_labels.values())
                                    != p.total_collectives()):
            viol.append(f"{p.name}: the mesh counted "
                        f"{sum(p.collective_labels.values())} collectives, "
                        f"the dispatcher saw {p.total_collectives()}")
        if p.device.startswith("cuda") and p.kernel_calls != p.launches:
            viol.append(f"{p.name}: recorded kernel calls {p.kernel_calls} "
                        f"!= launch-counter deltas {p.launches} (a call "
                        f"took the plain version)")
        if c.forbid_f64_downcasts:
            leaks = {k: v for k, v in p.f64_downcasts().items()
                     if k not in set(c.declared_downcasts)}
            if leaks:
                viol.append(f"{p.name}: precision leak(s) {leaks}")
        if c.allowed_dtypes:
            bad = [d for d in p.dtypes_seen() if d not in c.allowed_dtypes]
            if bad:
                viol.append(f"{p.name}: dtypes {bad} outside allowed set")
    if c.bucket_reuse:
        viol += _check_reuse(profiles)
    return {"kernel_calls": calls, "stage_entries": stages,
            "total_collectives": total_coll,
            "max_collectives_per_step": per_step, "isfinite_sites": isfinite,
            "host_reads": host_reads}, viol


def _profile(spec: ProgramSpec, tiling) -> ProgramProfile:
    return profile_fn(spec.fn, *spec.args, name=spec.name,
                      step_on=spec.step_on, tiling=tiling,
                      summarize=spec.summarize, **spec.kwargs)


def _check_device(entry: AuditEntry, profiles: List[ProgramProfile]
                  ) -> List[str]:
    if entry.device is None:
        return []
    want = entry.device.split(":")[0]
    return [f"{p.name}: registered for {entry.device}, ran on {p.device}"
            for p in profiles if p.device.split(":")[0] != want]


def check_entry(entry: AuditEntry, mesh=None) -> EntryReport:
    """Run and profile every program of ``entry`` on the device its build
    gives (a mesh entry on ``mesh``, from inside its ranks) and enforce its
    contract."""
    tiling = None
    if entry.needs_mesh:
        if mesh is None:
            raise ValueError(f"{entry.name} runs on a mesh; none was given")
        from repro_torch.dist.mesh import tiling as _tiling
        tiling = _tiling(mesh)
        specs = list(entry.build(mesh))
    else:
        specs = list(entry.build())
    profiles = [_profile(s, tiling) for s in specs if s.budgeted]
    probes = [_profile(s, tiling) for s in specs if not s.budgeted]
    totals, viol = _check_contract(entry.contract, profiles)
    viol += _check_device(entry, profiles + probes)
    return EntryReport(name=entry.name, contract=entry.contract,
                       profiles=profiles, violations=viol, probes=probes,
                       **totals)


def skipped_report(entry: AuditEntry) -> EntryReport:
    return EntryReport(name=entry.name, contract=entry.contract, profiles=[],
                       kernel_calls={}, stage_entries={},
                       total_collectives=0, max_collectives_per_step=0,
                       violations=[], skipped=True)


def check_all(tags: Optional[Sequence[str]] = None,
              mesh=None) -> List[EntryReport]:
    """Every registered entry (of ``tags``); the mesh entries run on
    ``mesh`` (from inside its ranks) and are skipped without one."""
    return [skipped_report(e) if e.needs_mesh and mesh is None
            else check_entry(e, mesh) for e in entries(tags)]


__all__ = ["ProgramSpec", "BudgetContract", "AuditEntry", "EntryReport",
           "register", "get_entry", "entries", "clear_registry",
           "check_entry", "check_all", "skipped_report",
           "DEFAULT_ALLOWED_DTYPES"]
