"""Batched GSYEIG: stacks of same-shape pencils through one shape bucket's
program (``repro.core.batched`` in torch).

The paper's two applications solve sequences of same-shape pencils (one
per MD timestep, one per SCF step in DFT). ``solve_batched`` runs a
``(batch, n, n)`` stack through a program built once per shape bucket
``(n, s, variant, which, ...)`` and batch size, and cached: the
reference compiles each variant's pipeline once as one vmapped XLA
program; the port captures it in CUDA graphs.

Each pencil runs the port's own stage functions, so it launches the same
kernel instances as ``solve`` does on it: TD ``tridiagonalize``,
``eigh_tridiag_selected`` and ``apply_q``; TT ``reduce_to_band``,
``band_chase``, ``eigh_tridiag_selected``, ``apply_q2`` and the Q1
product; KE/KI the ``ExplicitC``/``ImplicitC`` operator under
``lanczos_solve_jit``'s fixed-trip loop (``KrylovStack``, a
``KrylovLane`` a pencil). The pencils of a bucket run one after
another. Below fp64 the same stages as in the
reference are demoted (TD1/TD3, TT1/TT2/TT4, the Krylov operator;
Cholesky, the standard form and the tridiagonal eigensolve stay fp64)
and ``refine_steps`` fixed fp64 refinement steps against the original
pencil follow (``core.refinement``, the ``fixed_refactors`` schedule).

**The program.** Its static buffers (the stacks of A and B, the random
starts, the Krylov and refinement state, the outputs) are allocated
once; its *pieces* are the code between two split points, run for every
pencil in turn. On the card, a cold call runs the program once eagerly,
every piece at least once (which builds the kernels,
``kernels/_build.py``, and fixes every plan and cluster-capacity query),
then captures one CUDA graph for each piece of the bucket, whether or
not this call's loop needs it; ``compile_s`` is both together. A warm
call copies the inputs into the static buffers, draws the starts there
(outside the graphs, from the generator), replays, and clones the
outputs out; ``wall_s`` and ``pencils_per_s`` time that. A failed
capture or replay raises, and so does a piece without a graph: there is
no eager fallback for a CUDA tensor. On the CPU the pieces run eagerly.

**Split points**, where the program leaves the graphs (``info['graphs']``
counts the graphs between them):

1. the ``eigh`` of each Lanczos restart (KE/KI): ``torch.linalg.eigh``
   reads its ``info`` on the host, so it runs between two graphs, once
   for the bucket on the stacked (batch, m, m) operands;
2. the ``eigh`` of the filter probe (KE/KI with ``filter_degree > 0``),
   on the (batch, k, k) stack;
3. the host's read of the bucket's all-done flag after each restart
   (KE/KI): the vmapped ``cond`` of the reference's while loop;
4. the Rayleigh-Ritz ``eigh`` of each refinement step (below fp64), on
   the (batch, q, q) stack.

Cholesky and the refinement's LU go through ``cholesky_ex`` and
``lu_factor_ex``, which leave their ``info`` on the device, and the
refinement's shift is a 0-d tensor (``refinement.sigma_fixed``), so none
of them splits. The pieces: TD/TT ``direct``; KE/KI ``krylov_init``,
``krylov_filter`` (filter only), ``krylov_restart``, ``krylov_segment``
and ``krylov_final``; below fp64 ``refine_step``, ``refine_refactor``
and ``refine_end`` (as the schedule needs them).

**Launch counts.** The kernel wrappers count on the host, so they count
a graph's launches when it is captured, not when it is replayed.
``info['graph_launches']`` holds each graph's captured counts (launches
a replay), ``info['graph_replays']`` the replays of this call, and
``info['kernel_launches']`` their product summed: the launches this call
ran. For TD/TT that is ``batch`` times an eager ``solve``'s counts.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import kernels as _kernels
from repro_torch.device import resolve_device, synchronize

from .back_transform import back_transform_generalized
from .cholesky import cholesky_upper
from .lanczos import (KrylovLane, KrylovStack, default_subspace, eigh_stack,
                      krylov_matvec)
from .operators import ExplicitC, ImplicitC
from .precision import (compute_dtype, default_refine_steps, ensure_strong,
                        validate_precision)
from .refinement import (_select, default_guard, factor_fixed,
                         fixed_refactors, refine_pre, sigma_fixed,
                         with_guards)
from .residuals import b_normalize
from .sbr import apply_q2, band_chase, default_n_chunks, reduce_to_band
from .standard_form import to_standard_two_trsm
from .tridiag import apply_q, tridiagonalize
from .tridiag_eig import eigh_tridiag_selected

BATCHED_VARIANTS = ("TD", "TT", "KE", "KI")
#: the tridiagonal-stage methods the bucket key takes: the port has one,
#: the bisection and inverse-iteration kernels (the reference's default)
TT3_METHODS = ("batched",)
#: seed of the default generator of the random starts (``gsyeig``'s)
SOLVE_SEED = 20120520


class BatchedSolveResult(NamedTuple):
    evals: torch.Tensor       # (batch, s) ascending per pencil
    X: torch.Tensor           # (batch, n, s) B-orthonormal eigenvectors
    converged: torch.Tensor   # (batch,) bool (always True for TD/TT)
    healthy: torch.Tensor     # (batch,) bool finite-sentinel verdict
    info: Dict[str, Any]


# --------------------------------------------------------------------------
# per-pencil pipelines
# --------------------------------------------------------------------------

def _output_sentinel(lam, X):
    """Per-pencil health sentinel: a non-SPD B (NaN Cholesky) or an
    overflow in a demoted stage reaches (lam, X), so their finiteness
    covers every stage."""
    return torch.isfinite(lam).all() & torch.isfinite(X).all()


def _finalize_invert(lam, X, B_orig):
    """Undo the inverse-pair trick (``gsyeig._finalize``'s arithmetic)."""
    lam = 1.0 / lam
    order = torch.argsort(lam)
    return lam[order], b_normalize(X[:, order], B_orig)


def _pipeline_direct(A, B, x0, pipe: "_Pipeline"):
    """TD or TT on one pencil up to the fp64 refinement: (lam, X) with
    lam ascending, the calls ``gsyeig`` makes on it."""
    B_orig, which = B, pipe.which
    if pipe.invert:
        A, B = B, A
        which = "largest" if which == "smallest" else "smallest"
    n, s, w, cdtype = A.shape[0], pipe.s, pipe.band_width, pipe.cdtype
    U = cholesky_upper(B)
    C = to_standard_two_trsm(A, U).to(cdtype)
    ks = (torch.arange(s, device=A.device) if which == "smallest"
          else torch.arange(n - s, n, device=A.device))
    if pipe.variant == "TD":
        res = tridiagonalize(C)
        lam, Z = eigh_tridiag_selected(res.d.double(), res.e.double(), ks,
                                       x0=x0)
        Y = apply_q(res, Z.to(cdtype)).double()
    else:
        band = reduce_to_band(C, w=w, n_chunks=default_n_chunks(n, w))
        chase = band_chase(band.Wb, w)
        lam, Z = eigh_tridiag_selected(chase.d.double(), chase.e.double(), ks,
                                       x0=x0)
        Y = (band.Q1 @ apply_q2(chase, Z.to(cdtype), w)).double()
    X = back_transform_generalized(U, Y)
    if pipe.invert:
        lam, X = _finalize_invert(lam, X, B_orig)
    return lam, X


def _krylov_operator(A, B, pipe: "_Pipeline", use_kernel: bool):
    """(U, matvec, floor) of one Krylov pencil: GS1, GS2 for KE, and the
    operator demoted to the compute dtype below fp64."""
    if pipe.invert:
        A, B = B, A
    U = cholesky_upper(B)
    op = (ExplicitC(to_standard_two_trsm(A, U)) if pipe.variant == "KE"
          else ImplicitC(A, U))
    demote = None if pipe.cdtype == torch.float64 else pipe.cdtype
    return (U,) + krylov_matvec(op, use_kernel, demote)


def _pipeline_krylov(lane: KrylovLane, U, B_orig, pipe: "_Pipeline"):
    """KE or KI on one pencil after its restart loop, up to the fp64
    refinement: (lam ascending, X, converged, healthy)."""
    lam, Y, _, converged, healthy = lane.result()
    order = torch.argsort(lam)
    X = back_transform_generalized(U, Y[:, order])
    lam = lam[order]
    if pipe.invert:
        lam, X = _finalize_invert(lam, X, B_orig)
    return lam, X, converged, healthy


# --------------------------------------------------------------------------
# the bucket's program
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Pipeline:
    """One shape bucket: what a program at any batch size is built from."""
    n: int
    s: int
    variant: str
    which: str
    band_width: int
    m: int | None
    max_restarts: int
    invert: bool
    p: int
    filter_degree: int
    cdtype: torch.dtype
    refine_steps: int

    def build(self, batch: int, device: torch.device,
              use_kernel: bool) -> "_Program":
        return _Program(self, batch, device, use_kernel)


class _Program:
    """One bucket's program at one batch size on one device: its static
    buffers, its pieces and, once captured, one CUDA graph per piece."""

    def __init__(self, pipe: _Pipeline, batch: int, device: torch.device,
                 use_kernel: bool):
        n, s = pipe.n, pipe.s
        f64 = dict(dtype=torch.float64, device=device)
        self.pipe, self.batch, self.device = pipe, batch, device
        self.use_kernel = use_kernel
        self.A = torch.zeros((batch, n, n), **f64)
        self.B = torch.zeros((batch, n, n), **f64)
        self.lam = torch.zeros((batch, s), **f64)
        self.X = torch.zeros((batch, n, s), **f64)
        self.converged = torch.ones((batch,), dtype=torch.bool, device=device)
        self.healthy = torch.ones((batch,), dtype=torch.bool, device=device)
        #: the random starts' static stacks, by ``solve_batched`` argument
        self.starts: Dict[str, torch.Tensor] = {}
        self._pieces: Dict[str, Any] = {}
        self.ran: set = set()             # pieces run eagerly so far
        self.captured = False
        self.graphs: Dict[str, Any] = {}
        self.graph_launches: Dict[str, Dict[str, int]] = {}
        self.replays: Dict[str, int] = {}
        self.restarts = 0
        self.stage = (_Direct(self) if pipe.variant in ("TD", "TT")
                      else _Krylov(self))
        self.refine = _FixedRefine(self) if pipe.refine_steps > 0 else None

    def add(self, name: str, fn) -> None:
        self._pieces[name] = fn

    def piece(self, name: str) -> None:
        """Run piece ``name``: once captured, replay its graph (a piece
        without one raises), else run its code eagerly."""
        self.replays[name] = self.replays.get(name, 0) + 1
        if self.captured:
            graph = self.graphs.get(name)
            if graph is None:
                raise RuntimeError(f"solve_batched: piece {name!r} of the "
                                   f"{self.pipe.variant} bucket has no graph")
            graph.replay()
            return
        self.ran.add(name)
        self._pieces[name]()

    def output(self, i: int, lam, X, ok=None) -> None:
        """Pencil i's pipeline result: into the refinement below fp64,
        else into the bucket's outputs; ``ok`` its stage verdict."""
        if ok is None:
            self.healthy[i].fill_(True)
        else:
            self.healthy[i].copy_(ok)
        if self.refine is None:
            self.write(i, lam, X)
        else:
            self.refine.start(i, lam, X)

    def write(self, i: int, lam, X) -> None:
        self.lam[i].copy_(lam)
        self.X[i].copy_(X)
        self.healthy[i].copy_(self.healthy[i] & _output_sentinel(lam, X))

    def run(self, warm: bool = False) -> None:
        """Drive the pieces once; ``warm`` runs every piece at least once
        (a Krylov bucket segments once more than its loop needs)."""
        self.replays = {}
        self.restarts = 0
        self.stage.drive(warm)
        if self.refine is not None:
            self.refine.drive()

    def capture(self) -> None:
        """Run every piece once eagerly on a side stream (builds the
        kernels, fixes their plans and the stream's scratch), then capture
        each in a graph of its own (its own memory pool: a piece replayed
        again after a later one cannot overwrite what that one keeps).
        Every piece is captured, whichever a later call's loop needs."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.run(warm=True)
        torch.cuda.current_stream(self.device).wait_stream(side)
        synchronize(self.device)
        missed = [name for name in self._pieces if name not in self.ran]
        if missed:
            raise RuntimeError(f"solve_batched: the warm-up did not run "
                               f"the pieces {missed}")
        # no collection during a capture: one would free the graphs of a
        # dropped program (a reference cycle), and destroying a graph is
        # an operation a capture forbids, which invalidates it
        collecting = gc.isenabled()
        for name in self._pieces:
            graph = torch.cuda.CUDAGraph()
            before = _kernels.launch_counts()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=side):
                    self._pieces[name]()
            except RuntimeError as err:
                raise RuntimeError(
                    f"solve_batched: capturing piece {name!r} of the "
                    f"{self.pipe.variant} bucket (n={self.pipe.n}, "
                    f"s={self.pipe.s}, batch={self.batch}) failed: {err}"
                ) from err
            finally:
                if collecting:
                    gc.enable()
            after = _kernels.launch_counts()
            self.graph_launches[name] = {k: after[k] - before[k]
                                         for k in after
                                         if after[k] != before[k]}
            self.graphs[name] = graph
        self.captured = True

    def draw(self, starts: Dict[str, Any], generator) -> Dict[str, Any]:
        """Each random start of the program: its argument, else a draw
        from ``generator`` (in ``self.starts``' order); the filter probe
        defaults to the start block's first column, as in the
        reference."""
        out: Dict[str, Any] = {}
        for name, buf in self.starts.items():
            given = starts.get(name)
            if given is not None:
                given = torch.as_tensor(given).to(device=self.device,
                                                  dtype=torch.float64)
                if given.shape != buf.shape:
                    raise ValueError(f"{name} must be {tuple(buf.shape)}, "
                                     f"got {tuple(given.shape)}")
            elif name == "probe_v0":
                given = out["v0"][:, :, 0]
            else:
                given = torch.randn(buf.shape, generator=generator,
                                    dtype=torch.float64, device=self.device)
            out[name] = given
        return out

    def load(self, A, B, draws: Dict[str, Any]) -> None:
        """Copy the stacks and the starts into the static buffers."""
        self.A.copy_(A)
        self.B.copy_(B)
        for name, buf in self.starts.items():
            buf.copy_(draws[name])

    def launches(self) -> Dict[str, int]:
        """Kernel launches of the last ``run``'s replays."""
        total = dict.fromkeys(_kernels.launch_counts(), 0)
        for name, counts in self.graph_launches.items():
            for k, v in counts.items():
                total[k] += v * self.replays.get(name, 0)
        return total


class _Direct:
    """TD/TT: one piece, the whole pipeline of every pencil."""

    def __init__(self, prog: _Program):
        pipe = prog.pipe
        self.prog = prog
        prog.starts["x0"] = torch.zeros((prog.batch, pipe.n, pipe.s),
                                        dtype=torch.float64,
                                        device=prog.device)
        prog.add("direct", self.direct)

    def direct(self) -> None:
        prog = self.prog
        for i in range(prog.batch):
            lam, X = _pipeline_direct(prog.A[i], prog.B[i],
                                      prog.starts["x0"][i], prog.pipe)
            prog.output(i, lam, X)

    def drive(self, warm: bool = False) -> None:
        self.prog.piece("direct")


class _Krylov:
    """KE/KI: ``lanczos_solve_jit``'s loop (``KrylovStack``) over the
    bucket, a ``KrylovLane`` a pencil, then the pipeline's end."""

    def __init__(self, prog: _Program):
        pipe, b, dev = prog.pipe, prog.batch, prog.device
        n, m, p = pipe.n, pipe.m, pipe.p
        self.prog = prog
        which = "SA" if (pipe.which == "smallest") != pipe.invert else "LA"
        lanes = [KrylovLane(n, pipe.s, m, p, which, pipe.max_restarts, 0.0,
                            dev) for _ in range(b)]
        self.U: list = [None] * b
        prog.starts["v0"] = torch.zeros((b, n, p), dtype=torch.float64,
                                        device=dev)
        if pipe.filter_degree > 0:
            prog.starts["probe_v0"] = torch.zeros((b, n), dtype=torch.float64,
                                                  device=dev)
        self.stack = KrylovStack(lanes, self.operator, prog.starts["v0"],
                                 prog.starts.get("probe_v0"),
                                 pipe.filter_degree)
        for name, fn in self.stack.pieces().items():
            prog.add(name, fn)
        prog.add("krylov_final", self.final)

    def operator(self, i: int):
        prog = self.prog
        self.U[i], matvec, floor = _krylov_operator(prog.A[i], prog.B[i],
                                                    prog.pipe, prog.use_kernel)
        return matvec, floor

    def final(self) -> None:
        prog = self.prog
        for i, lane in enumerate(self.stack.lanes):
            lam, X, conv, ok = _pipeline_krylov(lane, self.U[i], prog.B[i],
                                                prog.pipe)
            prog.converged[i].copy_(conv)
            prog.output(i, lam, X, ok)

    def drive(self, warm: bool = False) -> None:
        self.stack.drive(self.prog.piece, segment_once=warm)
        self.prog.restarts = self.stack.restarts
        self.prog.piece("krylov_final")


class _FixedRefine:
    """``refine_eigenpairs_fixed`` over the bucket against the original
    pencils, cut at each step's ``eigh``: its start runs in the stage's
    last piece, then after each ``eigh`` a ``refine_step`` (the next step
    in the same phase), ``refine_refactor`` (re-shift and refactor first)
    or ``refine_end`` piece."""

    def __init__(self, prog: _Program):
        pipe, b, dev = prog.pipe, prog.batch, prog.device
        n, s = pipe.n, pipe.s
        f64 = dict(dtype=torch.float64, device=dev)
        self.prog = prog
        self.guard = default_guard(s, n)
        q = s + self.guard
        self.refactors = fixed_refactors(pipe.refine_steps)
        if self.guard > 0:
            prog.starts["guard0"] = torch.zeros((b, n, self.guard), **f64)
        self.lam_q = torch.zeros((b, q), **f64)
        self.X_q = torch.zeros((b, n, q), **f64)
        self.Z = torch.zeros((b, n, q), **f64)
        self.H = torch.zeros((b, q, q), **f64)
        self.w = torch.zeros((b, q), **f64)
        self.S = torch.zeros((b, q, q), **f64)
        self.lu = torch.zeros((b, n, n), dtype=torch.float32, device=dev)
        self.piv = torch.zeros((b, n), dtype=torch.int32, device=dev)
        steps = len(self.refactors)
        #: the piece after each step's ``eigh``
        self.schedule = ["refine_end" if k + 1 == steps else
                         "refine_refactor" if self.refactors[k + 1]
                         else "refine_step" for k in range(steps)]
        pieces = {"refine_step": lambda: self.step(False),
                  "refine_refactor": lambda: self.step(True),
                  "refine_end": self.end}
        for name in dict.fromkeys(self.schedule):
            prog.add(name, pieces[name])

    def _pre(self, i: int, anchor, refactor: bool) -> None:
        A, B = self.prog.A[i], self.prog.B[i]
        if refactor:
            lu, piv = factor_fixed(A, B,
                                   sigma_fixed(anchor, self.prog.pipe.which))
            self.lu[i].copy_(lu)
            self.piv[i].copy_(piv)
        Z, H = refine_pre(self.lu[i], self.piv[i], A, B, self.lam_q[i],
                          self.X_q[i])
        self.Z[i].copy_(Z)
        self.H[i].copy_(H)

    def _post(self, i: int):
        self.lam_q[i].copy_(self.w[i])
        self.X_q[i].copy_(self.Z[i] @ self.S[i])
        return _select(self.lam_q[i], self.X_q[i], self.prog.pipe.s,
                       self.prog.pipe.which)

    def start(self, i: int, lam, X) -> None:
        G = self.prog.starts["guard0"][i] if self.guard > 0 else None
        lam_q, X_q = with_guards(lam, X, self.guard, self.prog.pipe.which, G)
        self.lam_q[i].copy_(lam_q)
        self.X_q[i].copy_(X_q)
        self._pre(i, lam, True)

    def step(self, refactor: bool) -> None:
        for i in range(self.prog.batch):
            self._pre(i, self._post(i)[0], refactor)

    def end(self) -> None:
        for i in range(self.prog.batch):
            self.prog.write(i, *self._post(i))

    def drive(self) -> None:
        for name in self.schedule:
            eigh_stack(self.H, self.w, self.S)
            self.prog.piece(name)


# --------------------------------------------------------------------------
# shape-bucketed caches
# --------------------------------------------------------------------------

# pipeline_cache_key -> _Pipeline
_PIPELINE_CACHE: Dict[Tuple, _Pipeline] = {}
# (pipeline_cache_key, batch, device, use_kernel) -> _Program (captured on
# the card): the counterpart of the reference's AOT executable cache
_EXEC_CACHE: Dict[Tuple, _Program] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pipeline_cache_key(n: int, s: int, variant: str, which: str, *,
                       band_width: int = 8, m: int | None = None,
                       max_restarts: int = 200, invert: bool = False,
                       p: int = 1, filter_degree: int = 0,
                       dtype=torch.float64, tt3: str = "batched",
                       precision: str = "fp64",
                       refine_steps: int | None = None) -> Tuple:
    """The reference's 14-tuple, with torch's dtype name."""
    if variant in ("KE", "KI") and m is None:
        m = default_subspace(s, n, p)
    if refine_steps is None:
        refine_steps = default_refine_steps(precision)
    return (int(n), int(s), variant, which, int(band_width),
            None if m is None else int(m), int(max_restarts), bool(invert),
            int(p), int(filter_degree), _dtype_name(dtype), tt3,
            validate_precision(precision), int(refine_steps))


def get_pipeline(n: int, s: int, variant: str, which: str, *,
                 band_width: int = 8, m: int | None = None,
                 max_restarts: int = 200, invert: bool = False,
                 p: int = 1, filter_degree: int = 0,
                 dtype=torch.float64, tt3: str = "batched",
                 precision: str = "fp64", refine_steps: int | None = None):
    """The pipeline of one shape bucket (cached) and its key.

    ``p`` (Lanczos block size), ``filter_degree`` (Chebyshev start
    filter), ``precision`` and ``refine_steps`` are part of the bucket, as
    in the reference; ``tt3`` names the tridiagonal method (the port has
    one, ``"batched"``)."""
    if variant not in BATCHED_VARIANTS:
        raise ValueError(f"variant must be one of {BATCHED_VARIANTS}, got "
                         f"{variant!r}")
    if which not in ("smallest", "largest"):
        raise ValueError(f"which must be 'smallest' or 'largest', got "
                         f"{which!r}")
    if tt3 not in TT3_METHODS:
        raise ValueError(f"tt3 must be one of {TT3_METHODS}, got {tt3!r}")
    ckey = pipeline_cache_key(n, s, variant, which, band_width=band_width,
                              m=m, max_restarts=max_restarts, invert=invert,
                              p=p, filter_degree=filter_degree, dtype=dtype,
                              tt3=tt3, precision=precision,
                              refine_steps=refine_steps)
    pipe = _PIPELINE_CACHE.get(ckey)
    if pipe is not None:
        _CACHE_STATS["hits"] += 1
        return pipe, ckey
    _CACHE_STATS["misses"] += 1
    m_eff = ckey[5]
    if m_eff is not None and (m_eff % p or m_eff + p > n
                              or not 2 * s < m_eff + 1 or max_restarts < 1):
        raise ValueError(f"m={m_eff} must be a multiple of p={p} with "
                         f"2 s - 1 < m and m + p <= n (n={n}, s={s}), and "
                         f"max_restarts >= 1")
    pipe = _Pipeline(n=int(n), s=int(s), variant=variant, which=which,
                     band_width=int(band_width), m=m_eff,
                     max_restarts=int(max_restarts), invert=bool(invert),
                     p=int(p), filter_degree=int(filter_degree),
                     cdtype=compute_dtype(precision),
                     refine_steps=ckey[-1])
    _PIPELINE_CACHE[ckey] = pipe
    return pipe, ckey


def cache_stats() -> Dict[str, int]:
    return dict(_CACHE_STATS, entries=len(_PIPELINE_CACHE),
                exec_entries=len(_EXEC_CACHE))


def clear_pipeline_cache() -> None:
    _PIPELINE_CACHE.clear()
    _EXEC_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


# --------------------------------------------------------------------------
# public driver
# --------------------------------------------------------------------------

def solve_batched(A, B, s: int, variant: str = "TD",
                  which: str = "smallest", invert: bool = False,
                  band_width: int = 8, m: int | None = None,
                  max_restarts: int = 200,
                  generator: torch.Generator | None = None, p: int = 1,
                  filter_degree: int = 0, tt3: str = "batched",
                  precision: str = "fp64", refine_steps: int | None = None,
                  use_kernel: bool = False, x0=None, v0=None, probe_v0=None,
                  guard0=None, device=None) -> BatchedSolveResult:
    """Solve a stack of same-shape pencils ``A[i] X = B[i] X Lambda`` on
    ``device`` (``None`` = the card; the CPU only when asked for).

    ``A``, ``B``: (batch, n, n). Returns per-pencil ascending eigenvalues
    (batch, s) and B-orthonormal eigenvectors (batch, n, s). ``invert``
    applies the MD inverse-pair trick per pencil (A SPD). ``p`` /
    ``filter_degree`` / ``m`` / ``max_restarts`` are the Krylov knobs
    (ignored by TD/TT; the restart loop is the reference's fixed-trip one
    at the machine-precision criterion), ``band_width`` TT's band, and
    ``use_kernel`` runs the Krylov product on ``symm_block`` (as
    ``solve``'s).

    Random starts, each stacked per pencil: ``x0`` (batch, n, s) TD2/TT3's
    inverse-iteration block (sorted ks' column order), ``v0`` (batch, n,
    p) the Lanczos start block, ``probe_v0`` (batch, n) the filter probe
    (default: ``v0``'s first column, as the reference), ``guard0`` (batch,
    n, guard) the refinement's guard block. What is not given is drawn
    from ``generator`` (default: one seeded with ``SOLVE_SEED``).

    ``precision`` demotes the reference's stages and adds
    ``refine_steps`` (default ``default_refine_steps(precision)``) fixed
    fp64 refinement steps. ``info``: the reference's keys (``cache_hit``,
    ``compile_s``, execution-only ``wall_s`` and ``pencils_per_s``,
    ``n_unconverged``, ``n_unhealthy``, ``warnings``) plus ``device``,
    ``path`` (``cuda_graphs`` or ``eager``), ``graphs``,
    ``graph_launches``, ``graph_replays``, ``kernel_launches`` and, for
    KE/KI, ``restarts`` (module docstring).
    """
    validate_precision(precision)
    dev = resolve_device(device)
    A = ensure_strong(A, dev)
    B = ensure_strong(B, dev)
    if A.dim() != 3 or A.shape != B.shape or A.shape[1] != A.shape[2]:
        raise ValueError(f"A and B must be (batch, n, n) stacks of one "
                         f"shape, got {tuple(A.shape)} and {tuple(B.shape)}")
    batch, n, _ = A.shape
    pipe, ckey = get_pipeline(n, s, variant, which, band_width=band_width,
                              m=m, max_restarts=max_restarts, invert=invert,
                              p=p, filter_degree=filter_degree,
                              dtype=A.dtype, tt3=tt3, precision=precision,
                              refine_steps=refine_steps)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(SOLVE_SEED)
    starts = {"x0": x0, "v0": v0, "probe_v0": probe_v0, "guard0": guard0}
    graphed = dev.type == "cuda"
    exec_key = (ckey, int(batch), str(dev), bool(use_kernel))
    prog = _EXEC_CACHE.get(exec_key)
    cache_hit = prog is not None
    compile_s = 0.0
    if not cache_hit:
        t0 = time.perf_counter()
        prog = pipe.build(batch, dev, bool(use_kernel))
        draws = prog.draw(starts, generator)
        if graphed:
            prog.load(A, B, draws)
            prog.capture()
        compile_s = time.perf_counter() - t0
        _EXEC_CACHE[exec_key] = prog
    else:
        draws = prog.draw(starts, generator)
    launches0 = _kernels.launch_counts()
    synchronize(dev)
    t0 = time.perf_counter()
    prog.load(A, B, draws)
    prog.run()
    lam, X = prog.lam.clone(), prog.X.clone()
    converged, healthy = prog.converged.clone(), prog.healthy.clone()
    synchronize(dev)
    wall = time.perf_counter() - t0
    if graphed:
        launches = prog.launches()
    else:
        launches1 = _kernels.launch_counts()
        launches = {k: launches1[k] - launches0[k] for k in launches1}
    n_unconverged = int((~converged).sum())
    n_unhealthy = int((~healthy).sum())
    info: Dict[str, Any] = {
        "variant": variant, "n": int(n), "s": int(s), "batch": int(batch),
        "which": which, "invert": bool(invert), "precision": precision,
        "refine_steps": int(ckey[-1]), "cache_key": list(ckey),
        "cache_hit": cache_hit, "compile_s": compile_s, "wall_s": wall,
        "pencils_per_s": batch / max(wall, 1e-12),
        "n_unconverged": n_unconverged, "n_unhealthy": n_unhealthy,
        "device": str(dev), "path": "cuda_graphs" if graphed else "eager",
        "graphs": len(prog._pieces), "graph_replays": dict(prog.replays),
        "graph_launches": {k: dict(v) for k, v in prog.graph_launches.items()},
        "kernel_launches": launches}
    if variant in ("KE", "KI"):
        info["restarts"] = prog.restarts
    if n_unconverged:
        info["warnings"] = [
            f"{variant}: {n_unconverged}/{batch} pencils retired at the "
            f"restart budget (max_restarts={max_restarts}) without "
            f"converging; their residuals may exceed tolerance"]
    if n_unhealthy:
        info.setdefault("warnings", []).append(
            f"{variant}: {n_unhealthy}/{batch} pencils produced NON-FINITE "
            f"eigenpairs (non-SPD B or overflow in a demoted stage); see "
            f"result.healthy for the per-pencil verdicts")
    return BatchedSolveResult(evals=lam, X=X, converged=converged,
                              healthy=healthy, info=info)


__all__ = ["solve_batched", "BatchedSolveResult", "BATCHED_VARIANTS",
           "get_pipeline", "pipeline_cache_key", "cache_stats",
           "clear_pipeline_cache"]
