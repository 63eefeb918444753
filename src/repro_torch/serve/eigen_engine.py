"""Eigensolver serving engine: shape-bucketed continuous batching for
sequences of dense generalized eigenproblems (``repro.serve.eigen_engine``
in torch).

MD / DFT drivers emit one ``(A, B, s)`` pencil per timestep / SCF
iteration, almost always at a small set of recurring shapes. The engine

  * admits requests into *shape buckets* keyed on
    ``(n, s, which, invert, variant)`` — each bucket has ``slots`` seats,
  * dispatches a full bucket as ONE batched program through
    ``core.batched.solve_batched`` (on the card a bucket's program is
    captured in CUDA graphs once and replayed on every later dispatch),
  * routes oversized requests through the ``variant='auto'`` cost-model
    router in ``core.gsyeig.solve``,
  * retires every request with per-request latency + dispatch metadata in
    ``req.info`` — every retired request carries a uniform ``warnings``
    list and a ``health`` verdict (both always present, JSON-clean),
  * QUARANTINES unhealthy / unconverged lanes of a bucket: the failing
    pencil is retried individually up the degradation ladder
    (``core.gsyeig.solve`` with the engine's ``on_failure`` policy,
    bounded backoff), so one bad pencil cannot poison its bucket-mates;
    a lane that exhausts ``max_retries`` is DEAD-LETTERED with its
    verdict (``engine.dead_letters``) instead of silently dropped.

``run_until_drained(flush=True)`` flushes partially-filled buckets at the
end of a stream, so a bucket never strands requests.

The engine runs on ``device`` (``None`` = the card; without CUDA it
raises unless ``device="cpu"`` is passed). Its random starts come from
one ``torch.Generator`` on that device, whose state advances with every
dispatch. Results come back to the host as numpy arrays, copied out of
the bucket program's buffers. The reference's ``mesh=`` path is not
ported yet (ROADMAP.md §1 item 12c: a served stream that drives several
ranks; ``solve(mesh=)`` itself runs on ``repro_torch.dist``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batched import BATCHED_VARIANTS, solve_batched
from repro_torch.core.gsyeig import solve
from repro_torch.device import resolve_device
from repro_torch.resilience.recovery import SolverError, validate_on_failure

BucketKey = Tuple[int, int, str, bool, str]  # (n, s, which, invert, variant)

#: seed of the engine's default generator (the reference's PRNGKey(1729))
ENGINE_SEED = 1729


def _mesh_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "the engine's mesh path is not ported yet (ROADMAP.md §1 item 12c); "
        "the port serves on one device")


@dataclasses.dataclass
class EigenRequest:
    uid: int
    A: Optional[torch.Tensor]   # released (None) at retirement — a
    B: Optional[torch.Tensor]   # continuously fed engine must not retain
    s: int                      # every operand
    which: str = "smallest"
    invert: bool = False
    variant: str = "TD"
    # filled by the engine:
    evals: Optional[np.ndarray] = None
    X: Optional[np.ndarray] = None
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at


class EigenEngine:
    """Synchronous bucketed batching engine for GSYEIG requests.

    Parameters
    ----------
    slots : seats per shape bucket; a bucket dispatches as soon as it fills.
    bucket_shapes : admissible ``n`` values for batched service; requests at
        any other ``n`` fall through to the direct (router) path. ``None``
        admits every shape below ``max_batched_n`` to batching.
    max_batched_n : problems larger than this always go through the
        ``variant='auto'`` router — batching a handful of huge pencils
        would thrash memory for no dispatch win.
    mesh : the reference's device mesh for the router path; not ported
        (anything but ``None`` raises ``NotImplementedError``).
    generator : the ``torch.Generator`` (on ``device``) every dispatch
        draws its random starts from; ``None`` seeds one with
        ``ENGINE_SEED``.
    max_retries : individual retries a quarantined lane gets before it is
        dead-lettered.
    on_failure : the ladder policy handed to ``core.gsyeig.solve`` for
        quarantine/direct solves; also selects whether UNCONVERGED bucket
        lanes are quarantined (``'recover'``, the default) or retired
        with a warning (``'warn'``). Unhealthy (non-finite) lanes are
        never retired silently under either policy; ``'ignore'`` retires
        them with a warning.
    retry_backoff_s : sleep before quarantine retry k of ``k * backoff``
        seconds (bounded, linear).
    device : where the pencils are solved (``None`` = the card).
    """

    def __init__(self, slots: int = 4,
                 bucket_shapes: Optional[List[int]] = None,
                 variant: str = "TD",
                 max_batched_n: int = 1024,
                 mesh=None,
                 band_width: int = 8,
                 m: int | None = None,
                 max_restarts: int = 200,
                 generator: torch.Generator | None = None,
                 max_retries: int = 2,
                 on_failure: str = "recover",
                 retry_backoff_s: float = 0.0,
                 device=None):
        assert slots >= 1
        assert variant in BATCHED_VARIANTS, variant
        validate_on_failure(on_failure)
        if mesh is not None:
            raise _mesh_not_ported()
        self.device = resolve_device(device)
        self.slots = slots
        self.bucket_shapes = (None if bucket_shapes is None
                              else sorted(set(int(n) for n in bucket_shapes)))
        self.default_variant = variant
        self.max_batched_n = max_batched_n
        self.band_width = band_width
        self.m = m
        self.max_restarts = max_restarts
        self.max_retries = max_retries
        self.on_failure = on_failure
        self.retry_backoff_s = retry_backoff_s
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device)
                          .manual_seed(ENGINE_SEED))
        self.buckets: "OrderedDict[BucketKey, List[EigenRequest]]" = \
            OrderedDict()
        self.direct_queue: List[EigenRequest] = []
        self.done: List[EigenRequest] = []
        self.dead_letters: List[EigenRequest] = []
        self._uid = 0
        self.n_dispatches = 0
        self.n_quarantined = 0

    # -------------------------------------------------------------- admit --
    def _batchable(self, n: int, variant: Optional[str]) -> bool:
        if variant is not None and variant not in BATCHED_VARIANTS:
            return False  # e.g. an explicit 'auto' request
        if n > self.max_batched_n:
            return False
        if self.bucket_shapes is not None and n not in self.bucket_shapes:
            return False
        return True

    def submit(self, A, B, s: int, which: str = "smallest",
               invert: bool = False, variant: Optional[str] = None) -> int:
        """Queue one pencil (numpy arrays or tensors, moved onto the
        engine's device as float64); returns its uid. ``variant=None``
        uses the engine default for batchable requests; ``variant='auto'``
        forces the cost-model router path."""
        A = torch.as_tensor(A, dtype=torch.float64, device=self.device)
        B = torch.as_tensor(B, dtype=torch.float64, device=self.device)
        n = A.shape[0]
        assert A.shape == (n, n) and B.shape == (n, n), (A.shape, B.shape)
        self._uid += 1
        batchable = self._batchable(n, variant)
        v = (variant if variant is not None
             else (self.default_variant if batchable else "auto"))
        req = EigenRequest(uid=self._uid, A=A, B=B, s=int(s), which=which,
                           invert=invert, variant=v,
                           submitted_at=time.perf_counter())
        if batchable:
            bkey: BucketKey = (n, int(s), which, bool(invert), v)
            self.buckets.setdefault(bkey, []).append(req)
        else:
            self.direct_queue.append(req)
        return req.uid

    # ----------------------------------------------------------- dispatch --
    def _dispatch_bucket(self, bkey: BucketKey,
                         reqs: List[EigenRequest]) -> None:
        n, s, which, invert, variant = bkey
        A = torch.stack([r.A for r in reqs])
        B = torch.stack([r.B for r in reqs])
        res = solve_batched(A, B, s, variant=variant, which=which,
                            invert=invert, band_width=self.band_width,
                            m=self.m, max_restarts=self.max_restarts,
                            generator=self.generator, device=self.device)
        del A, B
        self.n_dispatches += 1
        # host copies of the program's (cloned) outputs; the copy waits for
        # the device, so the latency below includes its work
        evals = res.evals.cpu().numpy()
        X = res.X.cpu().numpy()
        conv = res.converged.cpu().numpy()
        healthy = res.healthy.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            lane_healthy = bool(healthy[i])
            lane_conv = bool(conv[i])
            # per-lane quarantine: an unhealthy lane is NEVER retired as a
            # result (its eigenpairs are NaN); an unconverged lane is
            # quarantined under 'recover' so the ladder can escalate it
            if ((not lane_healthy and self.on_failure != "ignore")
                    or (not lane_conv and self.on_failure == "recover")):
                self._quarantine(
                    req, bkey,
                    "nonfinite lane" if not lane_healthy
                    else "unconverged lane")
                continue
            req.evals, req.X = evals[i], X[i]
            req.A = req.B = None  # free the operands; results stay
            req.finished_at = now
            warnings = []
            if not lane_conv:
                warnings.append(
                    f"{variant}: pencil retired at the restart budget "
                    f"(max_restarts={self.max_restarts}) without "
                    f"converging; residuals may exceed tolerance")
            if not lane_healthy:
                warnings.append(
                    f"{variant}: pencil retired with NON-FINITE eigenpairs "
                    f"(on_failure='ignore')")
            req.info = {"path": "batched", "bucket": list(bkey),
                        "batch": len(reqs), "variant": variant,
                        "converged": lane_conv,
                        "cache_hit": res.info["cache_hit"],
                        "compile_s": res.info["compile_s"],
                        "dispatch_wall_s": res.info["wall_s"],
                        "latency_s": req.finished_at - req.submitted_at,
                        "warnings": warnings,
                        "health": {"healthy": lane_healthy,
                                   "stages": {"PIPELINE": lane_healthy},
                                   "first_unhealthy_stage":
                                       None if lane_healthy else "PIPELINE",
                                   "detail": "fused per-lane sentinel of "
                                             "the batched bucket program"},
                        "recovery": []}
            self.done.append(req)

    def _quarantine(self, req: EigenRequest, bkey: BucketKey,
                    why: str) -> None:
        """Retry one failing bucket lane individually up the ladder, with
        bounded linear backoff; dead-letter it when the retries are spent.
        The operands are still attached (they are only freed at
        retirement), so the retry solves exactly the submitted pencil."""
        n, s, which, invert, variant = bkey
        self.n_quarantined += 1
        trail: List[Dict[str, Any]] = [
            {"action": "quarantine", "stage": "bucket", "outcome": why,
             "params": {"bucket": list(bkey)}}]
        last_diag: Dict[str, Any] = {}
        for attempt in range(1, self.max_retries + 1):
            if self.retry_backoff_s > 0:
                time.sleep(self.retry_backoff_s * attempt)
            try:
                res = solve(req.A, req.B, req.s, variant=variant,
                            which=which, invert=invert,
                            band_width=self.band_width, m=self.m,
                            max_restarts=self.max_restarts,
                            generator=self.generator,
                            on_failure=self.on_failure, device=self.device)
            except SolverError as err:
                last_diag = err.diagnosis
                trail.append({"action": "quarantine_retry",
                              "stage": err.diagnosis["stage"],
                              "outcome": "failed",
                              "params": {"attempt": attempt,
                                         "reason": err.diagnosis["reason"]}})
                continue
            self.n_dispatches += 1
            ok = (res.info["health"]["healthy"]
                  and (res.info.get("converged", True)
                       or self.on_failure != "recover"))
            trail.append({"action": "quarantine_retry", "stage": "solve",
                          "outcome": "recovered" if ok else "unconverged",
                          "params": {"attempt": attempt}})
            if ok:
                req.evals = res.evals.cpu().numpy()
                req.X = res.X.cpu().numpy()
                req.A = req.B = None
                req.finished_at = time.perf_counter()
                req.info = {
                    "path": "quarantine", "bucket": list(bkey),
                    "variant": res.info["variant"],
                    "converged": bool(res.info.get("converged", True)),
                    "attempts": attempt,
                    "latency_s": req.finished_at - req.submitted_at,
                    "warnings": list(res.info.get("warnings", [])),
                    "health": res.info["health"],
                    "recovery": trail + list(res.info.get("recovery", []))}
                self.done.append(req)
                return
            last_diag = {"stage": "solve", "reason": "unconverged",
                         "hint": "restart budget exhausted on individual "
                                 "retry", "recovery": []}
        self._dead_letter(req, bkey, trail, last_diag)

    def _dead_letter(self, req: EigenRequest, bkey: Optional[BucketKey],
                     trail: List[Dict[str, Any]],
                     diagnosis: Dict[str, Any]) -> None:
        """Retire a request into ``dead_letters`` with its verdict — the
        no-silent-drop invariant: every submitted uid lands in ``done``
        or here, never nowhere."""
        req.A = req.B = None
        req.finished_at = time.perf_counter()
        req.info = {
            "path": "dead_letter",
            "bucket": None if bkey is None else list(bkey),
            "variant": req.variant,
            "converged": False,
            "latency_s": req.finished_at - req.submitted_at,
            "warnings": [f"request {req.uid} dead-lettered after "
                         f"{self.max_retries} quarantine retries"],
            "health": {"healthy": False,
                       "stages": diagnosis.get("health", {}),
                       "first_unhealthy_stage": diagnosis.get("stage"),
                       "detail": diagnosis.get("reason", "")},
            "recovery": trail,
            "dead_letter": {k: v for k, v in diagnosis.items()
                            if k != "health"}}
        self.dead_letters.append(req)

    def _dispatch_direct(self, req: EigenRequest) -> None:
        try:
            res = solve(req.A, req.B, req.s, variant=req.variant,
                        which=req.which, invert=req.invert,
                        band_width=self.band_width, m=self.m,
                        max_restarts=self.max_restarts,
                        generator=self.generator, on_failure=self.on_failure,
                        device=self.device)
        except SolverError as err:
            self.n_dispatches += 1
            self._dead_letter(
                req, None,
                [{"action": "direct_solve", "stage": err.diagnosis["stage"],
                  "outcome": "failed"}], err.diagnosis)
            return
        self.n_dispatches += 1
        req.evals = res.evals.cpu().numpy()
        req.X = res.X.cpu().numpy()
        req.A = req.B = None  # free the operands; results stay
        req.finished_at = time.perf_counter()
        req.info = {"path": "direct", "variant": res.info["variant"],
                    "stage_times": res.stage_times,
                    "latency_s": req.finished_at - req.submitted_at,
                    "warnings": list(res.info.get("warnings", [])),
                    "health": res.info["health"],
                    "recovery": list(res.info.get("recovery", []))}
        if "router" in res.info:
            req.info["router"] = res.info["router"]
        self.done.append(req)

    # --------------------------------------------------------------- tick --
    def tick(self, flush: bool = False) -> int:
        """Dispatch every full bucket (plus partial buckets when ``flush``)
        and one direct request; returns the number of retired requests."""
        retired0 = len(self.done)
        for bkey in list(self.buckets):
            pending = self.buckets[bkey]
            while len(pending) >= self.slots:
                batch, self.buckets[bkey] = pending[:self.slots], \
                    pending[self.slots:]
                pending = self.buckets[bkey]
                self._dispatch_bucket(bkey, batch)
            if flush and pending:
                self.buckets[bkey] = []
                self._dispatch_bucket(bkey, pending)
            if not self.buckets[bkey]:
                del self.buckets[bkey]
        if self.direct_queue:
            self._dispatch_direct(self.direct_queue.pop(0))
        return len(self.done) - retired0

    def pending(self) -> int:
        return (sum(len(v) for v in self.buckets.values())
                + len(self.direct_queue))

    def run_until_drained(self, flush: bool = True,
                          max_ticks: int = 10_000) -> List[EigenRequest]:
        for _ in range(max_ticks):
            if not self.pending():
                break
            if self.tick(flush=flush) == 0 and not flush:
                # nothing retired and nothing may dispatch without a flush:
                # only partial buckets remain, so stop instead of spinning
                break
        return self.done

    # ------------------------------------------------------------ metrics --
    def summary(self) -> Dict[str, Any]:
        """JSON-clean per-bucket serving metrics for the CLI / benchmark."""
        per_bucket: Dict[str, Dict[str, Any]] = {}
        for req in self.done:
            if req.info.get("path") == "batched":
                n, s, which, invert, variant = req.info["bucket"]
                name = f"n{n}_s{s}_{which}_{variant}" + \
                    ("_inv" if invert else "")
            else:
                name = req.info.get("path", "direct")
            b = per_bucket.setdefault(name, {"count": 0, "latency_s": []})
            b["count"] += 1
            b["latency_s"].append(req.info["latency_s"])
        for b in per_bucket.values():
            lat = b.pop("latency_s")
            b["mean_latency_s"] = float(np.mean(lat))
            b["p90_latency_s"] = float(np.percentile(lat, 90))
        return {"requests": len(self.done) + len(self.dead_letters),
                "dispatches": self.n_dispatches,
                "quarantined": self.n_quarantined,
                "dead_letters": len(self.dead_letters),
                "dead_letter_uids": [r.uid for r in self.dead_letters],
                "buckets": per_bucket}


__all__ = ["EigenEngine", "EigenRequest", "BucketKey", "ENGINE_SEED"]
