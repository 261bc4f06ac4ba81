"""Analysis-as-a-service — one plan, many clients, streaming inputs.

BottleMod's pitch is that re-analysis is nearly free: the model "can be
repeatedly executed online with an updated state from monitoring"
(Sect. 7).  This module turns :class:`~repro_torch.analysis.plan.CompiledWorkflow`
into the front door of an analysis *service* built from three pieces:

* **Plan cache** — :meth:`AnalysisService.compile` keys compiled plans by a
  full workflow fingerprint, and shares ONE fused
  :class:`~repro_torch.sweep.torch_engine.TorchSweepEngine` across all plans
  on one device with the same
  :attr:`~repro_torch.analysis.plan.CompiledWorkflow.level_signature` (what
  the engine specializes on) — structurally identical workflows share one
  engine, and its proven iteration caps, even when their base input
  functions differ.

* **Request coalescing** — concurrent clients submit what-if queries
  (:meth:`AnalysisService.submit` → ``Future[Report]``); a single worker
  drains the queue and stacks everything aimed at one plan into ONE fused
  ``(B,)`` sweep on the service's device.  The lockstep engine is already
  batched, so one fused call amortized over dozens of queued requests is
  the throughput play; each client gets back exactly its rows (its rows of
  the engine results too, so its ``Report``'s curve queries run on the
  card), identical to what a sequential ``plan.sweep`` would have
  returned.  The stacked batch is padded to a power of two (replicating
  the last scenario, rows sliced away) so the engine sees a handful of
  batch widths, each with its own proven iteration cap, instead of one per
  arrival pattern.

* **Online re-analysis** — :meth:`AnalysisService.track` returns an
  :class:`OnlineReanalysis` that owns a prepared
  :class:`~repro_torch.analysis.pack.ScenarioPack` and ingests monitoring deltas
  (measured input rates, :meth:`ProgressMonitor.measured_progress`) through
  the ``ScenarioPack.override`` delta-re-pack primitive — predictions track
  the live run without ever re-preparing.

A predictor wired into a live scheduler must degrade, not crash or hang,
so the serving tier makes four **operational guarantees** (each one
deterministically exercised by :mod:`repro_torch.analysis.faults`):

* **No stranded futures** — the worker loop runs under a supervisor: an
  exception escaping the per-request guards fails every in-flight future
  with a typed :class:`ServiceCrashed` (carrying the cause), restarts the
  worker with a fresh queue drain, and counts the restart
  (``stats.restarts``).  ``close()`` cancels anything still queued and
  aggregate ``submit_mc`` futures resolve even when their chunk futures
  were cancelled mid-flight.
* **Deadlines** — ``submit(..., deadline_s=...)`` requests that expire
  while queued are failed with :class:`DeadlineExceeded` *before* being
  packed into a batch, so one slow client never wastes fused-sweep rows.
* **Backpressure** — the queue is bounded (``max_pending``); the newest
  request is rejected with a typed :class:`Overloaded` instead of growing
  the queue without bound.  Failed queries are retried with bounded
  exponential backoff whose jitter comes from an explicit seed
  (``retry_seed``), never wall-clock randomness.
* **Engine degradation** — fused-sweep rows with NaN output (makespan or
  finish, or an iteration-ladder exhaustion inside the torch engine) are automatically re-run on the pinned numpy
  reference twin; the downgrade lands in ``Report.backends`` (value
  ``"degraded"``) and ``stats.degraded``, with ONE aggregated warning per
  sweep — mirroring the scalar-fallback machinery.  This is designed,
  counted behaviour for garbage rows, not a fallback for a device or
  kernel that failed: such errors raise through the request's future.

The service runs on one device (``device=``, default the CUDA card; it
raises without one unless given ``device="cpu"``).

::

    svc = AnalysisService(workflow)              # compiles + caches the plan
                                                 #   (device="cpu" off-card)
    fut = svc.submit(scenarios.grid({...}))      # coalesced with neighbors
    fut.result().makespans                       # this client's rows only
    svc.submit(scs, deadline_s=0.5)              # fail fast past 500 ms
    live = svc.track(sweep_scenarios([0.5]))
    live.ingest({"dl1.link": measured_rate})     # delta re-pack + re-sweep
    svc.submit_mc(spec, n=10_000).result().p95   # Monte Carlo via the worker
    svc.snapshot()                               # counters incl. restarts,
                                                 #   degraded, shed, expired
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.ppoly import PPoly
from repro_torch.core.workflow import Workflow
from repro_torch.device import resolve_device
from repro_torch.sweep.batch import Scenario
from repro_torch.sweep.engine import BatchProcResult
from repro_torch.sweep.torch_engine import LazyCeilings, TorchSweepEngine

from .artifacts import ArtifactError, ArtifactStore, ArtifactWarning, load_plan
from .faults import FaultPlan
from .optimize import OptimizeReport
from .pack import ScenarioPack
from .plan import CompiledWorkflow, compile_workflow
from .report import Report, concat_reports
from .scenarios import ScenarioSpec
from .uncertainty import (DEFAULT_QUANTILES, MCReport, mc_report_from_sweep,
                          sample_spec)

__all__ = ["AnalysisService", "DeadlineExceeded", "MalformedDeltaWarning",
           "OnlineReanalysis", "Overloaded", "ServiceClosed",
           "ServiceCrashed", "ServiceError", "ServiceStats",
           "workflow_fingerprint"]


# ---------------------------------------------------------------------------
# typed error taxonomy (all RuntimeError, so pre-existing callers who catch
# broadly keep working; see README "Operational guarantees")
# ---------------------------------------------------------------------------

class ServiceError(RuntimeError):
    """Base of every error the serving tier raises on its own behalf.

    Client-input errors (unknown process, out-of-class override, malformed
    spec) keep their original types (usually ``ValueError``) — they describe
    the *request*, not the service.
    """


class ServiceCrashed(ServiceError):
    """The worker died (or the service closed) with this request in flight.

    ``cause`` carries the exception that killed the worker — also chained
    as ``__cause__`` so tracebacks show it.
    """

    def __init__(self, msg: str, cause: BaseException | None = None):
        super().__init__(msg)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


class DeadlineExceeded(ServiceError):
    """The request's ``deadline_s`` passed before its sweep ran."""


class Overloaded(ServiceError):
    """The queue is full (``max_pending``); the newest request was shed."""


class ServiceClosed(ServiceError):
    """The service no longer accepts (or will never run) this request."""


def _fp(fn: PPoly) -> tuple:
    return (fn.starts.tobytes(), fn.coeffs.shape, fn.coeffs.tobytes())


def workflow_fingerprint(workflow: Workflow) -> tuple:
    """Full identity key of a workflow for the service's plan cache.

    Extends the structural level signature with the base *input* functions
    (resource allocations and external data), so a cache hit returns a plan
    whose every query — not just the engine — is interchangeable with
    compiling the workflow afresh.  Sorted by name throughout: two
    workflows built in different insertion orders still collide.
    """
    procs = []
    for n in sorted(workflow.processes):
        p = workflow.processes[n]
        procs.append((
            n, float(p.total_progress),
            tuple((d, _fp(dd.requirement)) for d, dd in sorted(p.data.items())),
            tuple((r, _fp(rd.requirement))
                  for r, rd in sorted(p.resources.items())),
            tuple((o, _fp(fn)) for o, fn in sorted(p.outputs.items()))))
    edges = tuple(sorted((e.src, e.output, e.dst, e.dep)
                         for e in workflow.edges))
    gates = tuple(sorted((n, tuple(g)) for n, g in workflow.gates.items()))
    alloc = tuple((n, tuple((r, _fp(fn)) for r, fn in sorted(d.items())))
                  for n, d in sorted(workflow.resource_alloc.items()))
    data = tuple((n, tuple((d, _fp(fn)) for d, fn in sorted(d2.items())))
                 for n, d2 in sorted(workflow.external_data.items()))
    return (tuple(procs), edges, gates, alloc, data)


@dataclass
class ServiceStats:
    """Counters a running :class:`AnalysisService` maintains (thread-safe
    snapshots via :meth:`AnalysisService.snapshot`)."""

    requests: int = 0          #: client requests accepted
    scenarios: int = 0         #: scenario rows across all requests
    sweeps: int = 0            #: fused sweep calls executed (all kinds)
    coalesced_batches: int = 0  #: sweeps that merged >= 2 requests
    max_coalesced: int = 0     #: most requests merged into one sweep
    max_batch_B: int = 0       #: widest stacked scenario axis (pre-padding)
    plan_hits: int = 0         #: plan-cache hits in compile()
    plan_misses: int = 0       #: plan-cache misses (fresh compiles)
    trace_hits: int = 0        #: engines shared via the level signature
    solo_retries: int = 0      #: requests re-run alone after a batch error
    restarts: int = 0          #: worker crashes caught by the supervisor
    degraded: int = 0          #: rows re-run on the numpy reference twin
    retries: int = 0           #: backoff retries of failed solo requests
    shed: int = 0              #: requests rejected by backpressure
    deadline_expired: int = 0  #: requests failed before packing (deadline)
    #: degradation-reason census (reason -> row count), service-cumulative —
    #: the serving-tier analogue of ``Report.fallback_reasons``
    degrade_reasons: dict = field(default_factory=dict)
    warm_plans: int = 0        #: plans warm-started from the artifact store
    artifacts_written: int = 0  #: artifact-store writes that completed
    artifact_errors: int = 0   #: artifacts rejected or failed writes
    recovered_tracks: int = 0  #: OnlineReanalysis sessions rebuilt via recover()
    replayed_deltas: int = 0   #: journal delta records replayed by recover()
    quarantined: int = 0       #: malformed monitoring deltas dropped by ingest
    #: quarantine-reason census (reason -> delta count), service-cumulative
    quarantine_reasons: dict = field(default_factory=dict)
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=4096))

    def latency_quantiles(self, qs: Sequence[float] = (0.5, 0.99)
                          ) -> "tuple[float | None, ...]":
        """Request latencies (submit -> result) at the given quantiles.

        An empty window (no completed requests yet) reports ``None`` per
        quantile — explicit "no data", instead of NaNs that poison
        downstream arithmetic and comparisons silently.
        """
        if not self.latencies_s:
            return tuple(None for _ in qs)
        arr = np.asarray(self.latencies_s)
        return tuple(float(np.quantile(arr, q)) for q in qs)

    def count_degraded(self, rows: int, reason: str) -> None:
        self.degraded += rows
        self.degrade_reasons[reason] = \
            self.degrade_reasons.get(reason, 0) + rows

    def count_quarantined(self, reason: str) -> None:
        self.quarantined += 1
        self.quarantine_reasons[reason] = \
            self.quarantine_reasons.get(reason, 0) + 1

    def snapshot(self) -> dict:
        """A point-in-time dict of every counter (caller holds the service
        lock), including the top degradation reasons in
        ``Report.summary()`` census style."""
        p50, p99 = self.latency_quantiles()
        top = sorted(self.degrade_reasons.items(), key=lambda kv: -kv[1])[:3]
        return {
            "requests": self.requests,
            "scenarios": self.scenarios,
            "sweeps": self.sweeps,
            "coalesced_batches": self.coalesced_batches,
            "max_coalesced": self.max_coalesced,
            "max_batch_B": self.max_batch_B,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "trace_hits": self.trace_hits,
            "solo_retries": self.solo_retries,
            "restarts": self.restarts,
            "degraded": self.degraded,
            "retries": self.retries,
            "shed": self.shed,
            "deadline_expired": self.deadline_expired,
            "top_degrade_reasons": top,
            "warm_plans": self.warm_plans,
            "artifacts_written": self.artifacts_written,
            "artifact_errors": self.artifact_errors,
            "recovered_tracks": self.recovered_tracks,
            "replayed_deltas": self.replayed_deltas,
            "quarantined": self.quarantined,
            "top_quarantine_reasons": sorted(
                self.quarantine_reasons.items(), key=lambda kv: -kv[1])[:3],
            "latency_p50_s": p50, "latency_p99_s": p99,
        }


@dataclass
class _Request:
    plan: CompiledWorkflow
    future: Future
    t_submit: float
    scenarios: list | None = None      # coalescable what-if query
    pack: ScenarioPack | None = None   # pre-packed (online re-analysis)
    optimize: dict | None = None       # plan.optimize kwargs (solo request)
    deadline: float | None = None      # absolute perf_counter() deadline
    retries: int = 0                   # backoff retries already spent

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


def _pow2_bucket(b: int) -> int:
    return 1 << (b - 1).bit_length() if b > 1 else 1


def _proc_rows(r: BatchProcResult, idx: np.ndarray) -> BatchProcResult:
    """Rows ``idx`` of one process's engine result; the ceilings stay
    lazy and are cut from the parent's when first read."""
    parent = r.ceilings
    return BatchProcResult(
        name=r.name, p_end=r.p_end, t_start=r.t_start[idx],
        finish=r.finish[idx], progress=r.progress.row_subset(idx),
        ceilings=LazyCeilings(lambda: [c.row_subset(idx) for c in parent]),
        factor_kinds=list(r.factor_kinds), factor_names=list(r.factor_names),
        share_seconds=r.share_seconds[idx], iterations=r.iterations)


def _client_rows(rep: Report, lo: int, hi: int) -> Report:
    """A coalesced client's rows ``lo:hi`` of the fused sweep's Report.

    Unlike a plain :meth:`Report.subset`, the client's Report keeps its rows
    of the engine results when the whole sweep ran on the fused engine, so
    its curve queries (``sample_progress``, ``data_ceiling``,
    ``kernel_finish_times``) run on the device as on ``plan.sweep``'s."""
    sub = rep.subset(range(lo, hi))
    if rep.proc_results is not None:
        idx = np.arange(lo, hi)
        sub.proc_results = {n: _proc_rows(r, idx)
                            for n, r in rep.proc_results.items()}
    return sub


class AnalysisService:
    """Coalescing BottleMod analysis server (see module docstring).

    One daemon worker thread owns every fused sweep, so client threads never
    contend on the engines or the device.  ``autostart=False`` leaves the worker
    paused — requests queue up and the first drain after :meth:`start`
    coalesces them all, which load tests and benchmarks use for a
    deterministic single-batch run.

    ``linger_s > 0`` makes the worker wait that long after the first
    request of a drain before sweeping, trading latency for wider batches;
    the default 0 relies on natural batching (requests arriving while a
    sweep runs coalesce into the next one).

    Fault-tolerance knobs:

    * ``max_pending`` — queue bound; the newest request beyond it is shed
      with :class:`Overloaded` (``None`` disables admission control),
    * ``max_retries`` / ``retry_backoff_s`` / ``retry_seed`` — bounded
      exponential-backoff retries of failed solo requests (jitter drawn
      from the seeded generator, so retry timing is reproducible),
    * ``faults`` — a :class:`~repro_torch.analysis.faults.FaultPlan` test hook
      injecting deterministic failures into the worker loop.

    Durability: ``store`` (an
    :class:`~repro_torch.analysis.artifacts.ArtifactStore` or a directory path)
    makes compiled state survive the process.  Plans are persisted as
    artifacts on first compile (and re-persisted when their engine proves
    new iteration caps), the plan cache warm-starts from disk before the
    worker runs, and :meth:`track` sessions given a ``track_id`` journal
    every ingested delta so :meth:`recover` can rebuild them bit-identically
    after a crash.

    ``device`` is where every plan the service compiles lives and sweeps:
    ``None`` is the CUDA card (raises without one), ``"cpu"`` the plain
    CPU versions.
    """

    def __init__(self, workflow: Workflow | CompiledWorkflow | None = None, *,
                 backend: str = "auto", max_batch: int = 4096,
                 linger_s: float = 0.0, pad_pow2: bool = True,
                 autostart: bool = True, max_pending: int | None = 10_000,
                 max_retries: int = 2, retry_backoff_s: float = 0.002,
                 retry_seed: int = 0, faults: FaultPlan | None = None,
                 store: "ArtifactStore | str | Path | None" = None,
                 device: Any = None):
        self.device = resolve_device(device)
        self.backend = backend
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_s)
        self.pad_pow2 = bool(pad_pow2)
        self.max_pending = None if max_pending is None else int(max_pending)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._retry_rng = np.random.default_rng(retry_seed)
        self._faults = faults
        if store is not None and not isinstance(store, ArtifactStore):
            store = ArtifactStore(store)
        if store is not None and store.faults is None:
            store.faults = faults
        self.store: ArtifactStore | None = store
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._persist_lock = threading.Lock()
        #: fingerprint -> proven caps at the last successful artifact
        #: write, so persists are idempotent until the engine proves more
        self._persisted: dict[tuple, tuple] = {}
        self._plan_keys: dict[int, tuple] = {}  # id(plan) -> fingerprint
        self._warmed = False
        self._queue: list[_Request] = []
        self._inflight: list[_Request] = []   # worker-thread only
        self._plans: dict[tuple, CompiledWorkflow] = {}
        self._engines: dict[tuple, Any] = {}
        self._closed = False
        self._thread: threading.Thread | None = None
        if store is not None:
            self._warm_start()
        self._default_plan: CompiledWorkflow | None = (
            self.compile(workflow) if workflow is not None else None)
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AnalysisService":
        """Start the worker (idempotent); queued requests drain immediately.

        With a ``store``, the plan cache is warm-started from disk before
        the worker serves anything (also idempotent — construction already
        warmed it)."""
        self._warm_start()
        with self._lock:
            if self._closed:
                raise ServiceClosed("AnalysisService is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="analysis-service", daemon=True)
                self._thread.start()
        return self

    def _warm_start(self) -> None:
        """Load every artifact in the store into the plan cache (once).

        A rejected artifact (corrupt, stale format, wrong fingerprint) is
        skipped with one :class:`ArtifactWarning` and counted — the plan
        simply cold-compiles on first use.  Never raises.
        """
        if self.store is None or self._warmed:
            return
        self._warmed = True
        for path in self.store.scan():
            try:
                plan = load_plan(path, device=self.device)
            except ArtifactError as e:
                warnings.warn(
                    f"artifact store: skipping {path.name}: {e} (the plan "
                    "will cold-compile on first use)", ArtifactWarning,
                    stacklevel=2)
                with self._lock:
                    self.stats.artifact_errors += 1
                continue
            key = workflow_fingerprint(plan.workflow)
            with self._lock:
                if key in self._plans:
                    continue
                self._adopt(plan)
                self._plans[key] = plan
                self._plan_keys[id(plan)] = key
                self.stats.warm_plans += 1
            # record the as-loaded census: a warm plan re-persists only
            # when its engine later proves NEW caps
            self._persisted[key] = self._engine_census(plan)

    def close(self, drain: bool = True) -> None:
        """Stop accepting requests, join the worker, strand NO future.

        ``drain=True`` (default) lets the worker finish everything queued;
        ``drain=False`` cancels queued requests immediately (their futures
        report cancelled; aggregate ``submit_mc`` futures resolve with a
        typed :class:`ServiceCrashed` — see :meth:`submit_mc`).  Either way
        every future is resolved by the time ``close`` returns: anything
        still queued afterwards (e.g. the worker was never started) is
        cancelled too.
        """
        with self._wake:
            if self._closed:
                return
            self._closed = True
            dropped: list[_Request] = []
            if not drain:
                dropped, self._queue = self._queue, []
            self._wake.notify_all()
            thread = self._thread
        self._cancel_requests(dropped)
        if thread is not None:
            thread.join()
        with self._wake:
            leftovers, self._queue = self._queue, []
        self._cancel_requests(leftovers)

    @staticmethod
    def _cancel_requests(reqs: list[_Request]) -> None:
        for req in reqs:
            if not req.future.done() and not req.future.cancel():
                req.future.set_exception(ServiceClosed(
                    "AnalysisService closed before the request ran"))

    def __enter__(self) -> "AnalysisService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- plan cache ---------------------------------------------------------
    def compile(self, workflow: Workflow | CompiledWorkflow
                ) -> CompiledWorkflow:
        """Compile ``workflow`` through the plan cache.

        Identical workflows (same fingerprint) return the SAME cached plan;
        structurally identical ones (same level signature, different base
        inputs) get their own plan but share one fused engine, i.e. one
        proven iteration cap per ``(B, shards, ramps)``.  Plans compile on
        the service's device.
        """
        if isinstance(workflow, CompiledWorkflow):
            with self._lock:
                self._adopt(workflow)
            if self.store is not None:
                key = self._key_of(workflow)
                with self._lock:
                    self._plans.setdefault(key, workflow)
                self._persist(key, workflow)
            return workflow
        key = workflow_fingerprint(workflow)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.stats.plan_hits += 1
                return plan
        plan = compile_workflow(workflow, device=self.device)  # unlocked
        with self._lock:
            existing = self._plans.get(key)
            if existing is not None:
                self.stats.plan_hits += 1
                return existing
            self.stats.plan_misses += 1
            self._adopt(plan)
            self._plans[key] = plan
            self._plan_keys[id(plan)] = key
        self._persist(key, plan)
        return plan

    def _adopt(self, plan: CompiledWorkflow) -> None:
        """Share one TorchSweepEngine per level signature and device
        (caller holds lock)."""
        key = (plan.level_signature, str(plan.device))
        engine = self._engines.get(key)
        if engine is None:
            if plan._torch_engine is None:
                plan._torch_engine = TorchSweepEngine(plan)
            self._engines[key] = plan._torch_engine
        elif plan._torch_engine is None:
            plan._torch_engine = engine
            self.stats.trace_hits += 1
        # plan already carries its own warm engine: keep it

    # -- durable store ------------------------------------------------------
    def _key_of(self, plan: CompiledWorkflow) -> tuple:
        key = self._plan_keys.get(id(plan))
        if key is None:
            key = workflow_fingerprint(plan.workflow)
            self._plan_keys[id(plan)] = key
        return key

    @staticmethod
    def _engine_census(plan: CompiledWorkflow) -> tuple:
        """What the plan's engine has learned (its proven caps) —
        persisting is a no-op while this is unchanged."""
        eng = plan._torch_engine
        if eng is None:
            return ()
        return tuple(eng.proven_caps_rows())

    def _persist(self, key: tuple, plan: CompiledWorkflow) -> None:
        """(Re-)write the plan's artifact if its engine learned anything new
        since the last write.  A failed write warns + counts, never raises
        — durability degrades, serving does not."""
        if self.store is None:
            return
        with self._persist_lock:
            census = self._engine_census(plan)
            if self._persisted.get(key) == census:
                return
            try:
                self.store.put(plan)
            except Exception as e:  # noqa: BLE001 — disk trouble must not
                warnings.warn(       # take down the serving path
                    f"artifact store: failed to persist plan: {e!r}",
                    ArtifactWarning, stacklevel=2)
                with self._lock:
                    self.stats.artifact_errors += 1
                return
            self._persisted[key] = census
        with self._lock:
            self.stats.artifacts_written += 1

    def _persist_batch_plans(self, batch: list["_Request"]) -> None:
        """After a drain: re-persist any plan whose engine proved or
        ratcheted an iteration cap during this batch."""
        if self.store is None:
            return
        seen: set[int] = set()
        for req in batch:
            if id(req.plan) in seen:
                continue
            seen.add(id(req.plan))
            self._persist(self._key_of(req.plan), req.plan)

    def _resolve_plan(self, plan: CompiledWorkflow | None,
                      workflow: Workflow | None) -> CompiledWorkflow:
        if plan is not None:
            return self.compile(plan)
        if workflow is not None:
            return self.compile(workflow)
        if self._default_plan is None:
            raise ValueError(
                "no plan: pass plan=/workflow= or construct the service "
                "with a default workflow")
        return self._default_plan

    # -- queries ------------------------------------------------------------
    def submit(self, scenarios: Any, *, plan: CompiledWorkflow | None = None,
               workflow: Workflow | None = None,
               deadline_s: float | None = None) -> "Future[Report]":
        """Enqueue a what-if query; resolves to this client's :class:`Report`.

        ``scenarios`` is a single :class:`Scenario`/:class:`ScenarioSpec` or
        a sequence of them.  Everything queued for the same plan when the
        worker next drains is stacked into ONE fused sweep.

        ``deadline_s`` bounds the request's total time in the service: if
        it is still queued when the deadline passes, it fails with
        :class:`DeadlineExceeded` *without* being packed into a batch.
        Raises :class:`Overloaded` if the queue is at ``max_pending``.
        """
        plan = self._resolve_plan(plan, workflow)
        if isinstance(scenarios, (Scenario, ScenarioSpec)):
            scenarios = [scenarios]
        scs = list(scenarios)
        if not scs:
            raise ValueError("submit() needs at least one scenario")
        if len(scs) > self.max_batch:
            raise ValueError(
                f"request of {len(scs)} scenarios exceeds max_batch="
                f"{self.max_batch}")
        return self._enqueue_many([self._make_request(
            plan, scenarios=scs, deadline_s=deadline_s)])[0]

    def submit_pack(self, pack: ScenarioPack, *,
                    deadline_s: float | None = None) -> "Future[Report]":
        """Enqueue a prepared pack (online re-analysis path).

        Packs carry their own solver-ready arrays, so they run as their own
        fused call on the worker — serialized with, but not merged into,
        the coalesced what-if batches.
        """
        return self._enqueue_many([self._make_request(
            pack.plan, pack=pack, deadline_s=deadline_s)])[0]

    def _make_request(self, plan: CompiledWorkflow, *,
                      scenarios: list | None = None,
                      pack: ScenarioPack | None = None,
                      optimize: dict | None = None,
                      deadline_s: float | None = None) -> _Request:
        now = time.perf_counter()
        return _Request(plan=plan, future=Future(), t_submit=now,
                        scenarios=scenarios, pack=pack, optimize=optimize,
                        deadline=(None if deadline_s is None
                                  else now + float(deadline_s)))

    def _enqueue_many(self, reqs: list[_Request]) -> list[Future]:
        """Admit a group of requests atomically (all queued or none)."""
        with self._wake:
            if self._closed:
                raise ServiceClosed("AnalysisService is closed")
            if self.max_pending is not None and \
                    len(self._queue) + len(reqs) > self.max_pending:
                self.stats.shed += len(reqs)
                raise Overloaded(
                    f"{len(self._queue)} request(s) already pending "
                    f"(max_pending={self.max_pending}); request shed — "
                    "retry with backoff or raise max_pending")
            for req in reqs:
                self.stats.requests += 1
                if self._faults is not None and req.scenarios is not None:
                    req.scenarios = self._faults.corrupt_request(
                        self.stats.requests, req.scenarios)
                self._queue.append(req)
                self.stats.scenarios += (
                    len(req.scenarios) if req.scenarios is not None
                    else req.pack.B if req.pack is not None else 1)
            self._wake.notify()
        return [req.future for req in reqs]

    def query(self, scenarios: Any, *, plan: CompiledWorkflow | None = None,
              workflow: Workflow | None = None,
              deadline_s: float | None = None,
              timeout: float | None = None) -> Report:
        """Blocking :meth:`submit`."""
        return self.submit(scenarios, plan=plan, workflow=workflow,
                           deadline_s=deadline_s).result(timeout)

    def submit_optimize(self, objective: Any = "makespan", space: Any = None,
                        *, constraints: Any = None, starts: int = 1,
                        rungs: int = 8, max_iters: int = 25,
                        max_evals: int | None = None, ftol: float = 1e-9,
                        seed: int | None = None,
                        plan: CompiledWorkflow | None = None,
                        workflow: Workflow | None = None,
                        deadline_s: float | None = None,
                        ) -> "Future[OptimizeReport]":
        """Enqueue a gradient allocation search; resolves to the
        :class:`~repro_torch.analysis.optimize.OptimizeReport` that a local
        ``plan.optimize`` call with the same arguments returns — the search
        is deterministic (no wall-clock or unseeded randomness), so results
        are IDENTICAL either way; the service adds sharing of the worker,
        plan cache, and engines.

        Runs as a solo request on the worker (optimizer steps are already
        internally batched fused sweeps — there is nothing to coalesce
        with).  ``deadline_s`` bounds queue time AND search time: the
        remaining budget is handed to the optimizer, which aborts with
        :class:`DeadlineExceeded` mid-search when it runs out.
        """
        plan = self._resolve_plan(plan, workflow)
        kw = dict(objective=objective, space=space, constraints=constraints,
                  starts=starts, rungs=rungs, max_iters=max_iters,
                  max_evals=max_evals, ftol=ftol, seed=seed)
        return self._enqueue_many([self._make_request(
            plan, optimize=kw, deadline_s=deadline_s)])[0]

    def query_optimize(self, objective: Any = "makespan", space: Any = None,
                       *, constraints: Any = None, starts: int = 1,
                       rungs: int = 8, max_iters: int = 25,
                       max_evals: int | None = None, ftol: float = 1e-9,
                       seed: int | None = None,
                       plan: CompiledWorkflow | None = None,
                       workflow: Workflow | None = None,
                       deadline_s: float | None = None,
                       timeout: float | None = None) -> "OptimizeReport":
        """Blocking :meth:`submit_optimize`."""
        return self.submit_optimize(
            objective, space, constraints=constraints, starts=starts,
            rungs=rungs, max_iters=max_iters, max_evals=max_evals, ftol=ftol,
            seed=seed, plan=plan, workflow=workflow,
            deadline_s=deadline_s).result(timeout)

    def submit_mc(self, spec: Any, n: int = 10_000, *, seed: int = 0,
                  plan: CompiledWorkflow | None = None,
                  workflow: Workflow | None = None,
                  deadline_s: float | None = None,
                  quantile_levels: Sequence[float] = DEFAULT_QUANTILES,
                  max_batch: int | None = None,
                  ) -> "Future[MCReport]":
        """Enqueue a Monte Carlo distribution query; resolves to an
        :class:`~repro_torch.analysis.uncertainty.MCReport`.

        The ``n`` draws are sampled host-side immediately (same deterministic
        sampler as ``plan.mc`` — identical ``seed`` gives bit-identical
        scenarios) and enqueued in ``max_batch``-sized chunks as ordinary
        coalescable requests, so probabilistic queries ride the same worker,
        plan cache, and fused engine as the what-if traffic — and batch
        WITH it.  Chunk reports are stitched back together with
        :func:`~repro_torch.analysis.report.concat_reports` when the last chunk
        lands.  The chunks are admitted atomically (one :class:`Overloaded`
        rejects the whole query), and the aggregate future ALWAYS resolves:
        a chunk that fails, is cancelled by :meth:`close`, or dies in a
        worker crash fails the aggregate with the typed cause.

        ``max_batch`` overrides the service-wide chunk width for this one
        query (``None`` keeps the service default).
        """
        plan = self._resolve_plan(plan, workflow)
        chunk_w = self.max_batch if max_batch is None else int(max_batch)
        if chunk_w < 1:
            raise ValueError(f"max_batch must be >= 1, got {chunk_w}")
        samples = sample_spec(plan, spec, n, seed=seed)
        reqs = [self._make_request(
                    plan, scenarios=samples.scenarios[lo:lo + chunk_w],
                    deadline_s=deadline_s)
                for lo in range(0, n, chunk_w)]
        chunk_futs = self._enqueue_many(reqs)
        out: "Future[MCReport]" = Future()
        state = {"pending": len(chunk_futs)}
        state_lock = threading.Lock()

        def _on_done(f: Future) -> None:
            with state_lock:
                if out.done():
                    return
                if f.cancelled():
                    # the close/crash path cancels queued chunks; the
                    # aggregate must still resolve (typed, with the cause)
                    out.set_exception(ServiceCrashed(
                        "Monte Carlo chunk cancelled: the service closed "
                        "or crashed before all draw chunks ran"))
                    return
                exc = f.exception()
                if exc is not None:
                    out.set_exception(exc)
                    return
                state["pending"] -= 1
                if state["pending"]:
                    return
            try:
                rep = concat_reports(ft.result() for ft in chunk_futs)
                out.set_result(mc_report_from_sweep(
                    rep, samples, quantile_levels))
            except Exception as e:  # noqa: BLE001 — surface via the future
                out.set_exception(e)

        for ft in chunk_futs:
            ft.add_done_callback(_on_done)
        return out

    def query_mc(self, spec: Any, n: int = 10_000, *, seed: int = 0,
                 plan: CompiledWorkflow | None = None,
                 workflow: Workflow | None = None,
                 deadline_s: float | None = None,
                 quantile_levels: Sequence[float] = DEFAULT_QUANTILES,
                 max_batch: int | None = None,
                 timeout: float | None = None) -> MCReport:
        """Blocking :meth:`submit_mc` (same keywords, plus ``timeout``)."""
        return self.submit_mc(spec, n, seed=seed, plan=plan,
                              workflow=workflow, deadline_s=deadline_s,
                              quantile_levels=quantile_levels,
                              max_batch=max_batch).result(timeout)

    def track(self, scenarios: Any, *, plan: CompiledWorkflow | None = None,
              workflow: Workflow | None = None,
              track_id: str | None = None) -> "OnlineReanalysis":
        """An :class:`OnlineReanalysis` session routed through this service.

        With ``track_id`` (needs a ``store``) every ingested delta is
        journaled write-ahead, making the session crash-recoverable:
        :meth:`recover` rebuilds its live state bit-identically after a
        process death.  Reusing a ``track_id`` resumes its journal.
        """
        plan = self._resolve_plan(plan, workflow)
        journal = None
        if track_id is not None:
            from .journal import Journal

            journal = Journal(self._journal_path(track_id),
                              faults=self._faults)
        return OnlineReanalysis(plan, scenarios, service=self,
                                journal=journal, track_id=track_id)

    def _journal_path(self, track_id: str) -> Path:
        if self.store is None:
            raise ValueError(
                "track_id journaling needs a persistent store: construct "
                "the service with AnalysisService(store=<dir>)")
        tid = str(track_id)
        if not tid or tid in (".", "..") or any(c in tid for c in "/\\\0"):
            raise ValueError(f"invalid track_id {track_id!r}")
        return self.store.journal_dir() / (tid + ".journal")

    def recover(self, track_id: str) -> "OnlineReanalysis":
        """Rebuild a journaled :class:`OnlineReanalysis` session after a
        crash — bit-identical live state, no sweeping.

        Reads the track's journal (truncating any torn tail with a
        :class:`~repro_torch.analysis.journal.JournalWarning`), recompiles the
        genesis workflow through the plan cache (a warm-started artifact
        makes this a cache hit), and replays every intact delta through the
        same ``ScenarioPack.override`` path the live ingests took.  The
        returned session appends to the same journal, so recovery composes.
        Call :meth:`OnlineReanalysis.refresh` for a fresh report.
        """
        from .artifacts import fingerprint_digest
        from .journal import Journal, JournalError, recover_journal

        path = self._journal_path(track_id)
        records, _torn = recover_journal(path)
        if not records or not (isinstance(records[0], dict)
                               and records[0].get("kind") == "genesis"):
            raise JournalError(
                f"journal for track {track_id!r} has no intact genesis "
                "record; the session cannot be recovered")
        genesis = records[0]
        if genesis.get("fingerprint") != fingerprint_digest(
                genesis["workflow"]):
            raise JournalError(
                f"journal for track {track_id!r}: genesis fingerprint "
                "mismatch (journal does not match its workflow)")
        plan = self.compile(genesis["workflow"])
        live = OnlineReanalysis(plan, list(genesis["scenarios"]),
                                service=self,
                                journal=Journal(path, faults=self._faults),
                                track_id=track_id)
        replayed = 0
        for rec in records[1:]:
            if isinstance(rec, dict) and rec.get("kind") == "delta":
                live.pack = live.pack.override(rec["deltas"])
                replayed += 1
        live.updates = replayed
        with self._lock:
            self.stats.recovered_tracks += 1
            self.stats.replayed_deltas += replayed
        return live

    def snapshot(self) -> dict:
        """A consistent point-in-time copy of the service counters, plus
        the warm/cold engine census: ``warm_hits`` (solves whose iteration
        cap came from an artifact's proven-cap rows) and ``cold_traces``.
        The port has no traces to count: ``cold_traces`` counts its cold
        solves, every solve whose cap was the engine's default or one this
        process proved itself."""
        with self._lock:
            snap = self.stats.snapshot()
            engines = list(self._engines.values())
        snap["warm_hits"] = sum(e.warm_hits for e in engines)
        snap["cold_traces"] = sum(e.cold_solves for e in engines)
        return snap

    # -- worker -------------------------------------------------------------
    def _worker(self) -> None:
        """Supervisor: restart the drain loop whenever it dies.

        Everything expected runs inside :meth:`_run_batch`'s per-request
        guards; anything that still escapes (a bug, a
        ``FaultPlan.kill_worker_at`` injection) would otherwise strand every
        in-flight future forever.  The supervisor fails them with a typed
        :class:`ServiceCrashed` carrying the cause, counts the restart, and
        re-enters the loop with a fresh drain — queued requests and later
        submissions keep being served.
        """
        while True:
            try:
                self._drain_loop()
                return  # closed and drained: clean exit
            except BaseException as e:  # noqa: BLE001 — supervision boundary
                crashed, self._inflight = self._inflight, []
                err = ServiceCrashed(
                    f"analysis worker crashed: {e!r} (supervisor restarted "
                    "the worker; resubmit if needed)", cause=e)
                for req in crashed:
                    if not req.future.done():
                        req.future.set_exception(err)
                with self._lock:
                    self.stats.restarts += 1

    def _drain_loop(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._closed:
                    self._wake.wait()
                if not self._queue:
                    return  # closed and drained
                batch = self._queue
                self._queue = []
            if self.linger_s > 0.0 and not self._closed:
                # widen the batch: let stragglers of a burst arrive
                time.sleep(self.linger_s)
                with self._wake:
                    batch.extend(self._queue)
                    self._queue = []
            self._inflight = batch  # supervisor fails these on a crash
            self._run_batch(batch)
            self._inflight = []

    def _run_batch(self, batch: list[_Request]) -> None:
        if self._faults is not None:
            self._faults.on_drain()  # may delay the drain or kill the worker
        # deadline gate BEFORE packing: expired requests must not waste
        # fused-sweep rows (their neighbors' batch shrinks instead)
        now = time.perf_counter()
        live: list[_Request] = []
        for req in batch:
            if req.expired(now):
                self._expire(req)
            else:
                live.append(req)
        groups: dict[int, list[_Request]] = {}
        order: list[int] = []
        for req in live:
            key = id(req.plan)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(req)
        for key in order:
            reqs = groups[key]
            plan = reqs[0].plan
            packs = [r for r in reqs if r.pack is not None]
            opts = [r for r in reqs if r.optimize is not None]
            coalescable = [r for r in reqs if r.scenarios is not None]
            for req in opts:
                self._run_optimize(plan, req)
            for req in packs:
                self._sweep_pack(plan, req)
            chunk: list[_Request] = []
            width = 0
            for req in coalescable:
                if chunk and width + len(req.scenarios) > self.max_batch:
                    self._sweep_chunk(plan, chunk)
                    chunk, width = [], 0
                chunk.append(req)
                width += len(req.scenarios)
            if chunk:
                self._sweep_chunk(plan, chunk)
        self._persist_batch_plans(live)

    def _expire(self, req: _Request) -> None:
        with self._lock:
            self.stats.deadline_expired += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded(
                f"request deadline passed after "
                f"{time.perf_counter() - req.t_submit:.3f}s in the service "
                "(expired before its sweep ran)"))

    def _do_sweep(self, plan: CompiledWorkflow,
                  pack: ScenarioPack, B_real: int) -> Report:
        """One guarded fused sweep + fault hooks + the degradation guard."""
        if self._faults is not None:
            self._faults.before_sweep()
        rep = plan.sweep(pack, backend=self.backend)
        with self._lock:
            self.stats.sweeps += 1
        if self._faults is not None:
            rep = self._faults.after_sweep(rep)
        return self._degrade_guard(plan, pack, rep, B_real)

    def _degrade_guard(self, plan: CompiledWorkflow, pack: ScenarioPack,
                       rep: Report, B_real: int) -> Report:
        """Non-finite guard on fused output: re-run garbage rows on the
        numpy reference twin (see module docstring, "Engine degradation").

        Only rows the fused ``torch`` engine produced are guarded — the
        numpy engine IS the reference, and loop rows already ran the exact
        scalar solver.  The garbage test is NaN, not any-non-finite: an
        ``inf`` makespan is a legitimate model output ("this scenario never
        finishes"), bit-matched by the reference twin, so degrading it
        would re-run and warn on every re-sweep of a healthy pack.  An
        in-sweep engine decline (iteration-ladder exhaustion already re-ran
        the whole batched partition on numpy inside ``plan.sweep``) is
        recorded the same way via ``Report.engine_fallback``.
        """
        reasons: dict[str, int] = {}
        relabel: list[int] = []
        if rep.engine_fallback is not None:
            for i in range(B_real):
                if rep.backends[i] == "batched":
                    relabel.append(i)
            if relabel:
                reasons[rep.engine_fallback] = len(relabel)
        bad = [i for i in rep.nan_indices
               if i < B_real and rep.backends[i] == "torch"]
        if not bad and not relabel:
            return rep
        for i in relabel:
            rep.backends[i] = "degraded"
        out = rep
        if bad:
            for i in bad:
                why = ("NaN makespan from fused engine"
                       if np.isnan(float(rep.makespans[i]))
                       else "NaN finish time from fused engine")
                reasons[why] = reasons.get(why, 0) + 1
            clean = plan.sweep(pack.subset(bad), backend="numpy")
            clean.backends = ["degraded"] * len(bad)
            bad_set = set(bad)
            keep = [i for i in range(B_real) if i not in bad_set]
            merged = (concat_reports([rep.subset(keep), clean]) if keep
                      else clean)
            # restore original row order: keep-rows first, then bad-rows
            pos = {i: j for j, i in enumerate(keep)}
            pos.update({i: len(keep) + j for j, i in enumerate(bad)})
            out = merged.subset([pos[i] for i in range(B_real)])
        n_rows = sum(reasons.values())
        with self._lock:
            for why, c in reasons.items():
                self.stats.count_degraded(c, why)
        top = ", ".join(f"{why} (x{c})" for why, c in
                        sorted(reasons.items(), key=lambda kv: -kv[1]))
        warnings.warn(
            f"analysis service: {n_rows}/{B_real} row(s) degraded to the "
            f"numpy reference engine [{top}]; see Report.backends "
            "('degraded') and ServiceStats.degrade_reasons", UserWarning,
            stacklevel=2)
        return out

    def _run_optimize(self, plan: CompiledWorkflow, req: _Request) -> None:
        """Run one gradient search inline on the worker.

        The payload is the verbatim ``plan.optimize`` kwargs, so the result
        is identical to a local call; only the deadline is service-owned —
        the request's remaining budget becomes the optimizer's
        ``deadline_s``, and an optimizer timeout surfaces as the same typed
        :class:`DeadlineExceeded` the queue gate raises.
        """
        kw = dict(req.optimize)
        objective, space = kw.pop("objective"), kw.pop("space")
        if req.deadline is not None:
            kw["deadline_s"] = max(req.deadline - time.perf_counter(), 0.0)
        try:
            rep = plan.optimize(objective, space, **kw)
        except TimeoutError as e:
            with self._lock:
                self.stats.deadline_expired += 1
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(str(e)))
            return
        except Exception as e:  # noqa: BLE001 — fail THIS request only
            self._retry_or_fail(plan, req, e,
                                lambda: self._run_optimize(plan, req))
            return
        self._finish(req, rep)

    def _sweep_pack(self, plan: CompiledWorkflow, req: _Request) -> None:
        try:
            rep = self._do_sweep(plan, req.pack, req.pack.B)
        except Exception as e:  # noqa: BLE001 — fail THIS request only
            self._retry_or_fail(plan, req, e,
                                lambda: self._sweep_pack(plan, req))
            return
        self._finish(req, rep)

    def _sweep_chunk(self, plan: CompiledWorkflow,
                     chunk: list[_Request]) -> None:
        scs = [sc for req in chunk for sc in req.scenarios]
        B = len(scs)
        pad = 0
        if self.pad_pow2:
            # bucket the stacked axis so the engine proves O(log max_batch)
            # caps instead of one per arrival pattern; padding rows
            # replicate the last scenario and are never handed to a client
            pad = min(_pow2_bucket(B), self.max_batch) - B
        try:
            rep = self._do_sweep(plan, plan.prepare(scs + [scs[-1]] * pad), B)
        except Exception as e:  # noqa: BLE001
            if len(chunk) == 1:
                req = chunk[0]
                self._retry_or_fail(plan, req, e,
                                    lambda: self._sweep_chunk(plan, [req]))
                return
            # a poisoned query must not fail its batch neighbors: re-run
            # each request alone so only the culprit sees the error
            with self._lock:
                self.stats.solo_retries += len(chunk)
            for req in chunk:
                self._sweep_chunk(plan, [req])
            return
        lo = 0
        for req in chunk:
            hi = lo + len(req.scenarios)
            self._finish(req, _client_rows(rep, lo, hi))
            lo = hi
        with self._lock:
            self.stats.max_batch_B = max(self.stats.max_batch_B, B)
            if len(chunk) > 1:
                self.stats.coalesced_batches += 1
                self.stats.max_coalesced = max(self.stats.max_coalesced,
                                               len(chunk))

    def _retry_or_fail(self, plan: CompiledWorkflow, req: _Request,
                       exc: Exception, rerun) -> None:
        """Bounded exponential-backoff retry of a failed solo request.

        Backoff is ``retry_backoff_s * 2**attempt`` plus up to 25% jitter
        drawn from the explicitly-seeded generator (reproducible runs, no
        wall-clock randomness).  Typed service errors are never retried —
        they describe a decision, not a transient fault.
        """
        if isinstance(exc, ServiceError) or req.retries >= self.max_retries:
            req.future.set_exception(exc)
            return
        delay = (self.retry_backoff_s * (2 ** req.retries)
                 * (1.0 + 0.25 * float(self._retry_rng.random())))
        now = time.perf_counter()
        if req.deadline is not None and now + delay > req.deadline:
            req.future.set_exception(DeadlineExceeded(
                f"request failed ({exc!r}) and its deadline leaves no room "
                f"for the {delay * 1e3:.1f}ms retry backoff"))
            return
        req.retries += 1
        with self._lock:
            self.stats.retries += 1
        time.sleep(delay)
        rerun()

    def _finish(self, req: _Request, rep: Report) -> None:
        lat = time.perf_counter() - req.t_submit
        with self._lock:
            self.stats.latencies_s.append(lat)
        if not req.future.done():
            req.future.set_result(rep)


class MalformedDeltaWarning(UserWarning):
    """:meth:`OnlineReanalysis.ingest` quarantined a malformed monitoring
    delta (NaN/non-finite value, or a non-monotone measured-progress/data
    PPoly) instead of letting it poison the pack."""


def _delta_problem(plan: CompiledWorkflow, rawkey: Any, value: Any
                   ) -> str | None:
    """Why this monitoring delta must be quarantined, or None if clean.

    Only *value* malformations are judged here (NaN scalars, non-finite
    PPoly coefficients, non-monotone data/measured-progress functions);
    unknown processes/inputs keep raising ``override()``'s typed errors.
    """
    from .scenarios import parse_key

    try:
        proc, name = parse_key(rawkey)
        p = plan.workflow.processes[proc]
        is_res = name in p.resources
        if not is_res and name not in p.data:
            return None
    except Exception:  # noqa: BLE001 — malformed KEYS stay override()'s job
        return None
    is_scalar = (np.isscalar(value) or isinstance(value, np.generic)
                 or (isinstance(value, np.ndarray) and value.ndim == 0))
    values = [value] if (isinstance(value, PPoly) or is_scalar) \
        else list(value)
    for v in values:
        if isinstance(v, PPoly):
            if not (np.all(np.isfinite(v.starts))
                    and np.all(np.isfinite(v.coeffs))):
                return (f"{proc}.{name}: non-finite PPoly coefficients")
            # cumulative data/progress inputs must not run backwards;
            # resource rates may legitimately ramp down
            if not is_res and not v.is_monotone_nondecreasing():
                return (f"{proc}.{name}: non-monotone measured progress")
        else:
            try:
                x = float(np.asarray(v))
            except Exception:  # noqa: BLE001 — not a value problem
                return None
            if not np.isfinite(x):
                return f"{proc}.{name}: non-finite scalar"
    return None


class OnlineReanalysis:
    """Live-run tracking: override-driven re-sweeps of one prepared pack.

    The session prepares its scenarios ONCE; every :meth:`ingest` applies
    monitoring deltas through ``ScenarioPack.override`` (a delta re-pack —
    nothing else is resolved, audited, or re-packed) and re-sweeps on the
    fused engine, so the prediction tracks the live run at re-sweep cost.

    Delta values are whatever ``override`` accepts: a replacement
    :class:`PPoly` (e.g. a measured rate ramp, or
    :meth:`ProgressMonitor.measured_progress`), a plain or numpy scalar
    (scale the base input), or a per-scenario sequence.

    With a ``service``, re-sweeps run on the service worker (serialized
    with the coalesced traffic); standalone sessions sweep inline.

    With a ``journal`` (`svc.track(..., track_id=...)`), deltas are
    appended write-ahead — checksummed and fsynced BEFORE they touch the
    pack — so ``svc.recover(track_id)`` rebuilds the live state
    bit-identically after a crash.  The journal's first record is a
    *genesis* snapshot (workflow + resolved scenarios), written only when
    the journal is empty, making recovery self-contained.
    """

    def __init__(self, plan: CompiledWorkflow, scenarios: Any, *,
                 backend: str = "auto",
                 service: AnalysisService | None = None,
                 journal: Any = None, track_id: str | None = None):
        self.plan = plan
        self._backend = backend
        self._service = service
        if isinstance(scenarios, ScenarioPack):
            self.pack = scenarios
        else:
            if isinstance(scenarios, (Scenario, ScenarioSpec)):
                scenarios = [scenarios]
            self.pack = plan.prepare(list(scenarios))
        self.updates = 0
        self.report: Report | None = None
        self.track_id = track_id
        self.quarantined = 0
        self._journal = None
        if journal is not None:
            from .artifacts import fingerprint_digest
            from .journal import Journal

            self._journal = journal if isinstance(journal, Journal) \
                else Journal(journal)
            if self._journal.n_records == 0:
                self._journal.append({
                    "kind": "genesis", "format": 1, "track_id": track_id,
                    "workflow": plan.workflow,
                    "scenarios": list(self.pack.scenarios),
                    "fingerprint": fingerprint_digest(plan.workflow)})

    def ingest(self, deltas: Mapping[Any, Any] | None = None, *,
               timeout: float | None = None) -> Report:
        """Apply monitoring deltas (may be ``None`` for a plain refresh),
        re-sweep, and return the fresh :class:`Report`.

        Malformed deltas — NaN/non-finite values, non-monotone
        measured-progress PPolys — are *quarantined*: dropped with one
        :class:`MalformedDeltaWarning` and censused
        (``self.quarantined`` / ``ServiceStats.quarantined``) while
        well-formed deltas in the same call still apply.  Surviving deltas
        are journaled (when tracking durably) BEFORE they touch the pack.
        """
        if deltas:
            deltas = self._quarantine(dict(deltas))
        if deltas:
            if self._journal is not None:
                self._journal.append({"kind": "delta",
                                      "deltas": dict(deltas)})
            self.pack = self.pack.override(deltas)
        if self._service is not None:
            self.report = self._service.submit_pack(self.pack).result(timeout)
        else:
            self.report = self.plan.sweep(self.pack, backend=self._backend)
        self.updates += 1
        return self.report

    def _quarantine(self, deltas: dict) -> dict:
        bad: dict[Any, str] = {}
        for k, v in deltas.items():
            why = _delta_problem(self.plan, k, v)
            if why is not None:
                bad[k] = why
        if not bad:
            return deltas
        for k in bad:
            deltas.pop(k)
        reasons = sorted(set(bad.values()))
        warnings.warn(
            f"online re-analysis: quarantined {len(bad)} malformed "
            f"monitoring delta(s) [{'; '.join(reasons)}]; the pack keeps "
            "its previous state for those inputs",
            MalformedDeltaWarning, stacklevel=3)
        self.quarantined += len(bad)
        if self._service is not None:
            with self._service._lock:
                for why in bad.values():
                    self._service.stats.count_quarantined(why)
        return deltas

    def refresh(self) -> Report:
        """Re-sweep the current pack without new deltas."""
        return self.ingest(None)

    def close(self) -> None:
        """Close the session's journal (if any); ``svc.recover`` reopens it."""
        if self._journal is not None:
            self._journal.close()

    def mc(self, spec: Any, n: int = 1024, *, seed: int = 0, template: int = 0,
           quantile_levels: Sequence[float] = DEFAULT_QUANTILES) -> MCReport:
        """A distribution query around the session's CURRENT tracked state.

        Samples ``n`` draws of ``spec`` (deterministic, like ``plan.mc``),
        then fills every input the draws do *not* touch from tracked scenario
        ``template`` — so ingested monitoring deltas (measured rates,
        progress) stay in effect while the spec'd axes vary.  Sampled axes
        themselves scale the plan's base inputs.  With a service attached the
        fused sweep runs on its worker, sharing its engine with live traffic.
        """
        samples = sample_spec(self.plan, spec, n, seed=seed)
        base = self.pack.scenarios[template]
        for sc in samples.scenarios:
            for k, fn in base.resource_inputs.items():
                sc.resource_inputs.setdefault(k, fn)
            for k, fn in base.data_inputs.items():
                sc.data_inputs.setdefault(k, fn)
        pack = self.plan.prepare(samples.scenarios)
        if self._service is not None:
            rep = self._service.submit_pack(pack).result()
        else:
            rep = self.plan.sweep(pack, backend=self._backend)
        return mc_report_from_sweep(rep, samples, quantile_levels)
