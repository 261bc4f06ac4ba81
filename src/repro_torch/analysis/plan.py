"""Compile-once / query-many analysis — the repo's front door.

BottleMod's pitch is cheap re-analysis (Sect. 6/8): derive the model once,
then ask many what-if questions.  :func:`compile_workflow` (or
``Workflow.compile()``) performs everything that does not depend on the
question being asked exactly once:

* DAG validation + topological order,
* static per-process solver tables (resource-requirement breakpoints,
  slopes, burst jumps),
* packing of every base input function into the padded batched-array layout
  of ``kernels/ppoly_eval`` (single-row, broadcast per query),
* pre-composition of the data ceilings ``R_Dk(I_Dk(t))`` for external
  inputs,
* the batched-function-class audit used to route scenarios between the
  lockstep engine and the scalar fallback.

The resulting :class:`CompiledWorkflow` then serves

* :meth:`~CompiledWorkflow.solve` — exact scalar analysis,
* :meth:`~CompiledWorkflow.sweep` — B what-if scenarios in one batched pass,
* :meth:`~CompiledWorkflow.whatif` — one-off override query,
* :meth:`~CompiledWorkflow.bottleneck_fn` — the paper's piecewise overall
  bottleneck function over runtime,
* :meth:`~CompiledWorkflow.gain` / :meth:`~CompiledWorkflow.gains` — the
  estimated makespan reduction from relaxing a bottleneck,
* :meth:`~CompiledWorkflow.mc` — Monte Carlo quantiles, SLO probabilities
  and bottleneck-attribution probabilities over sampled scenarios,
* :meth:`~CompiledWorkflow.optimize` — gradient search for the best
  allocation over the differentiable fused sweep,

all returning the unified :class:`~repro_torch.analysis.report.Report`.

The plan lives on one device (``plan.device``): the CUDA card unless the
caller passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
The fused sweep runs there in float64, and the Report's curve queries run
there as CUDA kernels (plain versions on the CPU).
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.ppoly import PPoly
from repro_torch.core.solver import ProgressResult
from repro_torch.core.workflow import Workflow
from repro_torch.device import resolve_device
from repro_torch.sweep.batch import Scenario
from repro_torch.sweep.engine import BatchProcResult, _res_tables, solve_batch
from repro_torch.sweep.plin import (BPL, UnsupportedScenario, compose_scalar,
                              is_batchable_resource)
from repro_torch.sweep.torch_engine import LazyCeilings, TorchSweepEngine

from .bottleneck import BottleneckFn, derive_bottleneck_fn
from .optimize import run_optimize
from .pack import ScenarioPack
from .report import FinishTimes, Report, report_from_scalar, scalar_shares
from .scenarios import ScenarioSpec, parse_key, speed_up_data
from .uncertainty import DEFAULT_QUANTILES, run_mc

__all__ = ["CompiledWorkflow", "compile_workflow"]

#: engines selectable on ``CompiledWorkflow.sweep``
SWEEP_BACKENDS = ("auto", "torch", "numpy", "batched", "loop")

_FactorKey = tuple[str, str, str]


def _describe_fn(fn: PPoly) -> str:
    """The degree/shape census entry for an out-of-class input function."""
    desc = f"degree {fn.degree}, {fn.n_pieces} piece(s)"
    if fn.is_piecewise_linear and not is_batchable_resource(fn):
        desc += ", goes negative"
    return desc


def compile_workflow(workflow: Workflow, device: Any = None,
                     ) -> "CompiledWorkflow":
    """Validate + compile ``workflow`` into a query-many analysis plan on
    ``device`` (default: the CUDA card; raises when there is none)."""
    return CompiledWorkflow(workflow, device=device)


class CompiledWorkflow:
    """A validated, packed, query-ready BottleMod workflow (see module doc).

    The plan snapshots the workflow at compile time: later mutation of the
    original ``Workflow`` does not affect the plan.
    """

    def __init__(self, workflow: Workflow, device: Any = None):
        self.device = resolve_device(device)
        workflow.validate()
        self.workflow: Workflow = workflow.clone()
        wf = self.workflow
        self.order: list[str] = wf._topo_order()
        self.gates: dict[str, list[str]] = {n: list(g) for n, g in wf.gates.items()}
        #: per destination process: [(src, output, dep), ...]
        self.edges_in: dict[str, list[tuple[str, str, str]]] = {
            n: [(e.src, e.output, e.dep) for e in wf.edges if e.dst == n]
            for n in self.order}
        #: (process, data_dep) -> producing process, for pipelined edges
        self.edge_sources: dict[tuple[str, str], str] = {
            (e.dst, e.dep): e.src for e in wf.edges}
        #: topology levels: processes grouped by longest-path depth over
        #: edges AND gates.  Processes in one level share no dependencies,
        #: so the torch engine stacks each level into ONE fused lockstep loop;
        #: the numpy/scalar paths
        #: only read the flat ``order``.
        depth: dict[str, int] = {}
        for n in self.order:
            deps = ([src for (src, _o, _d) in self.edges_in[n]]
                    + self.gates.get(n, []))
            depth[n] = 1 + max((depth[d] for d in deps), default=-1)
        self.levels: list[list[str]] = [
            [] for _ in range(max(depth.values(), default=-1) + 1)]
        for n in self.order:
            self.levels[depth[n]].append(n)
        self.base_res: dict[tuple[str, str], PPoly] = {
            (n, r): wf.resource_alloc[n][r]
            for n in self.order for r in wf.processes[n].resources}
        self.base_data: dict[tuple[str, str], PPoly] = {
            (n, d): wf.external_data[n][d]
            for n in self.order for d in wf.processes[n].data
            if (n, d) not in self.edge_sources}

        # ---- static solver tables (derived once, reused by every query) ----
        self.res_tables: dict[str, Any] = {
            n: _res_tables(wf.processes[n]) for n in self.order}

        # ---- batched-function-class audit (workflow-level, once) -----------
        self._class_reason: str | None = self._audit_function_class()

        # ---- kernel-ready packing of base inputs (single row, broadcast) ---
        self._base_res_ok: dict[tuple[str, str], bool] = {
            k: is_batchable_resource(fn) for k, fn in self.base_res.items()}
        self._base_data_ok: dict[tuple[str, str], bool] = {
            k: fn.is_piecewise_quadratic for k, fn in self.base_data.items()}
        self._base_res_row: dict[tuple[str, str], BPL] = {}
        self._base_ceil_row: dict[tuple[str, str], BPL] = {}
        for key, fn in self.base_res.items():
            if fn.is_piecewise_linear:
                self._base_res_row[key] = BPL.from_ppolys([fn])
        for (n, d), fn in self.base_data.items():
            req = wf.processes[n].data[d].requirement
            if fn.is_piecewise_quadratic and req.is_piecewise_linear:
                self._base_ceil_row[(n, d)] = compose_scalar(
                    req, BPL.from_ppolys([fn]))

        self._base_report: Report | None = None
        self._bottleneck_fn: BottleneckFn | None = None
        self._torch_engine: TorchSweepEngine | None = None  # built lazily
        self._level_sig: tuple | None = None

    # ------------------------------------------------------------------
    @property
    def level_signature(self) -> tuple:
        """Hashable fingerprint of what the fused engine specializes on.

        Covers exactly what :class:`repro_torch.sweep.torch_engine._WorkflowSpec`
        bakes into the engine — the topology levels and, per process, its
        name, total progress, gates, edge sources with their output
        functions, requirement functions, and resource-requirement tables.
        Two plans with equal signatures build identical engines, so a
        serving tier (:mod:`repro_torch.analysis.serve`) shares ONE
        ``TorchSweepEngine`` — and thereby its proven iteration caps —
        across them; base *input* functions are deliberately excluded (they
        arrive per pack)."""
        if self._level_sig is None:
            wf = self.workflow

            def fp(fn: PPoly) -> tuple:
                return (fn.starts.tobytes(), fn.coeffs.shape,
                        fn.coeffs.tobytes())

            sig = []
            for level in self.levels:
                lsig = []
                for n in level:
                    proc = wf.processes[n]
                    edges = tuple(
                        (dep, src, out, fp(wf.processes[src].outputs[out]))
                        for (src, out, dep) in self.edges_in[n])
                    reqs = tuple((d, fp(dd.requirement))
                                 for d, dd in proc.data.items())
                    tables = tuple(
                        (lab, rb.tobytes(), rc1.tobytes(), jumps.tobytes())
                        for (lab, rb, rc1, jumps) in self.res_tables[n])
                    lsig.append((n, float(proc.total_progress),
                                 tuple(proc.data.keys()),
                                 tuple(self.gates.get(n, [])),
                                 edges, reqs, tables))
                sig.append(tuple(lsig))
            self._level_sig = tuple(sig)
        return self._level_sig

    # ------------------------------------------------------------------
    # scalar path
    # ------------------------------------------------------------------
    def scalar_results(
        self,
        resource_overrides: Mapping[tuple[str, str], PPoly] | None = None,
        data_overrides: Mapping[tuple[str, str], PPoly] | None = None,
    ) -> dict[str, ProgressResult]:
        """One exact Algorithm-2 solve over the precompiled order.

        Delegates to the same orchestration loop ``Workflow.analyze`` uses
        (:meth:`repro_torch.core.workflow.Workflow._solve_in_order`) so the two
        paths cannot drift — only the topo-sort/validation is skipped here.
        """
        return self.workflow._solve_in_order(
            self.order, dict(resource_overrides or {}),
            dict(data_overrides or {}))

    def solve(self) -> Report:
        """Exact scalar analysis of the base workflow (cached)."""
        if self._base_report is None:
            self._base_report = report_from_scalar(
                self.scalar_results(), self.order, "base", plan=self)
        return self._base_report

    def whatif(self, overrides: Mapping[str, Any] | None = None, *,
               label: str = "what-if", **kw: Any) -> Report:
        """One-off what-if: override or scale named inputs, re-solve exactly.

        Keys are ``"process.input"`` strings naming a resource allocation or
        an external data input; values are a replacement :class:`PPoly` or a
        number (scale factor — rate multiplier for resources, time-axis
        speed-up for data inputs)::

            plan.whatif(**{"task1.cpu": 2.0})          # double task1's CPU
            plan.whatif({"dl1.link": PPoly.constant(4e6)})
        """
        merged: dict[str, Any] = {**(overrides or {}), **kw}
        res_over, data_over = self._parse_overrides(merged)
        results = self.scalar_results(res_over, data_over)
        return report_from_scalar(results, self.order, label, plan=self)

    def _parse_overrides(
        self, overrides: Mapping[str, Any]
    ) -> tuple[dict[tuple[str, str], PPoly], dict[tuple[str, str], PPoly]]:
        res_over: dict[tuple[str, str], PPoly] = {}
        data_over: dict[tuple[str, str], PPoly] = {}
        for key, v in overrides.items():
            proc, name = parse_key(key)
            if proc not in self.workflow.processes:
                raise ValueError(
                    f"what-if: unknown process {proc!r} "
                    f"(processes: {sorted(self.workflow.processes)})")
            p = self.workflow.processes[proc]
            if name in p.resources:
                base = self.base_res[(proc, name)]
                res_over[(proc, name)] = (
                    v if isinstance(v, PPoly) else base * float(v))
            elif name in p.data:
                if (proc, name) in self.edge_sources:
                    raise ValueError(
                        f"what-if: data input {proc!r}/{name!r} is produced "
                        f"by {self.edge_sources[(proc, name)]!r}; override "
                        "that process's inputs instead")
                base = self.base_data[(proc, name)]
                data_over[(proc, name)] = (
                    v if isinstance(v, PPoly) else speed_up_data(base, float(v)))
            else:
                raise ValueError(
                    f"what-if: process {proc!r} has no input {name!r} "
                    f"(resources: {sorted(p.resources)}, "
                    f"data: {sorted(p.data)})")
        return res_over, data_over

    # ------------------------------------------------------------------
    # bottleneck function + gain queries (paper Sect. 6/8)
    # ------------------------------------------------------------------
    def bottleneck_fn(self) -> BottleneckFn:
        """The overall piecewise bottleneck function over runtime (cached)."""
        if self._bottleneck_fn is None:
            self.solve()
            assert self._base_report is not None
            assert self._base_report.scalar_results is not None
            self._bottleneck_fn = derive_bottleneck_fn(
                self._base_report.scalar_results, self.edge_sources, self.gates)
        return self._bottleneck_fn

    def gain(self, bottleneck: Any, factor: float = 2.0) -> float:
        """Estimated makespan reduction from relaxing one bottleneck.

        ``bottleneck`` is a :class:`BottleneckInterval` /
        :class:`BottleneckRow` / ``BottleneckShare`` (anything with
        ``.process``/``.kind``/``.name``) or a ``(process, name)`` /
        ``(process, kind, name)`` tuple.  Relaxing means:

        * a **resource** bottleneck: scale its allocation by ``factor``,
        * an **external data** bottleneck: the data arrives ``factor``x
          faster,
        * an **edge-fed data** bottleneck: scale every resource allocation
          of the producing process by ``factor`` (make the producer faster).

        Because re-analysis is nearly free (Sect. 6), the gain is computed by
        actually re-solving the relaxed workflow — the paper's recommended
        estimator for schedulers.
        """
        proc, kind, name = self._parse_bottleneck(bottleneck)
        base = self.solve()
        res_over: dict[tuple[str, str], PPoly] = {}
        data_over: dict[tuple[str, str], PPoly] = {}
        if kind == "resource":
            res_over[(proc, name)] = self.base_res[(proc, name)] * factor
        elif (proc, name) in self.edge_sources:
            src = self.edge_sources[(proc, name)]
            for r in self.workflow.processes[src].resources:
                res_over[(src, r)] = self.base_res[(src, r)] * factor
        else:
            data_over[(proc, name)] = speed_up_data(
                self.base_data[(proc, name)], factor)
        relaxed = self.scalar_results(res_over, data_over)
        new_makespan = max((relaxed[n].finish_time for n in self.order),
                           default=0.0)
        return float(base.makespan) - float(new_makespan)

    def gains(self, factor: float = 2.0) -> list[tuple[str, str, float, float]]:
        """Gain of scaling each resource allocation: ``(process, resource,
        new_makespan, gain_seconds)`` sorted by gain (the compiled form of
        :func:`repro_torch.core.bottleneck.potential_gains`)."""
        base = float(self.solve().makespan)
        out: list[tuple[str, str, float, float]] = []
        for (proc, res), fn in self.base_res.items():
            relaxed = self.scalar_results({(proc, res): fn * factor}, None)
            ms = max((relaxed[n].finish_time for n in self.order), default=0.0)
            out.append((proc, res, float(ms), base - float(ms)))
        out.sort(key=lambda x: -x[3])
        return out

    def _parse_bottleneck(self, b: Any) -> tuple[str, str, str]:
        if hasattr(b, "process") and hasattr(b, "name"):
            kind = getattr(b, "kind", None)
            proc, name = str(b.process), str(b.name)
        elif isinstance(b, tuple) and len(b) == 3:
            proc, kind, name = str(b[0]), str(b[1]), str(b[2])
        elif isinstance(b, tuple) and len(b) == 2:
            proc, name = str(b[0]), str(b[1])
            kind = None
        else:
            raise TypeError(
                "gain() takes a BottleneckInterval/BottleneckRow/"
                "BottleneckShare or a (process, [kind,] name) tuple")
        if proc not in self.workflow.processes:
            raise ValueError(f"gain: unknown process {proc!r}")
        p = self.workflow.processes[proc]
        if kind is None:
            kind = ("resource" if name in p.resources
                    else "data" if name in p.data else "")
        if (kind not in ("resource", "data")
                or name not in (p.resources if kind == "resource" else p.data)):
            raise ValueError(
                f"gain: process {proc!r} has no {kind or 'known'} input "
                f"{name!r} (resources: {sorted(p.resources)}, "
                f"data: {sorted(p.data)})")
        return proc, kind, name

    # ------------------------------------------------------------------
    # Monte Carlo path (repro_torch.analysis.uncertainty)
    # ------------------------------------------------------------------
    def mc(self, spec: Any, n: int = 10_000, *, seed: int = 0,
           backend: str = "auto", shards: int | None = None,
           quantile_levels: Sequence[float] | None = None) -> Any:
        """Monte Carlo analysis of a distribution-valued scenario spec.

        ``spec`` carries :mod:`repro_torch.analysis.dist` distributions on
        resource caps, ramp slopes, or data scale factors; ``n`` draws are
        sampled deterministically from ``seed`` and analyzed as ONE fused
        sweep on ``plan.device``::

            from repro_torch.analysis import dist, scenarios
            mc = plan.mc(scenarios.override({
                "dl2.link": dist.lognormal(sigma=0.3)}), n=10_000, seed=7)
            mc.quantiles()                  # {'p50': ..., 'p95': ..., 'p99': ...}
            mc.prob(makespan_le=250.0)      # SLO query
            mc.attribution()[0]             # "dl2.link binds in 83% of draws"
            mc.sensitivity()                # variance-based axis ranking

        Returns an :class:`repro_torch.analysis.uncertainty.MCReport`; see
        that module for the sampler's bit-reproducibility contract.
        ``shards`` other than None or 1 raises: the engine runs one device.
        """
        return run_mc(self, spec, n, seed=seed, backend=backend,
                      shards=shards,
                      quantile_levels=(DEFAULT_QUANTILES if quantile_levels
                                       is None else quantile_levels))

    def export(self, path: Any) -> Any:
        """Serialize this plan into a self-contained durable artifact.

        The artifact bundles the snapshotted workflow (as ``(starts,
        coeffs)`` arrays) with the engine's proven iteration caps under an
        integrity-checked manifest; ``analysis.load_plan(path)`` rehydrates
        it in a later process, whose warm sweeps start at the proven caps
        and are bit-identical to a fresh ``compile()``.  Export a plan
        *after* sweeping the shapes you want warm.  See
        :mod:`repro_torch.analysis.artifacts` for the layout.
        """
        from .artifacts import export_plan

        return export_plan(self, path)

    def optimize(self, objective: Any = "makespan", space: Any = None, *,
                 constraints: Any = None, starts: int = 1, rungs: int = 8,
                 max_iters: int = 25, max_evals: int | None = None,
                 ftol: float = 1e-9, seed: int | None = None,
                 deadline_s: float | None = None) -> Any:
        """Search ``space`` for the allocation minimizing ``objective`` by
        projected gradient descent over the differentiable fused sweep.

        Every optimizer step evaluates its whole candidate ladder (line
        search × multi-start) as ONE fused ``(B,)`` sweep on
        ``plan.device``, and gradients come from ``torch.autograd`` through
        the fixed-trip event loop — tens of evaluations where the Fig. 7
        grid needs 600::

            from repro_torch.analysis import optimize
            space = optimize.cap_space(["task1.cpu", "dl1.link"],
                                       lo=0.25, hi=4.0)
            opt = plan.optimize(space=space)            # point makespan
            opt = plan.optimize(                        # p95 under risk
                optimize.mc_quantile(mc_spec(), q=0.95, n=256), space)
            opt.theta, opt.value, opt.gain, opt.report

        ``objective`` is ``"makespan"`` or an
        :class:`~repro_torch.analysis.optimize.mc_quantile`
        (common-random-number scoring, bit-reproducible for fixed ``seed``).
        Returns an :class:`~repro_torch.analysis.optimize.OptimizeReport`;
        see :mod:`repro_torch.analysis.optimize` for the search's knobs and
        contract.
        """
        return run_optimize(self, objective, space, constraints=constraints,
                            starts=starts, rungs=rungs, max_iters=max_iters,
                            max_evals=max_evals, ftol=ftol, seed=seed,
                            deadline_s=deadline_s)

    # ------------------------------------------------------------------
    # batched sweep path
    # ------------------------------------------------------------------
    def prepare(self, scenario_list: Sequence[Scenario | ScenarioSpec],
                ) -> ScenarioPack:
        """Resolve + classify + pack a sweep ONCE into a reusable handle.

        ``plan.sweep(pack)`` then skips every per-call cost outside the
        solver — spec resolution, function-class audit, array packing — and
        routes the batched partition to the level-fused torch engine on
        ``plan.device`` by default.  See
        :class:`~repro_torch.analysis.pack.ScenarioPack` for delta re-packs
        (``pack.override``).
        """
        return ScenarioPack.build(self, scenario_list)

    def sweep(self, scenario_list: "Sequence[Scenario | ScenarioSpec] | ScenarioPack",
              *, backend: str = "auto") -> Report:
        """Analyze B what-if scenarios in one batched pass.

        ``scenario_list`` is either a list of scenarios/specs or a
        :class:`ScenarioPack` from :meth:`prepare` (repeated sweeps of the
        same candidate set should prepare once).

        ``backend``:

        * ``"torch"`` — the level-fused lockstep engine
          (:mod:`repro_torch.sweep.torch_engine`) on ``plan.device``: the
          event loop and ceiling algebra in float64 tensor ops, one loop per
          topology level (agrees with the numpy engine to float tolerance).
          Raises :class:`UnsupportedScenario` for out-of-class scenarios.
        * ``"numpy"`` (alias ``"batched"``) — the vectorized numpy lockstep
          engine, the reference backend.  Same class restriction.
        * ``"loop"`` — the exact scalar solver per scenario.
        * ``"auto"`` — in-class scenarios go to the torch engine when a
          prepared pack is passed (falling back to numpy if the engine
          declines, recorded in ``Report.engine_fallback``) and to the
          numpy engine for plain lists; out-of-class scenarios fall back to
          the scalar loop with one summary warning.  Per-scenario routing
          is recorded in ``Report.backends``.
        """
        if backend not in SWEEP_BACKENDS:
            raise ValueError(f"unknown backend {backend!r} "
                             f"(expected {'|'.join(SWEEP_BACKENDS)})")
        if isinstance(scenario_list, ScenarioPack):
            pack = scenario_list
            if pack.plan is not self:
                raise ValueError(
                    "ScenarioPack was prepared by a different plan; call "
                    "prepare() on the plan you sweep")
            prepared = True
        else:
            pack = ScenarioPack.build(self, scenario_list,
                                      classify=(backend != "loop"))
            prepared = False
        B = pack.B
        scenarios = pack.scenarios
        bat_idx = list(pack.bat_idx)
        loop_idx = list(pack.loop_idx)
        reason = pack.reason
        loop_reasons = dict(pack.loop_reasons)
        if backend == "loop":
            bat_idx, loop_idx, reason = [], list(range(B)), None
            loop_reasons = {}
        elif backend != "auto" and loop_idx:
            raise UnsupportedScenario(
                f"scenario {loop_idx[0]} ({pack.labels[loop_idx[0]] or 'unlabeled'}): "
                f"{reason}")

        use_torch = backend == "torch" or (backend == "auto" and prepared)
        batched: dict[str, BatchProcResult] | None = None
        engine_used = "batched"
        engine_fallback: str | None = None
        if bat_idx:
            try:
                if use_torch:
                    try:
                        batched = self._run_pack_torch(pack)
                        engine_used = "torch"
                    except UnsupportedScenario as decline:
                        if backend == "torch":
                            raise
                        # the torch engine declined mid-sweep (e.g.
                        # iteration-ladder exhaustion): the numpy reference
                        # ran instead — surface WHY on the report
                        engine_fallback = str(decline)
                        batched = self._run_pack_numpy(pack)
                else:
                    batched = self._run_pack_numpy(pack)
            except UnsupportedScenario as e:
                if backend != "auto":
                    raise
                # defensive: the engine found an out-of-class construct the
                # static audit missed — run those scenarios on the loop
                for i in bat_idx:
                    loop_reasons.setdefault(i, str(e))
                loop_idx = sorted(loop_idx + bat_idx)
                bat_idx = []
                reason = reason or str(e)
        loop_runs = {i: self.scalar_results(scenarios[i].resource_inputs,
                                            scenarios[i].data_inputs)
                     for i in loop_idx}
        if backend == "auto" and loop_idx:
            warnings.warn(
                f"sweep: {len(loop_idx)}/{B} scenario(s) outside the batched "
                f"function class fell back to the scalar loop backend "
                f"({reason}); see Report.backends for the per-scenario "
                "routing", UserWarning, stacklevel=2)
        rep = self._merge(pack, bat_idx, batched, loop_runs, engine_used,
                          loop_reasons)
        rep.engine_fallback = engine_fallback
        return rep

    def _classify(self, sc: Scenario) -> str | None:
        """None when the scenario fits the lockstep engine, else the reason.

        The batched class is piecewise-quadratic end to end: resource rate
        inputs may be any non-negative piecewise-LINEAR function (linear
        rate × linear requirement → quadratic progress, solved in closed
        form), data inputs any function of degree <= 2.  Only degree >= 2
        resource rates, negative rates, or degree >= 3 data inputs still
        fall back to the scalar loop.

        The reason string names the offending input AND its actual
        degree/shape — aggregated per sweep into ``Report.fallback_reasons``
        (and ``MCReport.fallback_reasons()``), the demand census the roadmap
        wants before a cubic/quartic engine class is built.
        """
        if self._class_reason is not None:
            return self._class_reason
        for key, fn in sc.resource_inputs.items():
            if not is_batchable_resource(fn):
                return (f"resource input {key[0]}.{key[1]} "
                        f"({_describe_fn(fn)}) must be a non-negative "
                        "piecewise-linear rate for the batched engine")
        for key, ok in self._base_res_ok.items():
            if not ok and key not in sc.resource_inputs:
                return (f"base resource input {key[0]}.{key[1]} "
                        f"({_describe_fn(self.base_res[key])}) must be a "
                        "non-negative piecewise-linear rate for the "
                        "batched engine")
        for key, fn in sc.data_inputs.items():
            if not fn.is_piecewise_quadratic:
                return (f"data input {key[0]}.{key[1]} ({_describe_fn(fn)}) "
                        "must have degree <= 2 for the batched engine")
        for key, ok in self._base_data_ok.items():
            if not ok and key not in sc.data_inputs:
                return (f"base data input {key[0]}.{key[1]} "
                        f"({_describe_fn(self.base_data[key])}) must have "
                        "degree <= 2 for the batched engine")
        return None

    def _audit_function_class(self) -> str | None:
        """Workflow-level function-class constraints of the batched engine."""
        wf = self.workflow
        for n in self.order:
            proc = wf.processes[n]
            for d, dep in proc.data.items():
                if not dep.requirement.is_piecewise_linear:
                    return (f"data requirement {n}.{d} has degree "
                            f"{dep.requirement.degree}; the batched engine "
                            "needs piecewise-linear requirements")
            # resource requirements are pw-linear by ResourceDep construction
        for e in wf.edges:
            fn = wf.processes[e.src].outputs[e.output]
            if not fn.is_piecewise_linear:
                return (f"output function {e.src}.{e.output} has degree "
                        f"{fn.degree}; the batched engine needs "
                        "piecewise-linear outputs")
        return None

    def _run_pack_numpy(self, pack: ScenarioPack) -> dict[str, BatchProcResult]:
        """The numpy lockstep pass over the pack's pre-packed arrays."""
        wf = self.workflow
        B = pack.B_batched
        results: dict[str, BatchProcResult] = {}
        progress: dict[str, BPL] = {}
        for name in self.order:
            proc = wf.processes[name]
            t0 = np.zeros(B)
            for g in self.gates.get(name, []):
                f = results[g].finish
                if not np.all(np.isfinite(f)):
                    # report the caller's index, not the partition-local one
                    bad = pack.bat_idx[int(np.argmin(np.isfinite(f)))]
                    raise ValueError(f"gate {g!r} of {name!r} never finishes "
                                     f"(scenario {bad})")
                t0 = np.maximum(t0, f)
            data_bpls: dict[str, BPL] = {}
            ceilings: dict[str, BPL] = {}
            for (src, output, dep) in self.edges_in[name]:
                out_fn = wf.processes[src].outputs[output]
                data_bpls[dep] = compose_scalar(out_fn, progress[src])
            args = pack.proc_args[name]
            for dep, bpl in args["data"].items():
                data_bpls[dep] = bpl.broadcast(B)
            for dep, bpl in args["ceil"].items():
                ceilings[dep] = bpl.broadcast(B)
            res_bpls = {r: bpl.broadcast(B) for r, bpl in args["res"].items()}
            results[name] = solve_batch(proc, data_bpls, res_bpls, t0,
                                        res_tables=self.res_tables[name],
                                        ceilings=ceilings)
            progress[name] = results[name].progress
        return results

    def _run_pack_torch(self, pack: ScenarioPack,
                        ) -> dict[str, BatchProcResult]:
        """The level-fused torch pass over the pack, on ``plan.device``."""
        if self._torch_engine is None:
            self._torch_engine = TorchSweepEngine(self)
        # host_args is called only on device-cache miss; the engine then
        # stacks it by topology level (level_args) before the transfer
        results = self._torch_engine.solve(pack.host_args, pack.B_batched,
                                           cache=pack._cache,
                                           scenario_ids=pack.bat_idx,
                                           ramps=pack.ramps)
        # the sweep keeps its ceiling arrays on the device; re-derive them
        # host-side only if a curve query (Report.data_ceiling) asks.  The
        # thunk captures just the packed inputs, not the pack (whose device
        # cache would otherwise stay pinned for the Report's lifetime).
        proc_args, B_bat = pack.proc_args, pack.B_batched
        for name in self.order:
            results[name].ceilings = LazyCeilings(
                lambda name=name: self._derive_ceilings(
                    proc_args, B_bat, results, name))
        return results

    def _derive_ceilings(self, proc_args: dict, B: int, results,
                         name: str) -> list[BPL]:
        """Numpy twin of the engine's ceiling construction (lazy path)."""
        wf = self.workflow
        proc = wf.processes[name]
        args = proc_args[name]
        edge_fns = {dep: wf.processes[src].outputs[output]
                    for (src, output, dep) in self.edges_in[name]}
        edge_src = {dep: src for (src, _o, dep) in self.edges_in[name]}
        ceils: list[BPL] = []
        for dep in proc.data:
            if dep in edge_fns:
                inner = compose_scalar(edge_fns[dep],
                                       results[edge_src[dep]].progress)
                ceils.append(compose_scalar(proc.data[dep].requirement, inner))
            elif dep in args["ceil"]:
                ceils.append(args["ceil"][dep].broadcast(B))
            else:
                ceils.append(compose_scalar(proc.data[dep].requirement,
                                            args["data"][dep].broadcast(B)))
        if not ceils:
            p_end = float(proc.total_progress)
            ceils = [BPL.constant(np.full(B, p_end),
                                  results[name].t_start.astype(np.float64))]
        return ceils

    # ------------------------------------------------------------------
    # merge batched + loop partitions into one Report
    # ------------------------------------------------------------------
    def _merge(self, pack: ScenarioPack, bat_idx: list[int],
               batched: dict[str, BatchProcResult] | None,
               loop_runs: dict[int, dict[str, ProgressResult]],
               engine_used: str = "batched",
               loop_reasons: dict[int, str] | None = None) -> Report:
        B = pack.B
        labels = pack.labels
        makespans = np.zeros(B)
        finish = FinishTimes({n: np.zeros(B) for n in self.order})
        backends = ["loop"] * B
        factors: list[_FactorKey] = []
        fac_index: dict[_FactorKey, int] = {}

        # batched partition: vectorized scatter into the merged arrays
        secs_cols: list[np.ndarray] = []
        frac_cols: list[np.ndarray] = []
        if batched is not None and bat_idx:
            sub = np.asarray(bat_idx)
            for i in bat_idx:
                backends[i] = engine_used
            if self.order:
                fins = np.stack([batched[n].finish for n in self.order])
                makespans[sub] = fins.max(0)
            for n in self.order:
                finish[n][sub] = batched[n].finish
                r = batched[n]
                fr = r.share_fractions()
                for j, (kind, fac) in enumerate(zip(r.factor_kinds,
                                                    r.factor_names)):
                    fac_index[(n, kind, fac)] = len(factors)
                    factors.append((n, kind, fac))
                    secs_cols.append(r.share_seconds[:, j])
                    frac_cols.append(fr[:, j])

        # loop partition: per-scenario scalar aggregation
        loop_cells: list[tuple[int, _FactorKey, float, float]] = []
        for i, results in loop_runs.items():
            makespans[i] = max((results[n].finish_time for n in self.order),
                               default=0.0)
            for n in self.order:
                finish[n][i] = results[n].finish_time
            keys, secs, fracs = scalar_shares(results, self.order)
            for key, s, f in zip(keys, secs, fracs):
                if key not in fac_index:
                    fac_index[key] = len(factors)
                    factors.append(key)
                loop_cells.append((i, key, s, f))

        F = len(factors)
        share_seconds = np.zeros((B, F))
        share_fractions = np.zeros((B, F))
        if secs_cols:
            share_seconds[np.ix_(sub, np.arange(len(secs_cols)))] = \
                np.stack(secs_cols, 1)
            share_fractions[np.ix_(sub, np.arange(len(frac_cols)))] = \
                np.stack(frac_cols, 1)
        for i, key, s, f in loop_cells:
            share_seconds[i, fac_index[key]] = s
            share_fractions[i, fac_index[key]] = f
        return Report(
            labels=labels, order=list(self.order), makespans=makespans,
            finish=finish, factors=factors, share_seconds=share_seconds,
            share_fractions=share_fractions, backends=backends,
            proc_results=batched if not loop_runs else None,
            plan=self, scenarios=pack.scenarios,
            fallback_reasons=dict(loop_reasons) if loop_reasons else None)
