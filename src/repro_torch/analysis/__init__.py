"""One front door: compile-once / query-many BottleMod analysis on PyTorch.

    plan = compile(workflow)               # on the CUDA card (device=None)
    plan = compile(workflow, device="cpu") # plain CPU versions
    plan.solve().makespan                  # exact scalar analysis
    pack = plan.prepare(scs)               # resolve+classify+pack: ONCE
    report = plan.sweep(pack)              # fused float64 sweep on the device
    report.sample_progress("dl1", ts)      # curve queries: CUDA kernels
    plan.whatif(**{"task1.cpu": 2.0})      # one-off override query
    plan.bottleneck_fn()                   # piecewise overall bottleneck
    plan.gain(("task1", "cpu"))            # makespan won by relaxing it
    plan.mc(spec, n=10_000, seed=0)        # Monte Carlo: quantiles, SLOs,
                                           #   attribution probabilities
    plan.optimize(space=space)             # gradient search for the best
                                           #   allocation, fused-sweep steps
    plan.export("plan.bmplan")             # durable artifact: workflow
    plan = analysis.load_plan(path)        #   arrays + proven caps
    svc = AnalysisService(workflow)        # coalescing service on the card

Every query returns the same :class:`~repro_torch.analysis.report.Report`;
see :mod:`repro_torch.analysis.scenarios` for the scenario-builder DSL,
:mod:`repro_torch.analysis.optimize` for the differentiable-makespan search,
:mod:`repro_torch.analysis.uncertainty` for Monte Carlo,
:mod:`repro_torch.analysis.serve` for the analysis service,
:mod:`repro_torch.analysis.artifacts` / :mod:`repro_torch.analysis.journal`
for durable plan artifacts and crash-recoverable online state, and
:mod:`repro_torch.analysis.plan` for what compilation precomputes.
"""

from .bottleneck import BottleneckFn, BottleneckInterval, derive_bottleneck_fn
from .pack import CapAxis, PwAxis, ScenarioPack, ThetaMap
from .report import (BottleneckRow, FinishTimes, Report, concat_reports,
                     report_from_scalar)
from .scenarios import (ScenarioSpec, grid, override, ramp_resource,
                        scale_resource, speed_up_data)
from . import artifacts, dist, faults, journal, optimize, scenarios
from .artifacts import (ArtifactError, ArtifactStore, ArtifactWarning,
                        export_plan, load_plan)
from .faults import FaultInjected, FaultPlan
from .journal import Journal, JournalError, JournalWarning, recover_journal
from .optimize import OptimizeReport, Space, cap_space, mc_quantile
from .uncertainty import MCReport, run_mc, sample_spec
from .plan import CompiledWorkflow, compile_workflow
from .serve import (AnalysisService, DeadlineExceeded, MalformedDeltaWarning,
                    OnlineReanalysis, Overloaded, ServiceClosed,
                    ServiceCrashed, ServiceError, ServiceStats,
                    workflow_fingerprint)

#: ``analysis.compile(workflow)`` — the front-door spelling of
#: :func:`~repro_torch.analysis.plan.compile_workflow`.
compile = compile_workflow

__all__ = [
    "compile", "Report", "MCReport", "OptimizeReport", "dist", "grid",
    "override", "ramp_resource", "AnalysisService", "FaultPlan",
    # durable artifacts + crash recovery
    "ArtifactError", "ArtifactStore", "ArtifactWarning", "Journal",
    "JournalError", "JournalWarning", "artifacts", "export_plan", "journal",
    "load_plan", "recover_journal",
    # optimizer surface
    "Space", "cap_space", "mc_quantile", "optimize",
    "CapAxis", "PwAxis", "ThetaMap",
    "BottleneckFn", "BottleneckInterval", "BottleneckRow",
    "CompiledWorkflow", "DeadlineExceeded", "FaultInjected", "FinishTimes",
    "MalformedDeltaWarning", "OnlineReanalysis", "Overloaded",
    "ScenarioPack", "ScenarioSpec", "ServiceClosed", "ServiceCrashed",
    "ServiceError", "ServiceStats", "compile_workflow", "concat_reports",
    "derive_bottleneck_fn", "faults", "report_from_scalar", "run_mc",
    "sample_spec", "scale_resource", "scenarios", "speed_up_data",
    "workflow_fingerprint",
]
