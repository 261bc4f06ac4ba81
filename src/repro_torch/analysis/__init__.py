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

Every query returns the same :class:`~repro_torch.analysis.report.Report`;
see :mod:`repro_torch.analysis.scenarios` for the scenario-builder DSL,
:mod:`repro_torch.analysis.optimize` for the differentiable-makespan search,
:mod:`repro_torch.analysis.uncertainty` for Monte Carlo, and
:mod:`repro_torch.analysis.plan` for what compilation precomputes.
"""

from .bottleneck import BottleneckFn, BottleneckInterval, derive_bottleneck_fn
from .pack import CapAxis, PwAxis, ScenarioPack, ThetaMap
from .report import (BottleneckRow, FinishTimes, Report, concat_reports,
                     report_from_scalar)
from .scenarios import (ScenarioSpec, grid, override, ramp_resource,
                        scale_resource, speed_up_data)
from . import dist, optimize, scenarios
from .optimize import OptimizeReport, Space, cap_space, mc_quantile
from .uncertainty import MCReport, run_mc, sample_spec
from .plan import CompiledWorkflow, compile_workflow

#: ``analysis.compile(workflow)`` — the front-door spelling of
#: :func:`~repro_torch.analysis.plan.compile_workflow`.
compile = compile_workflow

__all__ = [
    "compile", "Report", "MCReport", "OptimizeReport", "dist", "grid",
    "override", "ramp_resource",
    # optimizer surface
    "Space", "cap_space", "mc_quantile", "optimize",
    "CapAxis", "PwAxis", "ThetaMap",
    "BottleneckFn", "BottleneckInterval", "BottleneckRow",
    "CompiledWorkflow", "FinishTimes", "ScenarioPack", "ScenarioSpec",
    "compile_workflow", "concat_reports", "derive_bottleneck_fn",
    "report_from_scalar", "run_mc", "sample_spec", "scale_resource",
    "scenarios", "speed_up_data",
]
