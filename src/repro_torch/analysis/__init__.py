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

Every query returns the same :class:`~repro_torch.analysis.report.Report`;
see :mod:`repro_torch.analysis.scenarios` for the scenario-builder DSL and
:mod:`repro_torch.analysis.plan` for what compilation precomputes.
"""

from .bottleneck import BottleneckFn, BottleneckInterval, derive_bottleneck_fn
from .pack import ScenarioPack
from .report import (BottleneckRow, FinishTimes, Report, concat_reports,
                     report_from_scalar)
from .scenarios import (ScenarioSpec, grid, override, ramp_resource,
                        scale_resource, speed_up_data)
from . import dist, scenarios
from .plan import CompiledWorkflow, compile_workflow

#: ``analysis.compile(workflow)`` — the front-door spelling of
#: :func:`~repro_torch.analysis.plan.compile_workflow`.
compile = compile_workflow

__all__ = [
    "compile", "Report", "dist", "grid", "override", "ramp_resource",
    "BottleneckFn", "BottleneckInterval", "BottleneckRow",
    "CompiledWorkflow", "FinishTimes", "ScenarioPack", "ScenarioSpec",
    "compile_workflow", "concat_reports", "derive_bottleneck_fn",
    "report_from_scalar", "scale_resource", "scenarios", "speed_up_data",
]
