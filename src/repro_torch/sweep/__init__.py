"""Batched what-if scenario sweeps: the lockstep engines behind
``CompiledWorkflow.sweep``.

* :mod:`.engine` — the vectorized numpy lockstep engine, the reference
  backend (``backend="numpy"``);
* :mod:`.torch_engine` — the same event loop stacked per topology level in
  float64 torch ops on the plan's device (``backend="torch"``);
* :mod:`.plin` — the batched piecewise-polynomial algebra both share;
* :mod:`.batch` — scenario deltas and their validation.

:func:`analyze` is kept as a back-compat shim over
``compile_workflow(workflow).sweep(...)``; it re-compiles the workflow on
every call, which is exactly the overhead the compiled plan avoids.
"""

from __future__ import annotations

from repro_torch.core.workflow import Workflow

from .batch import Scenario, ScenarioBatch
from .engine import BatchProcResult, solve_batch
from .plin import BPL, UnsupportedScenario, compose_scalar
from .result import BottleneckRow, Report, SweepResult

__all__ = [
    "Scenario", "ScenarioBatch", "SweepResult", "Report", "BottleneckRow",
    "BatchProcResult", "BPL", "UnsupportedScenario", "analyze", "solve_batch",
    "compose_scalar",
]


def analyze(workflow: Workflow, scenarios: list[Scenario],
            backend: str = "auto", *, device=None) -> Report:
    """Analyze B what-if scenarios of ``workflow`` in one batched pass on
    ``device`` (default: the CUDA card).

    .. deprecated::
        Compiles the workflow on EVERY call. Compile once and sweep many::

            plan = workflow.compile()
            res = plan.sweep(scenarios, backend="auto")

    ``backend`` takes the port's names (``"auto"``, ``"torch"``,
    ``"numpy"``/``"batched"``, ``"loop"``).
    """
    import warnings

    from repro_torch.analysis import compile_workflow

    warnings.warn(
        "repro_torch.sweep.analyze(workflow, scenarios) is deprecated and "
        "re-compiles the workflow on every call; migrate with "
        "`plan = workflow.compile(); plan.sweep(scenarios, backend=...)`.",
        DeprecationWarning, stacklevel=2)
    return compile_workflow(workflow, device=device).sweep(
        scenarios, backend=backend)
