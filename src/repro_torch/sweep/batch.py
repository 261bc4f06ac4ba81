"""Scenario description + batch packing for the what-if sweep engine.

A :class:`Scenario` is a *delta* against a base :class:`~repro_torch.core.Workflow`:
per-process resource-rate inputs and/or external data-input functions to
replace (the paper's Fig. 7 sweep varies exactly these — 600 different link
prioritizations of the same five-process workflow).  :class:`ScenarioBatch`
resolves lazy :class:`~repro_torch.analysis.scenarios.ScenarioSpec` objects
against the base workflow and validates every override key; the packing into
padded batched arrays lives in :class:`repro_torch.analysis.pack.ScenarioPack`
(built by ``CompiledWorkflow.prepare`` and by every ``plan.sweep(list)``
call — prepare once to amortize it across re-sweeps).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ppoly import PPoly
from repro_torch.core.workflow import Workflow


@dataclass
class Scenario:
    """Per-scenario overrides applied on top of the base workflow.

    Keys are ``(process, resource)`` / ``(process, data_dep)`` pairs; values
    are the replacement input functions ``I_Rl(t)`` / ``I_Dk(t)``.  Process
    definitions (requirement/output functions) are shared across the batch.
    """

    label: str = ""
    resource_inputs: dict[tuple[str, str], PPoly] = field(default_factory=dict)
    data_inputs: dict[tuple[str, str], PPoly] = field(default_factory=dict)


class ScenarioBatch:
    """Resolve + pack B scenarios' input functions against a base workflow."""

    def __init__(self, workflow: Workflow, scenarios: list[Scenario]):
        if not scenarios:
            raise ValueError("need at least one scenario")
        self.workflow = workflow
        # lazy ScenarioSpec objects (repro_torch.analysis.scenarios DSL) resolve
        # their base-relative overrides against this workflow here
        self.scenarios = [s.resolve(workflow) if hasattr(s, "resolve") else s
                          for s in scenarios]
        self.B = len(scenarios)
        edge_deps = {(e.dst, e.dep) for e in workflow.edges}
        for i, sc in enumerate(self.scenarios):
            for (proc, res) in sc.resource_inputs:
                if proc not in workflow.processes:
                    raise ValueError(f"scenario {i}: unknown process {proc!r}")
                if res not in workflow.processes[proc].resources:
                    raise ValueError(f"scenario {i}: process {proc!r} has no "
                                     f"resource {res!r}")
            for (proc, dep) in sc.data_inputs:
                if proc not in workflow.processes:
                    raise ValueError(f"scenario {i}: unknown process {proc!r}")
                if dep not in workflow.processes[proc].data:
                    raise ValueError(f"scenario {i}: process {proc!r} has no "
                                     f"data dep {dep!r}")
                if (proc, dep) in edge_deps:
                    raise ValueError(
                        f"scenario {i}: data dep {proc!r}/{dep!r} is produced "
                        "by an upstream process and cannot be overridden")

    def apply(self, i: int) -> Workflow:
        """Materialize scenario ``i`` as a standalone workflow."""
        wf = self.workflow.clone()
        sc = self.scenarios[i]
        for (proc, res), fn in sc.resource_inputs.items():
            wf.resource_alloc.setdefault(proc, {})[res] = fn
        for (proc, dep), fn in sc.data_inputs.items():
            wf.external_data.setdefault(proc, {})[dep] = fn
        return wf

    def labels(self) -> list[str]:
        return [sc.label or f"scenario-{i}" for i, sc in enumerate(self.scenarios)]
