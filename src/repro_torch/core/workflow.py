"""Workflow composition — BottleMod Sect. 3.4.

Processes are chained by using one process's output function ``O_m(P(t))`` as
the data input function ``I_Dk(t)`` of a successor.  Any DAG of processes can
be analyzed in topological order; cyclic dependency graphs are rejected (the
paper's stated limitation).

Two dependency styles are supported, matching the paper's evaluation:

* ``connect(...)`` — *pipelined*: the successor may start consuming the
  producer's output while the producer is still running (tasks 1/2 reading
  from their download processes).
* ``start_after`` gates — the successor's analysis starts only once the named
  processes finished (task 3, which starts after tasks 1 and 2 complete).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.analysis.plan import CompiledWorkflow

from .ppoly import PPoly
from .process import Process
from .solver import ProgressResult, Segment, solve


@dataclass
class _Edge:
    src: str
    output: str
    dst: str
    dep: str


@dataclass
class WorkflowResult:
    results: dict[str, ProgressResult]
    makespan: float
    order: list[str]

    def bottleneck_timeline(self) -> list[tuple[float, float, str, str, str]]:
        """Flattened ``(t0, t1, process, kind, name)`` across all processes."""
        out = []
        for pname, r in self.results.items():
            for s in r.segments:
                t1 = min(s.t_end, r.finish_time)
                if t1 > s.t_start:
                    out.append((s.t_start, t1, pname, s.kind, s.name))
        out.sort()
        return out

    def finish(self, name: str) -> float:
        return self.results[name].finish_time


class Workflow:
    """A DAG of BottleMod processes with explicit resource allocations."""

    def __init__(self):
        self.processes: dict[str, Process] = {}
        self.resource_alloc: dict[str, dict[str, PPoly]] = {}
        self.external_data: dict[str, dict[str, PPoly]] = {}
        self.edges: list[_Edge] = []
        self.gates: dict[str, list[str]] = {}

    # -- construction -------------------------------------------------------
    def add(self, proc: Process, resources: dict[str, PPoly] | None = None,
            start_after: list[str] | None = None) -> "Workflow":
        if proc.name in self.processes:
            raise ValueError(
                f"duplicate process {proc.name!r}: each process may be "
                "add()ed to a workflow only once")
        if start_after:
            # forward references are allowed (gates on processes added
            # later); unknown names are rejected by validate()
            self.gates[proc.name] = list(start_after)
        self.processes[proc.name] = proc
        self.resource_alloc[proc.name] = dict(resources or {})
        self.external_data.setdefault(proc.name, {})
        return self

    def connect(self, src: str, dst: str, dep: str, output: str = "out") -> "Workflow":
        # fail fast on endpoints that are already known; forward references
        # to not-yet-add()ed processes are fine and checked by validate()
        if src in self.processes and output not in self.processes[src].outputs:
            raise ValueError(
                f"connect: process {src!r} has no output {output!r} "
                f"(available: {sorted(self.processes[src].outputs)})")
        if dst in self.processes and dep not in self.processes[dst].data:
            raise ValueError(
                f"connect: process {dst!r} declares no data dependency "
                f"{dep!r} (declared: {sorted(self.processes[dst].data)})")
        self.edges.append(_Edge(src, output, dst, dep))
        return self

    def clone(self) -> "Workflow":
        """Shallow copy: shared process definitions, independent input maps.

        What-if paths mutate the clone's allocations/external inputs without
        touching the original (process objects are immutable by convention).
        """
        wf2 = Workflow()
        wf2.processes = dict(self.processes)
        wf2.resource_alloc = {k: dict(v) for k, v in self.resource_alloc.items()}
        wf2.external_data = {k: dict(v) for k, v in self.external_data.items()}
        wf2.edges = list(self.edges)
        wf2.gates = {k: list(v) for k, v in self.gates.items()}
        return wf2

    def set_data_input(self, proc: str, dep: str, fn: PPoly) -> "Workflow":
        self.external_data.setdefault(proc, {})[dep] = fn
        return self

    def set_resource_input(self, proc: str, res: str, fn: PPoly) -> "Workflow":
        self.resource_alloc.setdefault(proc, {})[res] = fn
        return self

    # -- analysis -------------------------------------------------------------
    def _topo_order(self) -> list[str]:
        deps: dict[str, set[str]] = {n: set() for n in self.processes}
        for e in self.edges:
            deps[e.dst].add(e.src)
        for n, gs in self.gates.items():
            deps[n].update(gs)
        order: list[str] = []
        ready = sorted(n for n, d in deps.items() if not d)
        deps = {n: set(d) for n, d in deps.items()}
        while ready:
            n = ready.pop()
            order.append(n)
            for m in list(deps):
                if n in deps[m]:
                    deps[m].discard(n)
                    if not deps[m] and m not in order and m not in ready:
                        ready.append(m)
            ready.sort()
        if len(order) != len(self.processes):
            stuck = sorted(set(self.processes) - set(order))
            raise ValueError(
                "workflow dependency graph has a cycle involving "
                f"{stuck}; connect()/start_after dependencies must form a "
                "DAG (the paper's stated limitation)")
        return order

    def validate(self) -> list[str]:
        """Check the workflow is analyzable; returns the topological order.

        Raises ``ValueError`` with an actionable message on: edges or gates
        naming unknown processes/outputs/deps, dependency cycles, data
        dependencies with neither a connect()ed producer nor a
        set_data_input() function, and declared resources without an
        allocated input function.
        """
        for e in self.edges:
            for role, n in (("source", e.src), ("destination", e.dst)):
                if n not in self.processes:
                    raise ValueError(
                        f"connect: unknown {role} process {n!r}; add() it "
                        f"(known: {sorted(self.processes)})")
            if e.output not in self.processes[e.src].outputs:
                raise ValueError(
                    f"connect: process {e.src!r} has no output {e.output!r} "
                    f"(available: {sorted(self.processes[e.src].outputs)})")
            if e.dep not in self.processes[e.dst].data:
                raise ValueError(
                    f"connect: process {e.dst!r} declares no data dependency "
                    f"{e.dep!r} (declared: {sorted(self.processes[e.dst].data)})")
        for name, gs in self.gates.items():
            for g in gs:
                if g not in self.processes:
                    raise ValueError(
                        f"start_after gate {g!r} of process {name!r} is "
                        f"unknown; add() it (known: {sorted(self.processes)})")
        order = self._topo_order()
        edge_deps = {(e.dst, e.dep) for e in self.edges}
        for name, proc in self.processes.items():
            for dep in proc.data:
                if ((name, dep) not in edge_deps
                        and dep not in self.external_data.get(name, {})):
                    raise ValueError(
                        f"process {name!r} is missing data input {dep!r}: "
                        "connect() an upstream output or provide it via "
                        "set_data_input()")
            for res in proc.resources:
                if res not in self.resource_alloc.get(name, {}):
                    raise ValueError(
                        f"process {name!r} has no allocation for resource "
                        f"{res!r}: pass resources={{...}} to add() or use "
                        "set_resource_input()")
        return order

    def compile(self, device=None) -> "CompiledWorkflow":
        """Compile-once front door: returns a query-many
        :class:`repro_torch.analysis.plan.CompiledWorkflow` that serves
        ``solve()``, ``sweep()``, ``whatif()``, ``bottleneck_fn()`` and
        ``gain()`` without re-deriving topo order, validation, scalar
        curves, or the kernel-ready array packing per call.  ``device``
        defaults to the CUDA card (see :mod:`repro_torch.device`)."""
        from repro_torch.analysis import compile_workflow

        return compile_workflow(self, device=device)

    def _solve_in_order(
        self,
        order: list[str],
        resource_overrides: dict[tuple[str, str], PPoly] | None = None,
        data_overrides: dict[tuple[str, str], PPoly] | None = None,
    ) -> dict[str, ProgressResult]:
        """The Algorithm-2 orchestration loop shared by :meth:`analyze` and
        the compiled plan's scalar path: gates set ``t0`` to the latest
        predecessor finish, edges wire upstream outputs into data inputs,
        overrides (keyed ``(process, name)``) replace external data inputs /
        resource allocations per query."""
        res_over = resource_overrides or {}
        data_over = data_overrides or {}
        results: dict[str, ProgressResult] = {}
        for name in order:
            proc = self.processes[name]
            t0 = 0.0
            for g in self.gates.get(name, []):
                f = results[g].finish_time
                if not np.isfinite(f):
                    raise ValueError(f"gate {g!r} of {name!r} never finishes")
                t0 = max(t0, f)
            data_inputs: dict[str, PPoly] = dict(self.external_data.get(name, {}))
            for (p, dep), fn in data_over.items():
                if p == name:
                    data_inputs[dep] = fn
            for e in self.edges:
                if e.dst == name:
                    data_inputs[e.dep] = results[e.src].output_function(e.output)
            rin = dict(self.resource_alloc.get(name, {}))
            for (p, res), fn in res_over.items():
                if p == name:
                    rin[res] = fn
            results[name] = solve(proc, data_inputs, rin, t0=t0)
        return results

    def analyze(self) -> WorkflowResult:
        order = self.validate()
        results = self._solve_in_order(order)
        makespan = max((r.finish_time for r in results.values()), default=0.0)
        return WorkflowResult(results=results, makespan=makespan, order=order)
