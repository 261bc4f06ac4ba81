"""Carrying workflows and scenarios across from another implementation.

The functions here rebuild this package's objects from any objects with the
same attributes — the reference implementation's ``Workflow`` / ``Process``
/ ``Scenario``, say — without importing that implementation.  Every
piecewise polynomial crosses as its ``(starts, coeffs)`` numpy arrays, so
both sides compute on the same numbers.  The parity tests use them to feed
one workflow to two implementations.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from .ppoly import PPoly
from .process import DataDep, Process, ResourceDep
from .workflow import Workflow, _Edge

__all__ = ["ppoly_from_arrays", "scenarios_from_arrays",
           "workflow_from_arrays"]


def ppoly_from_arrays(fn: Any) -> PPoly:
    """A :class:`PPoly` from anything with ``starts`` and ``coeffs`` arrays."""
    return PPoly(np.array(fn.starts, np.float64), np.array(fn.coeffs, np.float64))


def _fns(d: dict) -> dict:
    return {k: ppoly_from_arrays(f) for k, f in d.items()}


def workflow_from_arrays(wf: Any) -> Workflow:
    """Rebuild a workflow: ``processes`` (``data`` / ``resources`` /
    ``outputs`` / ``total_progress``), ``resource_alloc``,
    ``external_data``, ``edges`` and ``gates``, in their original order."""
    out = Workflow()
    for name, proc in wf.processes.items():
        out.processes[name] = Process(
            name=proc.name,
            data={d: DataDep(ppoly_from_arrays(dd.requirement))
                  for d, dd in proc.data.items()},
            resources={r: ResourceDep(ppoly_from_arrays(rd.requirement))
                       for r, rd in proc.resources.items()},
            outputs=_fns(proc.outputs),
            total_progress=float(proc.total_progress))
    out.resource_alloc = {n: _fns(d) for n, d in wf.resource_alloc.items()}
    out.external_data = {n: _fns(d) for n, d in wf.external_data.items()}
    out.edges = [_Edge(e.src, e.output, e.dst, e.dep) for e in wf.edges]
    out.gates = {n: list(g) for n, g in wf.gates.items()}
    return out


def scenarios_from_arrays(scenarios: Iterable[Any]) -> list:
    """Rebuild resolved scenarios (``label``, ``resource_inputs``,
    ``data_inputs``) as :class:`repro_torch.sweep.batch.Scenario` objects."""
    from repro_torch.sweep.batch import Scenario

    return [Scenario(label=sc.label,
                     resource_inputs=_fns(sc.resource_inputs),
                     data_inputs=_fns(sc.data_inputs))
            for sc in scenarios]
