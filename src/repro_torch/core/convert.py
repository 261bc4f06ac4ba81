"""Carrying workflows and scenarios across from another implementation.

The functions here rebuild this package's objects from any objects with the
same attributes — the reference implementation's ``Workflow`` / ``Process``
/ ``Scenario``, say — without importing that implementation.  Every
piecewise polynomial crosses as its ``(starts, coeffs)`` numpy arrays, so
both sides compute on the same numbers.  The parity tests use them to feed
one workflow to two implementations.

:func:`workflow_record` and :func:`workflow_from_record` carry a workflow
to disk and back the same way: its structure as plain JSON-ready lists,
every function's ``(starts, coeffs)`` as slices of one float64 array, in
the workflow's own order — the plan artifact's form
(:mod:`repro_torch.analysis.artifacts`).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from .ppoly import PPoly
from .process import DataDep, Process, ResourceDep
from .workflow import Workflow, _Edge

__all__ = ["ppoly_from_arrays", "scenarios_from_arrays",
           "workflow_from_arrays", "workflow_from_record", "workflow_record"]


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


def workflow_record(wf: Any) -> tuple[dict, np.ndarray]:
    """``wf`` as ``(structure, flat)``: a JSON-ready dict in the workflow's
    own order, each function in it an ``[offset, pieces, degree + 1]``
    reference into ``flat``, the float64 concatenation of every function's
    ``starts`` then row-major ``coeffs``.  Equal workflows give equal
    records, so the bytes of both are deterministic."""
    chunks: list[np.ndarray] = []
    size = [0]

    def ref(fn: Any) -> list[int]:
        starts = np.ascontiguousarray(fn.starts, np.float64)
        coeffs = np.ascontiguousarray(fn.coeffs, np.float64)
        out = [size[0], int(coeffs.shape[0]), int(coeffs.shape[1])]
        chunks.extend((starts, coeffs.ravel()))
        size[0] += starts.size + coeffs.size
        return out

    def fns(d: dict) -> list:
        return [[k, ref(f)] for k, f in d.items()]

    structure = {
        "processes": [
            {"key": key, "name": p.name,
             "total_progress": float(p.total_progress),
             "data": [[d, ref(dd.requirement)] for d, dd in p.data.items()],
             "resources": [[r, ref(rd.requirement)]
                           for r, rd in p.resources.items()],
             "outputs": fns(p.outputs)}
            for key, p in wf.processes.items()],
        "resource_alloc": [[n, fns(d)] for n, d in wf.resource_alloc.items()],
        "external_data": [[n, fns(d)] for n, d in wf.external_data.items()],
        "edges": [[e.src, e.output, e.dst, e.dep] for e in wf.edges],
        "gates": [[n, list(g)] for n, g in wf.gates.items()],
    }
    flat = np.concatenate(chunks) if chunks else np.zeros(0)
    return structure, flat


def workflow_from_record(structure: dict, flat: np.ndarray) -> Workflow:
    """Inverse of :func:`workflow_record`: every function bit for bit."""
    flat = np.asarray(flat, np.float64)

    def fn(r: list) -> PPoly:
        off, n, k = (int(x) for x in r)
        if off < 0 or off + n + n * k > flat.size:
            raise ValueError(f"function reference {r} outside the array")
        return PPoly(flat[off:off + n].copy(),
                     flat[off + n:off + n + n * k].reshape(n, k).copy())

    def fns(pairs: list) -> dict:
        return {k: fn(r) for k, r in pairs}

    out = Workflow()
    for p in structure["processes"]:
        out.processes[p["key"]] = Process(
            name=p["name"],
            data={d: DataDep(fn(r)) for d, r in p["data"]},
            resources={r: ResourceDep(fn(x)) for r, x in p["resources"]},
            outputs=fns(p["outputs"]),
            total_progress=float(p["total_progress"]))
    out.resource_alloc = {n: fns(d) for n, d in structure["resource_alloc"]}
    out.external_data = {n: fns(d) for n, d in structure["external_data"]}
    out.edges = [_Edge(*e) for e in structure["edges"]]
    out.gates = {n: list(g) for n, g in structure["gates"]}
    return out
