"""Bottleneck analysis & what-if estimation — BottleMod Sect. 3.3 / Sect. 8.

The progress solver already attributes every time interval to the limiting
data input or resource (the piecewise-defined bottleneck function derived
"from the discrete intersections of the task models' limiting functions",
abstract).  This module aggregates those attributions across a workflow and
quantifies the *potential performance gain* from overcoming a bottleneck —
the paper's headline use case for schedulers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ppoly import PPoly
from .workflow import Workflow, WorkflowResult


@dataclass
class BottleneckShare:
    process: str
    kind: str        # "data" | "resource"
    name: str
    seconds: float
    fraction: float  # of that process's runtime


def aggregate_segments(segments, t_start: float, finish: float):
    """Seconds attributed to each ``(kind, name)`` limiting factor.

    Aggregation core of the scalar report below: clips every segment to the
    effective finish (for never-finishing processes: the start of the last,
    open-ended segment) and accumulates per factor.  Returns ``(acc,
    total)``.  The batched sweep engine mirrors exactly these semantics,
    vectorized over scenarios, in ``repro_torch.sweep.engine._aggregate_shares`` —
    keep the two in sync (the sweep tests assert their agreement).
    """
    fin = finish if np.isfinite(finish) else max(
        (s.t_end for s in segments if np.isfinite(s.t_end)), default=t_start)
    total = max(fin - t_start, 1e-12)
    acc: dict[tuple[str, str], float] = {}
    for s in segments:
        t1 = min(s.t_end, fin)
        if t1 > s.t_start:
            acc[(s.kind, s.name)] = acc.get((s.kind, s.name), 0.0) + (t1 - s.t_start)
    return acc, total


def bottleneck_report(wr: WorkflowResult) -> list[BottleneckShare]:
    """Time each limiting factor holds a process back, sorted by share."""
    out: list[BottleneckShare] = []
    for pname, r in wr.results.items():
        acc, total = aggregate_segments(r.segments, r.t_start, r.finish_time)
        for (kind, name), secs in acc.items():
            out.append(BottleneckShare(pname, kind, name, secs, secs / total))
    out.sort(key=lambda b: -b.seconds)
    return out


def whatif_scale_resource(wf: Workflow, proc: str, res: str, factor: float) -> WorkflowResult:
    """Re-analyze the workflow with one resource allocation scaled.

    This is the paper's "potential performance gain when the bottleneck is
    resolved": because re-analysis is nearly free (Sect. 6), a scheduler can
    simply try candidate allocations.
    """
    wf2 = _clone(wf)
    wf2.resource_alloc[proc][res] = wf.resource_alloc[proc][res] * factor
    return wf2.analyze()


def potential_gains(wf: Workflow, base: WorkflowResult | None = None,
                    factor: float = 2.0) -> list[tuple[str, str, float, float]]:
    """For every (process, resource) pair: makespan if that allocation is
    scaled by ``factor``.  Returns ``(process, resource, new_makespan,
    gain_seconds)`` sorted by gain."""
    base = base or wf.analyze()
    out = []
    for pname in wf.processes:
        for res in wf.resource_alloc.get(pname, {}):
            wr = whatif_scale_resource(wf, pname, res, factor)
            out.append((pname, res, wr.makespan, base.makespan - wr.makespan))
    out.sort(key=lambda x: -x[3])
    return out


def _clone(wf: Workflow) -> Workflow:
    """Back-compat alias for :meth:`Workflow.clone`."""
    return wf.clone()
