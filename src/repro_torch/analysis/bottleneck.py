"""The overall piecewise-defined bottleneck function — paper Sect. 6/8.

BottleMod derives the bottleneck function "from the discrete intersections
of the task models' limiting functions" (abstract): at every instant of the
workflow's runtime exactly one limiting factor of one process holds the
*makespan* back.  :func:`derive_bottleneck_fn` materializes that function
for a solved workflow by walking the critical path backwards:

* start at the sink process (the one whose finish time IS the makespan),
* its solver segments attribute every instant of ``[t_start, finish)`` to a
  limiting data input or resource,
* its start time, when gated, was set by the latest-finishing predecessor —
  recurse into that predecessor for the earlier interval.

Pipelined (``connect``-ed) dependencies need no recursion: a data-limited
segment already names the upstream output as the limiting factor, and the
interval's ``source`` field resolves it to the producing process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core.ppoly import TIME_TOL

if TYPE_CHECKING:
    from repro_torch.core.solver import ProgressResult

__all__ = ["BottleneckFn", "BottleneckInterval", "derive_bottleneck_fn"]


@dataclass(frozen=True)
class BottleneckInterval:
    """One maximal interval of the overall bottleneck function."""

    t_start: float
    t_end: float
    process: str
    kind: str            # "data" | "resource"
    name: str            # the limiting input/resource of ``process``
    source: str | None = None  # producing process when the data dep is an edge

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclass
class BottleneckFn:
    """The workflow's overall bottleneck as a piecewise-defined function.

    Callable: ``fn(t)`` returns the :class:`BottleneckInterval` active at
    time ``t`` (None outside ``[0, makespan)``).  Iterable over intervals.
    """

    intervals: list[BottleneckInterval]
    makespan: float

    def __call__(self, t: float) -> BottleneckInterval | None:
        for iv in self.intervals:
            if iv.t_start - TIME_TOL <= t < iv.t_end:
                return iv
        return None

    def __iter__(self) -> Iterator[BottleneckInterval]:
        return iter(self.intervals)

    def table(self) -> list[tuple[float, float, str, str, str]]:
        """``(t0, t1, process, kind, name)`` rows, ascending in time."""
        return [(iv.t_start, iv.t_end, iv.process, iv.kind, iv.name)
                for iv in self.intervals]

    def dominant(self) -> BottleneckInterval:
        """The interval that holds the makespan back the longest."""
        return max(self.intervals, key=lambda iv: iv.seconds)


def derive_bottleneck_fn(
    results: Mapping[str, ProgressResult],
    edge_sources: Mapping[tuple[str, str], str],
    gates: Mapping[str, Sequence[str]],
) -> BottleneckFn:
    """Critical-path walk over one scalar solve (see module docstring).

    ``edge_sources`` maps ``(process, data_dep) -> producing process`` for
    every pipelined edge; ``gates`` maps a process to its ``start_after``
    predecessors.
    """
    if not results:
        return BottleneckFn(intervals=[], makespan=0.0)
    sink = max(results, key=lambda n: results[n].finish_time)
    makespan = float(results[sink].finish_time)

    intervals: list[BottleneckInterval] = []
    cur: str | None = sink
    hi = makespan
    visited: set[str] = set()
    while cur is not None and cur not in visited:
        visited.add(cur)
        r = results[cur]
        lo = float(r.t_start)
        for s in r.segments:
            a = max(float(s.t_start), lo)
            b = min(float(s.t_end), hi)
            if not b > a + TIME_TOL:
                continue
            src = edge_sources.get((cur, s.name)) if s.kind == "data" else None
            intervals.append(BottleneckInterval(a, b, cur, s.kind, s.name, src))
        if lo <= TIME_TOL:
            break
        gs = list(gates.get(cur, []))
        finite = [g for g in gs if np.isfinite(results[g].finish_time)]
        if not finite:
            break
        hi = lo
        cur = max(finite, key=lambda g: results[g].finish_time)
    intervals.sort(key=lambda iv: iv.t_start)
    return BottleneckFn(intervals=intervals, makespan=makespan)
