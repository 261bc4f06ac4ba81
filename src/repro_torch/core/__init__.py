"""BottleMod core — faithful implementation of the paper's process model
(the torch port's own numpy copy; it loads no torch).

Public API:

* :class:`PPoly` — exact piecewise-polynomial algebra.
* :class:`Process`, :class:`DataDep`, :class:`ResourceDep` — Sect. 2 models.
* :func:`solve` — Algorithm 2 (exact, event-driven); :func:`solve_euler`,
  :func:`solve_alg1` — numeric references.
* :class:`Workflow` — Sect. 3.4 process chaining.
* :func:`bottleneck_report`, :func:`potential_gains` — Sect. 3.3 analyses.
* :func:`sequential_allocation` — §3.4/§5.2 shared-link allocation.
* ``des`` module — chunk-level discrete-event "measured system" stand-in.
"""

from .ppoly import PPoly
from .process import DataDep, Process, ResourceDep
from .solver import ProgressResult, Segment, solve, solve_alg1, solve_euler
from .workflow import Workflow, WorkflowResult
from .bottleneck import (BottleneckShare, bottleneck_report, potential_gains,
                         whatif_scale_resource)
from .shared import sequential_allocation, total_usage, usage_rate

__all__ = [
    "PPoly", "Process", "DataDep", "ResourceDep",
    "solve", "solve_euler", "solve_alg1", "ProgressResult", "Segment",
    "Workflow", "WorkflowResult",
    "BottleneckShare", "bottleneck_report", "potential_gains",
    "whatif_scale_resource",
    "sequential_allocation", "usage_rate", "total_usage",
]
