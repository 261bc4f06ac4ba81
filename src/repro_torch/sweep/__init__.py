"""Batched what-if scenario sweeps: the lockstep engines behind
``CompiledWorkflow.sweep``.

* :mod:`.engine` — the vectorized numpy lockstep engine, the reference
  backend (``backend="numpy"``);
* :mod:`.torch_engine` — the same event loop stacked per topology level in
  float64 torch ops on the plan's device (``backend="torch"``);
* :mod:`.plin` — the batched piecewise-polynomial algebra both share;
* :mod:`.batch` — scenario deltas and their validation.
"""

from __future__ import annotations

from .batch import Scenario, ScenarioBatch
from .engine import BatchProcResult, solve_batch
from .plin import BPL, UnsupportedScenario, compose_scalar

__all__ = [
    "Scenario", "ScenarioBatch", "BatchProcResult", "BPL",
    "UnsupportedScenario", "solve_batch", "compose_scalar",
]
