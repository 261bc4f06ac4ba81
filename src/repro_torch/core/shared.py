"""Shared-resource (link) management — paper §3.4 / §5.2 (the torch
port's numpy copy).

"Like a scheduler allocates CPU usage and guarantees that the sum does not
exceed the available CPU time, the input functions for transfer processes
that share a network link would have to be managed accordingly" (§3.4).

The paper's §5.2 evaluation does this by hand: task 1's download gets its
fraction, and "after analyzing that process, the consumed data rate is set
for the process retrospectively ... allowing assigning the other download
process the rest".  :func:`sequential_allocation` generalizes exactly that
procedure to any priority-ordered set of processes sharing a capacity:

1. allocate process i  ``min(requested_i(t), remaining(t))``,
2. analyze it (Algorithm 2),
3. compute its *actual* consumption rate ``P'(t) · R'_Rl(P(t))`` (eq. 4) as
   an exact piecewise polynomial,
4. subtract it from the remaining capacity and move to process i+1.

Freed capacity (a finished download) therefore flows to later processes
automatically — no hand-derived release times.
"""

from __future__ import annotations

import numpy as np

from .ppoly import PPoly
from .solver import ProgressResult, solve
from .workflow import Workflow


def usage_rate(res: ProgressResult, resource: str) -> PPoly:
    """Exact eq.-(4) consumption rate ``P'(t)·R'_Rl(P(t))`` as a PPoly."""
    dP = res.progress.derivative()
    dR = res.process.resources[resource].requirement.derivative()
    # R' is piecewise-constant in p; composing with monotone P gives a
    # piecewise-constant function of t, multiplied piecewise by P'.
    dR_of_t = PPoly.compose(dR, res.progress)
    return PPoly.multiply(dP, dR_of_t)


def sequential_allocation(wf: Workflow, users: list[tuple[str, str, PPoly]],
                          capacity: float) -> dict[str, ProgressResult]:
    """Allocate a shared capacity to ``users = [(process, resource,
    requested_rate)]`` in priority order, each seeing what the previous ones
    actually consume.  Sets the resulting input functions on ``wf`` and
    returns the per-process analysis used during allocation.

    Processes must not depend on each other's data outputs (the paper's two
    downloads are independent); the workflow is re-analyzed afterwards as
    usual.
    """
    remaining = PPoly.constant(capacity)
    out: dict[str, ProgressResult] = {}
    for name, resource, requested in users:
        alloc, _ = PPoly.minimum([requested, remaining])
        alloc = alloc.clip_min(0.0)
        wf.set_resource_input(name, resource, alloc)
        proc = wf.processes[name]
        data_inputs = dict(wf.external_data.get(name, {}))
        res = solve(proc, data_inputs, wf.resource_alloc[name])
        out[name] = res
        used = usage_rate(res, resource)
        remaining = (remaining - used).clip_min(0.0).simplify()
    return out


def total_usage(results: dict[str, ProgressResult], resource: str,
                ts: np.ndarray) -> np.ndarray:
    """Summed eq.-(4) consumption of all users at ``ts`` (validation aid)."""
    tot = np.zeros_like(np.asarray(ts, dtype=float))
    for r in results.values():
        tot += usage_rate(r, resource)(ts)
    return tot
