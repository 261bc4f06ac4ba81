"""Gradient allocation search: ``plan.optimize`` vs the Fig. 7 grid, on the
torch port.

    PYTHONPATH=src python examples/optimize_allocations_torch.py [--device cpu]

The torch port's twin of ``examples/optimize_allocations.py``.  The paper
answers "which link prioritization is best?" by sweeping 600 candidate
fractions (Fig. 7).  Because the sweep is one differentiable PyTorch
program on ``--device`` (the CUDA card by default), the same question has a
cheaper answer: expose the fraction as a parameter ``theta``, read the
makespan's gradient out of the sweep with ``torch.autograd``, and walk
downhill — each optimizer step scores its whole candidate ladder as ONE
batched sweep.  The optimizer lands on the same optimum as the grid while
evaluating an order of magnitude fewer candidates, and the same API
minimizes the *p95* makespan under the risk model instead of the point
estimate (same draws for every candidate — common random numbers — so
candidate ranking is never sampling noise).  Imports only the port.
"""

import argparse
import time

import numpy as np

from repro_torch.analysis import cap_space, mc_quantile
from repro_torch.configs.paper_workflow import (compile_paper_plan, fig7_space,
                                                mc_spec, sweep_scenarios)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = ap.parse_args()

plan = compile_paper_plan(0.5, device=args.device)

# -- the paper's grid, for reference ------------------------------------------
fracs = np.linspace(0.02, 0.98, 600)
t0 = time.perf_counter()
grid = plan.sweep(plan.prepare(sweep_scenarios(fracs)), backend="torch").makespan
dt_grid = time.perf_counter() - t0
gi = int(np.argmin(grid))
print(f"grid:      600 evals in {dt_grid:.2f} s -> "
      f"frac={fracs[gi]:.4f} makespan={grid[gi]:.2f} s")

# -- gradient search over the same 1-D space ----------------------------------
# fig7_space() exposes the link split as theta[0]: dl1 gets theta*LINK,
# dl2 gets the complement until its file is done, then the full link.
t0 = time.perf_counter()
opt = plan.optimize(space=fig7_space())
dt_opt = time.perf_counter() - t0
print(f"optimize:  {opt.evals:3d} evals ({opt.sweeps} fused sweeps, "
      f"{opt.iters} iters) in {dt_opt:.2f} s -> "
      f"frac={float(opt.theta[0]):.4f} makespan={opt.value:.2f} s")
print(f"           same optimum as the grid at "
      f"{600 / opt.evals:.0f}x fewer evaluations\n")
print(opt.summary())

# -- multi-dimensional: no grid survives this ---------------------------------
# Scaling three resource caps at once would need 600^3 grid cells; the
# gradient search just gets a 3-vector theta.
space = cap_space(["task1.cpu", "task2.cpu", "dl1.link"], lo=0.25, hi=2.0)
opt3 = plan.optimize(space=space, starts=2)
print(f"\n3-D cap search: {opt3.evals} evals -> "
      + ", ".join(f"{n}={v:.3f}" for n, v in zip(space.names, opt3.theta))
      + f" makespan={opt3.value:.2f} s (baseline {opt3.baseline:.2f} s)")

# -- risk-aware: minimize the p95 makespan, not the point estimate ------------
risky = plan.optimize(mc_quantile(mc_spec(), q=0.95, n=256, seed=0),
                      cap_space(["task1.cpu"], lo=0.5, hi=2.0))
print(f"\np95-optimal task1.cpu scale: {float(risky.theta[0]):.3f} "
      f"(p95 {risky.value:.2f} s, down from {risky.baseline:.2f} s at the "
      f"nominal allocation; gain {risky.gain:.2f} s)")
