"""Compile-once / query-many: the Analysis API front door, over the torch port.

    PYTHONPATH=src python examples/compile_once_torch.py [--device cpu]

The torch port's twin of ``examples/compile_once.py``.  BottleMod's pitch
(Sect. 6/8) is that building the model is the expensive part and every
question after that is nearly free: ``workflow.compile(device=...)``
performs validation, topo-sort, curve derivation and array packing ONCE,
then the plan serves scalar solves, batched sweeps (the level-fused torch
engine on ``--device``, the CUDA card by default), one-off what-ifs, the
piecewise overall bottleneck function, and bottleneck-gain estimates — all
returning one `Report` type.  Imports only the port.
"""

import argparse
import time
import warnings

import numpy as np

from repro_torch import sweep
from repro_torch.analysis import scenarios
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = ap.parse_args()

# -- compile once -------------------------------------------------------------
base = build_workflow(0.5)
t0 = time.perf_counter()
plan = base.compile(device=args.device)
print(f"compiled the Sect. 5 workflow in {(time.perf_counter() - t0) * 1e3:.2f} ms")

# -- scalar solve -------------------------------------------------------------
rep = plan.solve()
print(f"\nbase makespan: {rep.makespan:.1f} s "
      f"(task3 finishes at {rep.finish('task3'):.1f} s)")

# -- the paper's piecewise overall bottleneck function ------------------------
print("\n=== overall bottleneck function over runtime (Sect. 6/8) ===")
for iv in plan.bottleneck_fn():
    via = f" (fed by {iv.source})" if iv.source else ""
    print(f"  {iv.t_start:7.1f}s – {iv.t_end:7.1f}s  {iv.process}:"
          f"{iv.kind}:{iv.name}{via}")

# -- "what do I gain if I remove this bottleneck?" ----------------------------
print("\n=== gain from relaxing each bottleneck (2x) ===")
for iv in plan.bottleneck_fn():
    print(f"  2x {iv.process}.{iv.name:6s} -> gain {plan.gain(iv):6.1f} s")

# -- one-off what-if ----------------------------------------------------------
w = plan.whatif(**{"task1.cpu": 2.0})
print(f"\nwhat-if task1 gets 2x CPU: makespan {w.makespan:.1f} s "
      f"({rep.makespan - w.makespan:+.1f} s)")

# -- scenario DSL + batched sweeps on the SAME plan, on the device ------------
g = scenarios.grid({"task1.cpu": [1.0, 2.0, 4.0], "dl1.link": [0.5, 1.0, 2.0]})
rg = plan.sweep(plan.prepare(g))
print(f"\nswept a {len(g)}-cell grid; best: {rg.top_k(1)[0]}")

scs = sweep_scenarios(np.linspace(0.02, 0.98, 600))
pack = plan.prepare(scs)
plan.sweep(pack)  # warm
reps = 5
t0 = time.perf_counter()
for _ in range(reps):
    res = plan.sweep(pack)
dt_plan = (time.perf_counter() - t0) / reps
t0 = time.perf_counter()
with warnings.catch_warnings():          # the shim warns: it is deprecated
    warnings.simplefilter("ignore", DeprecationWarning)
    for _ in range(reps):
        # the legacy shim: re-compiles every call
        sweep.analyze(base, scs, device=args.device)
dt_shim = (time.perf_counter() - t0) / reps
print(f"resweep of 600 scenarios: compiled plan {dt_plan * 1e3:.1f} ms vs "
      f"legacy analyze {dt_shim * 1e3:.1f} ms "
      f"({dt_shim / dt_plan:.2f}x, same results)")
print(f"winner: {res.top_k(1)[0][1]} at {res.top_k(1)[0][2]:.1f} s; "
      f"all scenarios on the {res.backend!r} backend")
