"""Batched what-if allocation sweep over the paper's Sect. 5 workflow, on the
torch port, sharded over every visible card.

    PYTHONPATH=src python examples/sweep_allocations_torch.py [--device cpu] [--shards N]

The torch port's twin of ``examples/sweep_allocations.py``.  The paper's
headline use case (Sect. 6/8): analysis is cheap enough to try *many*
candidate resource allocations and pick the best.  This demo compiles the
workflow once, prepares 600 link prioritizations (Fig. 7's grid), shards
the pack (``pack.shard()``: one sub-batch per visible CUDA card, shard i on
``cuda:i``; one on the CPU unless ``--shards`` says otherwise), sweeps it
with the level-fused torch engine, ranks the allocations, prints the
winner's bottleneck structure, and shows the batched curve queries (the
hand-written ``ppoly_eval`` kernels on the card).  Imports only the port.
"""

import argparse
import time

import numpy as np

from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
ap.add_argument("--shards", type=int, default=None,
                help="sub-batches of the sweep (default: every visible card; 1 on the CPU)")
args = ap.parse_args()

B = 600
fracs = np.linspace(0.02, 0.98, B)
plan = build_workflow(0.5).compile(device=args.device)   # topo/validation/packing: once
scenarios = sweep_scenarios(fracs)
pack = plan.prepare(scenarios).shard(args.shards)
plan.sweep(pack, backend="torch")                        # warm: device arrays, caps

t0 = time.perf_counter()
res = plan.sweep(pack, backend="torch")
dt = time.perf_counter() - t0
print(f"analyzed {B} scenarios in {dt * 1e3:.1f} ms "
      f"({dt / B * 1e6:.0f} us/scenario, torch engine on {plan.device}, "
      f"{pack.shards} shard(s))")

t0 = time.perf_counter()
loop = plan.sweep(scenarios[::60], backend="loop")
us_loop = (time.perf_counter() - t0) / len(loop.makespan) * 1e6
print(f"looped scalar solver: {us_loop:.0f} us/scenario "
      f"-> {us_loop / (dt / B * 1e6):.0f}x slower per scenario")

print("\n=== top-5 allocations by predicted makespan ===")
for i, label, makespan in res.top_k(5):
    print(f"  {label}: {makespan:.1f}s")

best = res.best()
print(f"\n=== bottleneck structure of the winner ({res.labels[best]}) ===")
for row in res.bottleneck_report(best):
    print(f"  {row.process:6s} limited by {row.kind}:{row.name:5s} "
          f"for {row.seconds:6.1f}s ({row.fraction:4.0%} of its runtime)")

# batched curve queries run on the ppoly kernels: every scenario's progress
# curve / data ceiling in one call
ts = np.linspace(0.0, 300.0, 128)
curves = res.sample_progress("task1", ts)          # (B, 128) via ppoly_eval
ceil, limiter = res.data_ceiling("task3", ts)      # min_k + argmin attribution
fin = res.kernel_finish_times("task3")             # batched first-crossing
print(f"\nsampled {curves.shape[0]}x{curves.shape[1]} progress points; "
      f"task3 finish via kernel first-crossing matches engine to "
      f"{np.max(np.abs(fin - res.finish['task3']) / res.finish['task3']):.1e} rel")
