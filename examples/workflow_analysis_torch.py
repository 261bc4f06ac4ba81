"""Reproduce the paper's Sect. 5 evaluation end-to-end (Fig. 7 + Fig. 8), on the
torch port.

    PYTHONPATH=src python examples/workflow_analysis_torch.py [--device cpu]

The torch port's twin of ``examples/workflow_analysis.py``.  Sweeps the
link-rate split between the two downloads, compares BottleMod's predictions
(paper recipe AND the refined two-phase task-1 model, each share's pair
swept in one batch on ``--device``, the CUDA card by default) against the
chunk-level DES "measured" system, and prints the Fig. 8 bottleneck
structures.  Imports only the port.
"""

import argparse

from repro_torch.configs.paper_workflow import (build_workflow, compile_paper_plan,
                                                measure_makespan, sweep_scenarios)
from repro_torch.core import bottleneck_report

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = ap.parse_args()

FRACS = (0.1, 0.3, 0.5, 0.7, 0.9, 0.93, 0.95)
predicted = {}
for recipe in ("paper", "refined"):
    plan = compile_paper_plan(0.5, recipe=recipe, device=args.device)
    rep = plan.sweep(plan.prepare(sweep_scenarios(FRACS)), backend="torch")
    predicted[recipe] = dict(zip(FRACS, rep.makespans))

print("=== Fig. 7: total execution time vs task-1 link share ===")
print(f"{'share':>6} {'paper model':>12} {'refined':>9} {'DES (meas.)':>12}")
for frac in FRACS:
    des, _ = measure_makespan(frac)
    print(f"{frac:6.2f} {predicted['paper'][frac]:12.1f} "
          f"{predicted['refined'][frac]:9.1f} {des:12.1f}")

m50, m93 = predicted["paper"][0.5], predicted["paper"][0.93]
print(f"\npredicted improvement 50% -> 93%: {100 * (1 - m93 / m50):.1f}%  (paper: 32%)")

for frac in (0.5, 0.95):
    print(f"\n=== Fig. 8 bottleneck structure at {int(frac * 100)}% ===")
    wr = build_workflow(frac).analyze()
    for b in bottleneck_report(wr):
        print(f"  {b.process:6s} limited by {b.kind}:{b.name:5s} "
              f"for {b.seconds:6.1f}s ({b.fraction:4.0%} of its runtime)")
