"""Risk-aware analysis: Monte Carlo quantiles, SLOs, and sensitivity, on the
torch port.

    PYTHONPATH=src python examples/risk_analysis_torch.py [--device cpu] [--shards N]

The torch port's twin of ``examples/risk_analysis.py``.  Point estimates hide risk: the paper workflow's makespan is a single number
only if every link and CPU delivers exactly its nominal rate.  ``plan.mc``
replaces scalar what-ifs with *distributions* — each resource cap or data
input becomes a ``dist.*`` draw, every draw materializes as one scenario on
the batch axis, and the whole sample runs as one sweep of the level-fused
torch engine on ``--device`` (the CUDA card by default; ``--shards`` splits
the draw axis, ``ScenarioPack.shard``).  The
resulting ``MCReport`` answers the operator questions directly: "what is the
p95 makespan?", "how likely do we miss the SLO?", "which factor's
uncertainty should we buy down first?".  Imports only the port.
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.analysis import AnalysisService, dist
from repro_torch.configs.paper_workflow import build_workflow, mc_spec

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
ap.add_argument("--shards", type=int, default=None, help="sub-batches of the draw axis")
args = ap.parse_args()

plan = build_workflow(0.5).compile(device=args.device)

# -- the workflow's uncertainty model -----------------------------------------
# mc_spec() is the paper workflow's default risk model: lognormal jitter on
# the links and task1's CPU, uniform contention on task2, triangular timing
# noise on the remote input size.  Every distribution stays inside the
# batched quadratic function class, so 10k draws are one engine sweep.
spec = mc_spec()
N = 4096

t0 = time.perf_counter()
mc = plan.mc(spec, n=N, seed=0, shards=args.shards)
dt = time.perf_counter() - t0
print(f"{N} Monte Carlo draws in {dt:.2f} s ({dt / N * 1e6:.0f} us/draw, "
      f"{mc.fallback_count} draws off the fast path)")

# -- makespan quantiles + SLO queries -----------------------------------------
q = mc.quantiles()
print(f"\nmakespan p50={q['p50']:.1f}s p95={q['p95']:.1f}s p99={q['p99']:.1f}s")
slo = 1.10 * mc.p50
print(f"P(makespan <= {slo:.0f}s) = {mc.prob(makespan_le=slo):.3f}   "
      f"P(makespan > p95) = {mc.prob(makespan_gt=mc.p95):.3f}")

# -- which bottleneck dominates, and how often --------------------------------
print("\n=== bottleneck-attribution probabilities ===")
for a in mc.attribution()[:4]:
    print(f"  {a.label:18s} dominant in {a.p_dominant:6.1%} of draws "
          f"(active in {a.p_active:6.1%}, mean {a.mean_seconds:6.1f}s)")

# -- which factor's uncertainty to buy down first -----------------------------
print("\n=== sensitivity ranking (first-order variance share / Spearman) ===")
for s in mc.sensitivity():
    print(f"  {s.axis:18s} s1={s.s1:5.2f}  rho={s.rho:+.2f}")

# -- stratified comparison: two candidate mitigations, one sample -------------
# A spec LIST runs as strata of one MC sample: same seed, contiguous draw
# blocks per group — here "as-is" vs "provision 2x CPU for task1".
mitigated = dataclasses.replace(
    spec, label="2x-cpu",
    resources={**spec.resources,
               ("task1", "cpu"): dist.lognormal(median=2.0, sigma=0.2)})
both = plan.mc([spec, mitigated], n=N, seed=0, shards=args.shards)
groups = np.array([lab.rsplit("#", 1)[0] for lab in both.report.labels])
print()
for lbl in dict.fromkeys(groups):
    mk = both.makespans[groups == lbl]
    print(f"{lbl}: p95 = {float(np.quantile(mk, 0.95)):.1f}s "
          f"over {mk.size} draws")

# -- same question, through the analysis service ------------------------------
with AnalysisService(device=args.device) as svc:
    mc2 = svc.query_mc(mc_spec(), n=1024, workflow=build_workflow(0.5))
    print(f"\nservice submit_mc: p95={mc2.p95:.1f}s "
          f"(chunked through the coalescing worker, "
          f"{svc.snapshot()['sweeps']} sweep(s))")

print("\n" + mc.summary())
