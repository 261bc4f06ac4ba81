"""Quickstart: model a two-task pipeline with BottleMod and find its bottleneck.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The torch port's twin of ``examples/quickstart.py``: builds the paper's
canonical pattern — a rate-limited download feeding a burst consumer —
solves the progress functions exactly (Algorithm 2), prints the bottleneck
timeline and the what-if gain from upgrading each resource.  The what-ifs
run as one prepared sweep on ``--device`` (the CUDA card by default).
Imports only the port.
"""

import argparse

import numpy as np

from repro_torch.analysis import scenarios
from repro_torch.core import DataDep, PPoly, Process, ResourceDep, Workflow

GB = 1e9

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = ap.parse_args()

# --- a 2 GB file behind a 100 MB/s link --------------------------------------
download = Process(
    "download",
    data={"remote_file": DataDep.stream(2 * GB, 2 * GB)},
    resources={"link": ResourceDep.stream(2 * GB, 2 * GB)},  # 1 byte of link per byte
    total_progress=2 * GB,
).identity_output()

# --- a reverse-style consumer: needs ALL input, then 60 s of CPU -------------
consumer = Process(
    "process",
    data={"video": DataDep.burst(2 * GB, 500e6)},            # output: 500 MB
    resources={"cpu": ResourceDep.stream(60.0, 500e6)},      # 60 CPU-seconds total
    total_progress=500e6,
).identity_output()

wf = Workflow()
wf.add(download, resources={"link": PPoly.constant(100e6)})  # 100 MB/s
wf.set_data_input("download", "remote_file", PPoly.constant(2 * GB))
wf.add(consumer, resources={"cpu": PPoly.constant(1.0)})     # 1 core
wf.connect("download", "process", "video")
plan = wf.compile(device=args.device)   # the what-if sweep's plan, on the device

result = wf.analyze()
print(f"makespan: {result.makespan:.1f} s "
      f"(download {result.finish('download'):.1f} s, process {result.finish('process'):.1f} s)")
print("\nbottleneck timeline:")
for t0, t1, proc, kind, name in result.bottleneck_timeline():
    print(f"  {t0:7.1f}s – {t1:7.1f}s  {proc:9s} limited by {kind}:{name}")

print("\nbuffered-but-unused input of 'process' at t=10s/19s:",
      result.results["process"].buffered_data("video", np.array([10.0, 19.0])))

# --- every resource doubled, one scenario each, in ONE sweep on the device ---
pairs = [(p, r) for p in wf.processes for r in wf.resource_alloc.get(p, {})]
specs = [s for p, r in pairs for s in scenarios.scale_resource(p, r, [2.0])]
whatif = plan.sweep(plan.prepare(specs))
gains = sorted(((p, r, float(m), result.makespan - float(m))
                for (p, r), m in zip(pairs, whatif.makespans)),
               key=lambda x: -x[3])
print("\nwhat-if (double each resource):")
for proc, res, new_makespan, gain in gains:
    print(f"  2x {proc}/{res:<6s} -> makespan {new_makespan:7.1f} s  (gain {gain:+.1f} s)")
