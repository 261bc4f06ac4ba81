"""BottleMod as the framework's performance oracle, over the torch port.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python examples/step_prediction_torch.py [--cell yi-9b_train_4k_single]

Loads a record of the port's dry-run (``results/dryrun_torch/``), turns its
per-device counts into a BottleMod workflow (data pipeline -> train step ->
async checkpoints), predicts step time and bottleneck structure on an H100
(``repro_torch.perfmodel.roofline``), and ranks what-if interventions: the
paper's Sect. 3.3 "potential performance gain" analysis applied to
distributed training.  Imports only the port.
"""

import argparse
import json
import pathlib

from repro_torch.perfmodel.stepmodel import StepModelInputs, predict

ROOT = pathlib.Path(__file__).resolve().parents[1]

ap = argparse.ArgumentParser()
ap.add_argument("--cell", default="yi-9b_train_4k_single")
ap.add_argument("--data-rate", type=float, default=1.0, help="host pipeline steps/s")
ap.add_argument("--dir", default=str(ROOT / "results" / "dryrun_torch"),
                help="the dry-run's --out directory")
args = ap.parse_args()

path = pathlib.Path(args.dir) / f"{args.cell}.json"
rec = json.loads(path.read_text())
if rec["status"] != "ok":
    raise SystemExit(f"cell {args.cell} recorded an error: {rec['error']}")
per = rec["per_device"]
m = StepModelInputs(
    flops_per_step=per["flops"], hbm_bytes_per_step=per["bytes"],
    coll_bytes_per_step=per["collective_bytes"],
    n_steps=200, data_rate_steps_per_s=args.data_rate,
    ckpt_every=50, ckpt_bytes=8e9,
)
p = predict(m)
print(f"cell {args.cell}: predicted step {p.step_time_s * 1e3:.1f} ms, "
      f"200-step makespan {p.makespan_s:.1f} s")
print("\nbottleneck attribution:")
for b in p.bottleneck_shares:
    print(f"  {b.process:14s} {b.kind}:{b.name:12s} {b.seconds:8.1f}s ({b.fraction:4.0%})")
print("\nwhat-if (double each resource), ranked:")
for proc, res, new, gain in p.gains:
    print(f"  2x {proc}/{res:<12s} -> {new:8.1f}s  (gain {gain:+7.1f}s)")
