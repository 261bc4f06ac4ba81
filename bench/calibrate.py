#!/usr/bin/env python3
"""Readings for a cell's correctness limits: the program's compared numbers
and the fp8 control's, on several seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control] [--fault <name>]

Each seed runs the cell as ``bench/run.py`` does (set-up, a window of
``--seconds``, the check), with ``--control`` also the reference in fp8 in
the program's place, with ``--fault`` the program broken by a fault of
``bench/faults.py``; one JSON line per seed. The benchmark's own runs never
run the control or a fault.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds: list[int], seconds: float, control: bool,
             fault: str | None = None):
    """Yield one dict per seed: the compared numbers, the control's, the
    end-to-end numbers of the short window; with ``fault``, of the program
    with that fault planted."""
    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import faults
    from bench import run as R

    spec = R.load_json(ROOT / "BENCHMARK.json")
    _, cell, config = R.cell_files(spec, workload)
    limit = next(iter(cell["limits"].values()))
    for seed in seeds:
        t0 = time.perf_counter()
        with faults.planted(fault, limit) if fault else contextlib.nullcontext():
            result, out = R.drive(spec, workload, cell, config, seed, seconds, False,
                                  torch.device("cuda", 0), t0, control=control)
        yield {"workload": workload, "seed": seed, "fault": fault,
               "correct": result["correct"],
               "checks": result["checks"], "control": out.control,
               "end_to_end": out.end_to_end, "setup_s": out.setup_s,
               "memory_peak_bytes": out.memory_peak_bytes,
               "wall_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, help="a fault of bench/faults.py")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for line in readings(args.workload, seeds, args.seconds, args.control, args.fault):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
