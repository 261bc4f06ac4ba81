#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print one JSON result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card the cell asks
for. ``BENCHMARK.json`` names the cell; its configuration, traffic and
metrics are files found by name: ``bench/configs/<config>.json``,
``bench/cells/<cell>.json`` (whose ``mode`` names the loop in
``bench/modes``) and ``bench/metrics/<metric>.py``. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy time and a breakdown of the traced slice. The
numbers compared against the reference close standard error, each beside
its limit, and close the result line under ``checks``.

Exits 3 without a result when no CUDA card (or too few) is present, 4 when
JAX or the JAX package was loaded, 2 on a malformed request.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the BENCHMARK.json entry, the cell file, the configuration file)
    of ``workload``."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json(BENCH / "cells" / f"{workload}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return entry, cell, config


def applies(metric: dict, workload: str, spec: dict) -> bool:
    """Whether ``metric`` is reported in ``workload``: listed there, or,
    without a list, everywhere (an end-to-end metric) or wherever the
    end-to-end metric it moves is (a per-layer one)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" not in metric:
        return True
    moves = next((e for e in spec["end_to_end"] if e["name"] == metric.get("moves")), None)
    return moves is not None and applies(moves, workload, spec)


def metric_reader(name: str):
    """``bench/metrics/<name>.py`` as a module (its ``read(ctx)``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive(spec: dict, workload: str, cell: dict, config: dict, seed: int,
          seconds: float, trace: bool, device, t0: float,
          control: bool = False) -> tuple[dict, object]:
    """Everything after the look for a card: run the cell's mode and build
    the result line. Returns (result, the mode's outcome)."""
    from bench.harness.core import Run

    run = Run(cell, config, seed, seconds, trace, device, t0, control)
    mode = importlib.import_module(f"bench.modes.{cell['mode']}")
    out = mode.run(run)
    metrics = {}
    if not trace:
        for e in spec["end_to_end"]:
            if applies(e, workload, spec):
                v = out.setup_s if e["name"] == "setup_s" else out.end_to_end[e["name"]]
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        ctx = SimpleNamespace(run=run, m=run.m, family=run.family, cell=cell,
                              layer=out.layer, trace=out.trace)
        for p in spec["per_layer"]:
            if applies(p, workload, spec):
                v = metric_reader(p["name"]).read(ctx)
                if v is not None:
                    metrics[p["name"]] = {"value": v, "unit": p["unit"]}
    is_cuda = device.type == "cuda"
    import torch
    dev = {"platform": "gpu" if is_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if is_cuda else device.type,
           "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(),
                               "idle_gaps": out.trace.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return result, out


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module this process loaded), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        print("--seconds must be positive", file=sys.stderr)
        return 2
    spec = load_json(ROOT / "BENCHMARK.json")
    try:
        entry, cell, config = cell_files(spec, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"bench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    print(f"bench: {time.perf_counter() - T0:9.3f} s  torch imported, card found",
          file=sys.stderr, flush=True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result, _ = drive(spec, args.workload, cell, config, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0)
    found = loaded_forbidden()
    if found:
        print(f"bench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
