"""Shared helpers of the benchmark's tests: the repo's root and ``src`` on
``sys.path``, and smoke-size copies of the cells."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: small traffic for each mode; the cell's own ``sample`` is kept
SMALL_TRAFFIC = {
    "prefill": dict(batch=2, seq=64, pool=3, trace_calls=2),
    "decode": dict(batch=4, context=64, prefix=32, trace_steps=3),
}


def smoke_widths(config: dict) -> dict:
    """A configuration file's ``model`` with its ``smoke`` widths merged
    over it."""
    return dict(config["model"], **config["smoke"])


def smoke_cell(workload: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell file, the configuration file) of
    ``workload``, cut to smoke size on the CPU: the cell's limits and
    sample kept."""
    from bench import run as R

    spec = R.load_json(ROOT / "BENCHMARK.json")
    _, cell, config = R.cell_files(spec, workload)
    config = dict(config, model=smoke_widths(config))
    cell = dict(cell, **SMALL_TRAFFIC[cell["mode"]])
    return spec, cell, config
