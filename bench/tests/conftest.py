"""Shared helpers of the benchmark's tests: the repo's root and ``src`` on
``sys.path``, and smoke-size copies of the cells."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: widths of the port's smoke configurations (yi-9b-smoke, rwkv6-smoke)
SMOKE = {
    "yi-9b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=256, dtype="float32"),
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                       d_ff=128, vocab_size=256, rwkv_head_dim=16, dtype="float32"),
}
#: small traffic for each mode; the cell's own ``sample`` is kept
SMALL_TRAFFIC = {
    "prefill": dict(batch=2, seq=64, pool=3, trace_calls=2),
    "decode": dict(batch=4, context=64, prefix=32, trace_steps=3),
}


def smoke_cell(workload: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell file, the configuration file) of
    ``workload``, cut to smoke size on the CPU: the cell's limits and
    sample kept."""
    from bench import run as R

    spec = R.load_json(ROOT / "BENCHMARK.json")
    _, cell, config = R.cell_files(spec, workload)
    config = copy.deepcopy(config)
    config["model"].update(SMOKE[config["name"]])
    cell = dict(cell, **SMALL_TRAFFIC[cell["mode"]])
    return spec, cell, config
