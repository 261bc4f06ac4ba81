"""The control must fail every cell's check: the float32 reference computed
in fp8 (e4m3 inputs to every matrix product, scaled per row and per output
column) in the program's place, at the cell's own size, on three seeds,
while the program passes on the same seeds. Needs the card; at the cells'
sizes it takes a few minutes:

    python -m pytest -q -m requires_cuda bench/tests/test_bench_control.py
"""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT

from bench import calibrate
from bench import run as R

SPEC = R.load_json(ROOT / "BENCHMARK.json")
SEEDS = [2**31 + 17, 4_000_000_019, 23]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    for line in calibrate.readings(workload, SEEDS, 3.0, control=True):
        for name, c in line["checks"].items():
            assert c["value"] <= c["limit"], (line["seed"], name, c)
            assert line["control"][name] > c["limit"], (line["seed"], name, line["control"])
