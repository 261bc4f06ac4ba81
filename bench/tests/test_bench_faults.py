"""A run with its timed path broken underneath must come out not correct.

Each test skips only the look for a card: it drives the rest of a run
(``bench.run.drive``) with the cell's own limits and sample, and plants a
fault of ``bench/faults.py`` in the program the way a faulty change could:
an answer or a token altered where it is produced, half of the batch left
out (the rest's mean in its place), a decode step that returns its state
(the cache) unchanged, and inside the mixers' kernel calls the wkv6 state
carried between chunks dropped, or causal attention limited to its
diagonal blocks. The CPU tests run at smoke size; the card test plants the
kernels' faults at the cells' own size on three seeds. The unbroken run
must come out correct. One card has no exchange between chips to leave out.
"""

from __future__ import annotations

import time

import pytest
import torch

from conftest import ROOT, smoke_cell

from bench import calibrate, faults
from bench import run as R

SPEC = R.load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
#: seeds of the card test, two above 2**31
CARD_SEEDS = [2**31 + 101, 4_000_000_103, 107]


def drive(workload: str, seed: int = 2**33 + 5):
    spec, cell, config = smoke_cell(workload)
    res, _ = R.drive(spec, workload, cell, config, seed, 0.2, False,
                     torch.device("cpu"), time.perf_counter())
    return res


def limit(workload: str) -> float:
    _, cell, _ = smoke_cell(workload)
    return next(iter(cell["limits"].values()))


def cases():
    out = []
    for w in WORKLOADS:
        _, cell, config = smoke_cell(w)
        out += [(w, f) for f in faults.FAULTS if faults.applies(f, cell, config)]
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_unbroken_run_is_correct(workload):
    res = drive(workload)
    assert res["correct"] and res["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload,fault", cases())
def test_fault_makes_the_run_incorrect(workload, fault):
    with faults.planted(fault, limit(workload)):
        res = drive(workload)
    assert not res["correct"], res["checks"]


def test_every_fault_is_planted_somewhere():
    assert {f for _, f in cases()} == set(faults.FAULTS)


def test_half_batch_is_caught_by_the_cells_own_sample():
    """Each prefill cell checks every row of its batch, so a half batch
    left out can never fall outside the sample."""
    for w in WORKLOADS:
        entry, cell, _ = R.cell_files(SPEC, w)
        if cell["mode"] == "prefill":
            assert cell["sample"] >= cell["batch"], w


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WORKLOADS for f in faults.KERNEL_FAULTS
    if faults.applies(f, *R.cell_files(SPEC, w)[1:])])
def test_kernel_fault_at_the_cells_size(workload, fault):
    """The cell at its own size on the card, three seeds, each with the
    fault planted inside the kernel's call: the run must not be correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    for line in calibrate.readings(workload, CARD_SEEDS, 3.0, control=False, fault=fault):
        assert not line["correct"], (line["seed"], line["checks"])
