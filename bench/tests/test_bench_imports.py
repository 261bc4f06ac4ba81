"""What the harness and the reference load, by whole top-level module
name: never ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package);
the reference also nothing of the program (``repro_torch``). The harness
drives every cell of ``BENCHMARK.json`` at smoke size, and every module in
``bench/reference`` is loaded, so a new cell or family is held to this
without an edit here."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

HARNESS = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
sys.path.insert(0, {tests!r})
from conftest import ROOT, smoke_cell
from bench import run as R
import bench.calibrate
import bench.faults
spec = R.load_json(ROOT / "BENCHMARK.json")
for w in [x["name"] for x in spec["workloads"]]:
    spec, cell, config = smoke_cell(w)
    for trace in (False, True):
        res, _ = R.drive(spec, w, cell, config, 7, 0.05, trace, torch.device("cpu"),
                         time.perf_counter())
        assert res["correct"], res
for name in [p["name"] for p in spec["per_layer"]]:
    R.metric_reader(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

#: every module in bench/reference is loaded, and each configuration's
#: family runs its reference at the configuration's smoke widths in every
#: precision; the last line also lists the reference modules loaded
REFERENCE = """
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [{root!r}]
import torch
from bench.reference import common
from bench.harness.weights import make_weights
root = Path({root!r})
for p in sorted((root / "bench" / "reference").glob("*.py")):
    if p.stem != "__init__":
        importlib.import_module("bench.reference." + p.stem)
spec = json.loads((root / "BENCHMARK.json").read_text())
for c in spec["configs"]:
    f = json.loads((root / c["file"]).read_text())
    m = dict(f["model"], **f["smoke"])
    ref = importlib.import_module("bench.reference." + f["reference"])
    w = make_weights(ref, m, 3, torch.device("cpu"), torch.float32)
    t = torch.randint(0, m["vocab_size"], (2, 9))
    for p in common.PRECISIONS:
        ref.logits(w, ref.hidden(w, m, t, precision=p), precision=p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        | {{m for m in sys.modules if m.startswith("bench.reference.")}})))
"""


def loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded(HARNESS.format(root=str(ROOT), src=str(ROOT / "src"),
                                 tests=str(ROOT / "bench" / "tests")))
    assert "repro_torch" in mods and "bench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_neither_jax_nor_the_program():
    mods = loaded(REFERENCE.format(root=str(ROOT)))
    assert "bench" in mods
    assert {f"bench.reference.{p.stem}" for p in (ROOT / "bench" / "reference").glob("*.py")
            if p.stem != "__init__"} <= mods
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_whole_top_level_names():
    from bench import run as R

    assert set(R.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}
    assert R.loaded_forbidden(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert R.loaded_forbidden(["repro_torch", "repro.core", "jax._src"]) == ["jax", "repro"]
