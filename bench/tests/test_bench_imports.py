"""What the harness and the reference load, by whole top-level module
name: never ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package);
the reference also nothing of the program (``repro_torch``)."""

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
from conftest import smoke_cell
from bench import run as R
import bench.calibrate
import bench.faults
for w in ("yi-9b.prefill-4k", "rwkv6-1.6b.prefill-4k", "yi-9b.decode-b128"):
    spec, cell, config = smoke_cell(w)
    for trace in (False, True):
        res, _ = R.drive(spec, w, cell, config, 7, 0.05, trace, torch.device("cpu"),
                         time.perf_counter())
        assert res["correct"], res
for name in [p["name"] for p in spec["per_layer"]]:
    R.metric_reader(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from bench.reference import common, dense_gqa, rwkv6
from bench.harness.weights import make_weights
for name, ref, extra in (("dense_gqa", dense_gqa, dict(rope_theta=1e4)),
                         ("rwkv6", rwkv6, dict(ssm="rwkv6", rwkv_head_dim=8))):
    m = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=32,
             vocab_size=32, norm_eps=1e-6, **extra)
    w = make_weights(ref, m, 3, torch.device("cpu"), torch.float32)
    t = torch.randint(0, 32, (2, 9))
    for p in common.PRECISIONS:
        ref.logits(w, ref.hidden(w, m, t, precision=p), precision=p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
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
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_whole_top_level_names():
    from bench import run as R

    assert set(R.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}
    assert R.loaded_forbidden(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert R.loaded_forbidden(["repro_torch", "repro.core", "jax._src"]) == ["jax", "repro"]
