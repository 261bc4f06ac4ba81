"""The port's durable plan artifacts (``.bmplan``) on the CPU: the twin of
``tests/test_artifacts.py``.

The port's artifact holds a manifest and the workflow as ``(starts,
coeffs)`` arrays, with the engine's proven iteration caps in the manifest;
PyTorch has no ``jax.export``, so there are no executables.  Contracts:

* **warm start**: ``load_plan`` sweeps are bit-identical to a fresh
  ``compile()``, and every solve of a recorded shape starts from an adopted
  proven cap (``warm_hits``, no ``cold_solves``),
* **deterministic bytes**: two ``build_artifact_bytes`` of one plan, and of
  two plans of one workflow, are equal,
* **every verification failure degrades, never crashes**: corrupt bytes, a
  member swapped behind a resealed manifest, a stale format stamp, a
  truncated file and garbage raise the typed ``ArtifactError`` and fall back
  to a logged re-compile when a fallback workflow is given; a level
  signature mismatch loads the plan without its caps,
* **portability**: a fresh process that imports neither JAX nor ``repro``
  loads the artifact and sweeps bit-identically; the stored workflow has
  the reference's fingerprint and sweeps as ``repro`` does,
* **atomic writes** through ``ArtifactStore``.

Every file lives under ``tmp_path``; every plan runs on ``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import warnings
import zipfile

import numpy as np
import pytest

from repro.analysis.serve import workflow_fingerprint as ref_fingerprint
from repro.configs import paper_workflow as ref_paper
from repro_torch.analysis import (ArtifactError, ArtifactStore, ArtifactWarning,
                                  FaultPlan, load_plan)
from repro_torch.analysis.artifacts import ARTIFACT_FORMAT, build_artifact_bytes
from repro_torch.analysis.serve import workflow_fingerprint
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.core.convert import workflow_from_record, workflow_record

from test_sweep import _assert_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRACS = [0.3, 0.5, 0.7, 0.9]
CPU = "cpu"


def _swept_plan(frac: float = 0.5):
    """A fresh plan that has swept once (so its engine proved a cap)."""
    plan = build_workflow(frac).compile(device=CPU)
    rep = plan.sweep(plan.prepare(sweep_scenarios(FRACS)), backend="torch")
    return plan, rep


def _sweep(plan):
    return plan.sweep(plan.prepare(sweep_scenarios(FRACS)), backend="torch")


def _same(a, b):
    np.testing.assert_array_equal(a.makespans, b.makespans)
    np.testing.assert_array_equal(a.share_seconds, b.share_seconds)
    for n in a.order:
        np.testing.assert_array_equal(a.finish[n], b.finish[n])


def _reseal(path, edit):
    """Rewrite an artifact's members through ``edit(members, manifest)``
    and re-seal the manifest's member digests and content hash."""
    with zipfile.ZipFile(path) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    manifest = json.loads(members["manifest.json"])
    edit(members, manifest)
    for name in manifest["members"]:
        manifest["members"][name] = hashlib.sha256(members[name]).hexdigest()
    core = {k: v for k, v in manifest.items() if k != "content_hash"}
    manifest["content_hash"] = hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()
    members["manifest.json"] = json.dumps(manifest, sort_keys=True).encode()
    with zipfile.ZipFile(path, "w") as zf:
        for n, data in members.items():
            zf.writestr(n, data)


# -------------------------------------------------------- the tentpole pin --
def test_export_load_bit_identical_from_proven_caps(tmp_path):
    plan, rep = _swept_plan()
    path = plan.export(tmp_path / "paper.bmplan")
    assert path.exists()
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == ["manifest.json", "workflow.f64",
                                 "workflow.json"]
        manifest = json.loads(zf.read("manifest.json"))
    assert manifest["format"] == ARTIFACT_FORMAT
    assert manifest["proven_caps"] == [list(r) for r in
                                       plan._torch_engine.proven_caps_rows()]

    loaded = load_plan(path, device=CPU)
    eng = loaded._torch_engine
    assert eng is not None and eng is not plan._torch_engine
    assert loaded.device.type == "cpu"
    rep2 = _sweep(loaded)
    assert eng.cold_solves == 0, "warm sweep started from a cold cap"
    assert eng.warm_hits >= 1
    _same(rep, rep2)
    # ...and bit-identical to a second INDEPENDENT fresh compile too
    _same(rep2, _sweep(build_workflow(0.5).compile(device=CPU)))


def test_export_before_any_sweep_loads_and_starts_cold(tmp_path):
    plan = build_workflow(0.5).compile(device=CPU)
    path = plan.export(tmp_path / "cold.bmplan")
    loaded = load_plan(path, device=CPU)
    assert loaded._torch_engine is None
    rep = _sweep(loaded)
    assert loaded._torch_engine.cold_solves >= 1
    assert loaded._torch_engine.warm_hits == 0
    _same(rep, _sweep(plan))


def test_artifact_bytes_deterministic():
    plan, _rep = _swept_plan()
    data = build_artifact_bytes(plan)
    assert data == build_artifact_bytes(plan)
    # two plans of one workflow that swept the same shape: the same bytes
    other, _ = _swept_plan()
    assert build_artifact_bytes(other) == data
    assert build_artifact_bytes(_swept_plan(0.7)[0]) != data


# ------------------------------------------------- degrade, never crash ----
def _corrupt_tail(path):
    data = path.read_bytes()
    path.write_bytes(data[:-64] + bytes(b ^ 0xFF for b in data[-64:]))


def test_corrupt_bytes_rejected_then_fallback(tmp_path):
    plan, rep = _swept_plan()
    path = plan.export(tmp_path / "x.bmplan")
    _corrupt_tail(path)
    with pytest.raises(ArtifactError):
        load_plan(path, device=CPU)
    with pytest.warns(ArtifactWarning, match="fresh compile"):
        loaded = load_plan(path, workflow=build_workflow(0.5), device=CPU)
    _same(rep, _sweep(loaded))
    with pytest.raises(ArtifactError):
        load_plan(path, workflow=build_workflow(0.5), strict=True, device=CPU)


def test_truncated_and_garbage_files_rejected(tmp_path):
    plan, _rep = _swept_plan()
    path = plan.export(tmp_path / "x.bmplan")
    trunc = tmp_path / "trunc.bmplan"
    trunc.write_bytes(path.read_bytes()[: path.stat().st_size // 3])
    with pytest.raises(ArtifactError):
        load_plan(trunc, device=CPU)
    garbage = tmp_path / "garbage.bmplan"
    garbage.write_bytes(b"not an artifact at all")
    with pytest.raises(ArtifactError):
        load_plan(garbage, device=CPU)
    with pytest.raises(ArtifactError):
        load_plan(tmp_path / "missing.bmplan", device=CPU)


def test_stale_format_version_rejected_typed(tmp_path):
    plan, _rep = _swept_plan()
    store = ArtifactStore(tmp_path / "store",
                          faults=FaultPlan(stale_artifact_version=1))
    path = store.put(plan)
    with pytest.raises(ArtifactError, match="format"):
        load_plan(path, device=CPU)
    path2 = store.put(plan)  # the next write is clean (1-based schedule)
    assert load_plan(path2, device=CPU) is not None


def test_faultplan_corrupt_artifact_write_degrades(tmp_path):
    """The injected mid-file flip lands in some member: the artifact is
    rejected typed, and the fallback compiles to the exact answer."""
    plan, rep = _swept_plan()
    store = ArtifactStore(tmp_path / "store",
                          faults=FaultPlan(corrupt_artifact=1))
    path = store.put(plan)
    with pytest.raises(ArtifactError):
        load_plan(path, device=CPU)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        loaded = load_plan(path, workflow=build_workflow(0.5), device=CPU)
    assert any(issubclass(x.category, ArtifactWarning) for x in w)
    _same(rep, _sweep(loaded))


def test_wrong_workflow_member_fails_fingerprint(tmp_path):
    """Another workflow behind a resealed manifest is a typed error."""
    plan, _rep = _swept_plan()
    path = plan.export(tmp_path / "x.bmplan")
    structure, flat = workflow_record(build_workflow(0.9))

    def swap(members, _manifest):
        members["workflow.json"] = json.dumps(structure, sort_keys=True).encode()
        members["workflow.f64"] = flat.astype("<f8").tobytes()

    _reseal(path, swap)
    with pytest.raises(ArtifactError, match="fingerprint"):
        load_plan(path, device=CPU)


def test_level_signature_mismatch_still_loads_plan(tmp_path):
    """The caps are cargo: a plan whose recorded level signature does not
    match loads without them (one warning) and sweeps from a cold cap to
    the exact answer."""
    plan, rep = _swept_plan()
    path = plan.export(tmp_path / "x.bmplan")

    def skew(_members, manifest):
        manifest["level_signature"] = "0" * 64

    _reseal(path, skew)
    with pytest.warns(ArtifactWarning, match="level signature"):
        loaded = load_plan(path, device=CPU)
    assert loaded._torch_engine is None
    _same(rep, _sweep(loaded))
    assert loaded._torch_engine.cold_solves >= 1


# ------------------------------------------------------------- the store ----
def test_store_atomic_put_and_scan(tmp_path):
    plan, _rep = _swept_plan()
    store = ArtifactStore(tmp_path / "store")
    p1 = store.put(plan)
    assert store.scan() == [p1]
    p2 = store.put(plan)
    assert p2 == p1 and store.scan() == [p1]
    assert not list((tmp_path / "store").glob("*.tmp")), "left temp litter"
    loaded = load_plan(p1, device=CPU)
    assert list(loaded.workflow.processes) == list(plan.workflow.processes)


# ------------------------------------------------------------ portability ----
def test_artifact_loads_in_a_fresh_process_subprocess(tmp_path):
    """A process that imports neither JAX nor ``repro`` loads the artifact
    and sweeps from the proven caps, bit-identically."""
    plan, rep = _swept_plan()
    path = plan.export(tmp_path / "fresh.bmplan")
    code = f"""
import sys
from repro_torch.analysis import load_plan
from repro_torch.configs.paper_workflow import sweep_scenarios
loaded = load_plan({str(path)!r}, device="cpu")
rep = loaded.sweep(loaded.prepare(sweep_scenarios({FRACS!r})), backend="torch")
eng = loaded._torch_engine
assert eng.cold_solves == 0 and eng.warm_hits >= 1, (eng.cold_solves, eng.warm_hits)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("MS", repr(rep.makespans.tolist()))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
    ms = eval(out.stdout.splitlines()[0][3:])
    np.testing.assert_array_equal(np.asarray(ms), rep.makespans)


def test_stored_workflow_is_the_reference_workflow(tmp_path):
    """The workflow record round-trips bit for bit; the stored workflow has
    the reference's fingerprint, and the loaded plan sweeps as ``repro``
    does at the ``_assert_match`` bars."""
    wf = build_workflow(0.6)
    structure, flat = workflow_record(wf)
    back = workflow_from_record(json.loads(json.dumps(structure)), flat)
    assert workflow_fingerprint(back) == workflow_fingerprint(wf)
    assert list(back.processes) == list(wf.processes)
    assert workflow_fingerprint(back) == \
        ref_fingerprint(ref_paper.build_workflow(0.6))
    plan = wf.compile(device=CPU)
    path = plan.export(tmp_path / "ref.bmplan")
    loaded = load_plan(path, device=CPU)
    rep = _sweep(loaded)
    ref_plan = ref_paper.build_workflow(0.6).compile()
    rep_r = ref_plan.sweep(ref_plan.prepare(ref_paper.sweep_scenarios(FRACS)),
                           backend="jax")
    _assert_match(rep, rep_r)
