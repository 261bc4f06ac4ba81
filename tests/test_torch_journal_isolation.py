"""A journal written by the JAX reference recovers in the port without
loading ``jax`` or ``repro``: its classes are mapped to the port's twins or
refused with ``JournalError``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import AnalysisService as RefService
from repro.analysis.faults import FaultPlan as RefFaultPlan
from repro.analysis.journal import Journal as RefJournal
from repro.configs.paper_workflow import build_workflow as ref_build_workflow
from repro.configs.paper_workflow import sweep_scenarios as ref_sweep_scenarios
from repro_torch.analysis import AnalysisService, JournalError
from repro_torch.analysis.journal import MAPPED_CLASSES, read_journal
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.core.workflow import Workflow

ROOT = Path(__file__).resolve().parents[1]
T = 120.0
#: the reference's own makespan after the delta below (both packages agree)
MAKESPAN = 857.58127142


def _reference_track(store, track_id="r"):
    with RefService(ref_build_workflow(0.5), store=store,
                    backend="numpy") as svc:
        live = svc.track(ref_sweep_scenarios([0.5]), track_id=track_id)
        rep = live.ingest({"dl1.link": np.float64(0.25)}, timeout=T)
    return float(rep.makespans[0])


def _run_port(code, store):
    out = subprocess.run(
        [sys.executable, "-c", code, str(store)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    return out.stdout


_RECOVER = """
import sys, warnings
from repro_torch.analysis import AnalysisService
from repro_torch.core.workflow import Workflow
with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # the reference's .bmplan is skipped
    with AnalysisService(store=sys.argv[1], backend="numpy",
                         device="cpu") as svc:
        live = svc.recover("r")
        assert live.updates == 1
        assert isinstance(live.plan.workflow, Workflow)
        rep = live.refresh()
        live.close()
print("MAKESPAN", repr(float(rep.makespans[0])))
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_reference_journal_recovers_without_jax_or_repro(tmp_path):
    store = tmp_path / "store"
    ref_makespan = _reference_track(store)
    np.testing.assert_allclose(ref_makespan, MAKESPAN, rtol=1e-9)
    out = _run_port(_RECOVER, store)
    assert "LOADED []" in out, out
    got = float(out.split("MAKESPAN ")[1].split()[0])
    np.testing.assert_allclose(got, ref_makespan, rtol=1e-5)
    np.testing.assert_allclose(got, MAKESPAN, rtol=1e-9)


_REFUSE = """
import sys
from repro_torch.analysis.journal import JournalError, read_journal
try:
    read_journal(sys.argv[1])
except JournalError as e:
    print("REFUSED", e)
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_unmapped_reference_class_is_refused_and_file_kept(tmp_path):
    path = tmp_path / "x.journal"
    with RefJournal(path) as j:
        j.append({"kind": "genesis", "faults": RefFaultPlan()})
    size = path.stat().st_size
    out = _run_port(_REFUSE, path)
    assert "REFUSED" in out and "repro.analysis.faults.FaultPlan" in out, out
    assert "LOADED []" in out, out
    assert path.stat().st_size == size  # refusal is not a torn tail


def test_reference_classes_map_to_twins_in_process(tmp_path):
    store = tmp_path / "store"
    _reference_track(store)
    recs, torn = read_journal(store / "journals" / "r.journal")
    assert torn is None and len(recs) == 2
    wf = recs[0]["workflow"]
    assert isinstance(wf, Workflow)
    ref = ref_build_workflow(0.5)
    assert sorted(wf.processes) == sorted(ref.processes)
    for name, proc in wf.processes.items():
        assert type(proc).__module__ == "repro_torch.core.process"
        for dep_name, dep in proc.data.items():
            want = ref.processes[name].data[dep_name].requirement
            np.testing.assert_array_equal(dep.requirement.starts, want.starts)
            np.testing.assert_array_equal(dep.requirement.coeffs, want.coeffs)
    sc = recs[0]["scenarios"][0]
    assert type(sc).__module__ == "repro_torch.sweep.batch"
    assert set(MAPPED_CLASSES) == {
        "repro.core.ppoly", "repro.core.process", "repro.core.workflow",
        "repro.sweep.batch", "repro.analysis.scenarios"}


def test_port_journal_still_recovers(tmp_path):
    with AnalysisService(build_workflow(0.5), store=tmp_path / "s",
                         backend="numpy", device="cpu") as svc:
        live = svc.track(sweep_scenarios([0.5]), track_id="p")
        rep = live.ingest({"dl1.link": np.float64(0.25)}, timeout=T)
        live.close()
    with AnalysisService(store=tmp_path / "s", backend="numpy",
                         device="cpu") as svc:
        rec = svc.recover("p")
        np.testing.assert_array_equal(rec.refresh().makespans, rep.makespans)
        rec.close()
    with pytest.raises(JournalError, match="no journal"):
        read_journal(tmp_path / "absent.journal")
