"""The torch port stands alone: no JAX, nothing of ``repro``, the card by
default and the CPU only when asked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    hits = _IMPORT.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {sorted(set(hits))}"


def test_cpu_sweep_loads_neither_jax_nor_repro():
    code = """
import sys
import numpy as np
from repro_torch.configs.paper_workflow import compile_paper_plan, sweep_scenarios
plan = compile_paper_plan(0.5, device="cpu")
rep = plan.sweep(plan.prepare(sweep_scenarios(np.linspace(0.1, 0.9, 9))),
                 backend="torch")
rep.sample_progress("dl1", np.linspace(0.0, 300.0, 16))
rep.data_ceiling("task3", np.linspace(0.0, 300.0, 16))
rep.kernel_finish_times("task3")
assert set(rep.backends) == {"torch"}
from repro_torch.kernels.ppoly_eval import kernel
assert kernel._lib is None, "a CPU run built the CUDA kernels"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_is_the_card(monkeypatch):
    from repro_torch.analysis import compile_workflow
    from repro_torch.configs.paper_workflow import build_workflow
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = build_workflow(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_workflow(wf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.compile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert compile_workflow(wf, device="cpu").device == torch.device("cpu")


def test_kernel_sources_and_build_dir():
    from repro_torch.kernels.ppoly_eval import kernel

    assert kernel.SOURCES[0].is_file()
    assert kernel.build_dir() == ROOT / "build" / "repro_torch"
