"""The analysis examples' torch twins against the reference's examples.

Each ``examples/<name>_torch.py`` runs as a subprocess with ``--device cpu``
beside ``examples/<name>.py``, and their printed outputs are compared line
by line: the same text, and the same numbers at ``_assert_match``'s bar
(rtol 1e-5) or one unit in the last printed place, whichever is larger;
integers exactly.  Wall times and the speed-ups computed from them are
dropped first, and the engine's name ("jax"/"batched" there, "torch" here)
is not compared.  The twin runs under ``runpy`` in a child that then lists
its loaded modules: neither ``jax`` nor ``repro`` may be among them.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "compile_once", "sweep_allocations",
            "optimize_allocations", "risk_analysis", "workflow_analysis")
RTOL = 1e-5

#: lines that are wall times, or speed-ups computed from them
_TIMED_LINE = re.compile(r"^(compiled the Sect|resweep of \d+|analyzed \d+ scenarios"
                         r"|looped scalar solver)")
#: wall-time fragments inside a line that also carries results
_TIMED_PART = [(re.compile(r" in [\d.]+ s \(\d+ us/draw, "), " ("),
               (re.compile(r"\) in [\d.]+ s -> "), ") -> "),
               (re.compile(r" in [\d.]+ s -> "), " -> ")]
_ENGINE = [(re.compile(r"'(?:batched|torch|jax)' backend"), "<engine> backend"),
           (re.compile(r"(\d+) (?:jax|torch);"), r"\1 <engine>;")]
_NUM = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")

_CHILD = """
import runpy, sys
path = sys.argv[1]
sys.argv = [path, "--device", "cpu"]
runpy.run_path(path, run_name="__main__")
sys.stdout.flush()
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def _run(cmd):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, f"{cmd}\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}"
    return out.stdout


@pytest.fixture(scope="module")
def outputs():
    """Every reference example and its twin, four processes at a time."""
    jobs = {}
    for name in EXAMPLES:
        jobs[(name, "ref")] = [sys.executable, str(ROOT / "examples" / f"{name}.py")]
        jobs[(name, "torch")] = [sys.executable, "-c", _CHILD,
                                 str(ROOT / "examples" / f"{name}_torch.py")]
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {k: pool.submit(_run, cmd) for k, cmd in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def _lines(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        line = line.rstrip()
        if not line or _TIMED_LINE.match(line.lstrip()):
            continue
        for pat, rep in _TIMED_PART + _ENGINE:
            line = pat.sub(rep, line)
        out.append(line)
    return out


def _unit(tok: str) -> float:
    """One unit in the last printed place of a number token."""
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".", 1)[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def _same_line(got: str, want: str) -> None:
    assert _NUM.sub("#", got) == _NUM.sub("#", want), (got, want)
    for g, w in zip(_NUM.findall(got), _NUM.findall(want), strict=True):
        if not re.search(r"[.eE]", w):
            assert g == w, (got, want)
            continue
        gv, wv = float(g), float(w)
        assert abs(gv - wv) <= max(RTOL * abs(wv), _unit(w)) * (1 + 1e-9), (got, want)


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_prints_what_the_reference_prints(outputs, name):
    twin = outputs[(name, "torch")].splitlines()
    assert twin[-1] == "LOADED []", twin[-1]
    got, want = _lines("\n".join(twin[:-1])), _lines(outputs[(name, "ref")])
    assert len(got) == len(want), ("\n".join(got), "\n".join(want))
    for g, w in zip(got, want):
        _same_line(g, w)
