"""Building the port's CUDA sources into plain-C shared libraries.

Each kernel family compiles its own sources with its own ``nvcc`` flags
into ``build/repro_torch/<name>_<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags, at first use, and keeps the
compiler's output beside it in ``<name>_<hash>.log`` (with ``-Xptxas -v``
among the flags, each kernel's registers and spills: :func:`ptxas_usage`).
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "build_dir", "nvcc", "ptxas_usage", "require_card"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return _PKG.parents[1] / "build" / "repro_torch"


def require_card() -> None:
    """Raise before building when there is no CUDA card to run on."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device and no CUDA "
                           "device is available")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def build(name: str, sources: tuple[Path, ...], flags: tuple[str, ...]) -> Path:
    """Compile ``sources`` once per content hash; returns the library path."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = build_dir() / f"{name}_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    tmp_log = out.with_suffix(f".{os.getpid()}.log")
    tmp_log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)      # atomic: concurrent builders agree on the file
    return out


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """``ptxas -v`` output -> {mangled kernel name: {"registers",
    "spill_stores", "spill_loads"}} (bytes for the spills)."""
    out: dict[str, dict[str, int]] = {}
    name = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            out[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif name and props == name and (m := _SPILL.search(line)):
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        elif name and (m := _REGS.search(line)):
            out[name]["registers"] = int(m.group(1))
    return out
