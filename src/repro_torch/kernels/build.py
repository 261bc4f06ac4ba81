"""Building the port's CUDA sources into plain-C shared libraries.

Each kernel family compiles its own sources with its own ``nvcc`` flags
into ``build/repro_torch/<name>_<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags, at first use.  Nothing here runs
when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "build_dir", "nvcc", "require_card"]

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
    os.replace(tmp, out)      # atomic: concurrent builders agree on the file
    return out
