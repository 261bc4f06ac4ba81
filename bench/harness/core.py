"""What every mode shares: the run's parameters, the program's entry
points, and what a mode hands back (its numbers and the output check)."""

from __future__ import annotations

import importlib
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Run:
    """One run of one cell: parsed files and arguments."""
    cell: dict                   # bench/cells/<cell>.json
    config: dict                 # bench/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                    # process start, on time.perf_counter
    control: bool = False        # also read the control's numbers

    @property
    def m(self) -> dict:
        return self.config["model"]

    @property
    def family(self) -> ModuleType:
        """``bench/reference/<family>.py``, which the configuration's
        ``reference`` names: layout, work counts and the reference."""
        return importlib.import_module(f"bench.reference.{self.config['reference']}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclass
class Outcome:
    """What a mode hands back to ``run.py``."""
    setup_s: float
    end_to_end: dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    #: the numbers compared: name -> (value, limit)
    checks: dict[str, tuple[float, float]]
    #: what the per-layer metrics read (``bench/metrics``)
    layer: dict = field(default_factory=dict)
    trace: object = None
    #: the control's numbers, name -> value (calibration only)
    control: dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def program():
    """The system under test: the port's model module and its config type,
    imported from ``src`` at the root of the checkout."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"the program is missing: no {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch.models import transformer
    from repro_torch.models.common import ModelConfig
    return transformer, ModelConfig


def model_for(run: Run, weights: dict):
    """(the port's module, its config, the model built on ``weights``)."""
    T, ModelConfig = program()
    cfg = ModelConfig(**run.m)
    return T, cfg, T.DecoderLM(cfg, weights)


def dtype_of(m: dict) -> torch.dtype:
    """The type the configuration serves its weights and cache in."""
    return torch.bfloat16 if m.get("dtype", "bfloat16") == "bfloat16" else torch.float32


def log(run: Run, what: str) -> None:
    """A progress line on standard error: seconds since the process began."""
    print(f"bench: {since(run.t0):9.3f} s  {what}", file=sys.stderr, flush=True)


def since(t: float) -> float:
    return time.perf_counter() - t
