"""Checkpoints: async, atomic, in the reference's on-disk format.

* **format**: ``step_N/arrays.npz``, one array per leaf of the saved tree,
  keyed by its ``"/"``-joined path (dict keys in sorted order, as JAX
  flattens them: ``params/blocks/pos0/attn/wq``, ``opt/m/...``,
  ``opt/step``), bf16 stored as its ``uint16`` pattern; and
  ``step_N/manifest.json`` (step, time, each key's shape and stored dtype).
  Each package resumes the other's checkpoints.
* **atomic**: a save lands in ``step_N.tmp/`` and is renamed to
  ``step_N/`` when complete, so a preempted writer never corrupts the
  newest complete checkpoint.
* **async**: the device-to-host copy is synchronous (a consistent
  snapshot); writing the files runs on a thread, at most one save in
  flight.
* **retention**: keeps the newest ``keep`` checkpoints.

The reference's ``restore(..., shardings=)`` places leaves on a device
mesh; on one card it has no meaning, and :meth:`CheckpointManager.restore`
takes a ``device`` instead (the card unless the caller asks for another).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import array_from_tensor


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_save: bool = True


def _flatten_with_paths(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k in sorted(tree):
        path = (*prefix, str(k))
        if isinstance(tree[k], dict):
            out.update(_flatten_with_paths(tree[k], path))
        else:
            out["/".join(path)] = tree[k]
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array that is stored: a tensor copied to the host
    (bf16 as ``uint16``), a numpy array as it is."""
    if isinstance(leaf, torch.Tensor):
        return array_from_tensor(leaf)
    return np.asarray(leaf)


def _tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A stored array as a tensor of ``dtype``: a ``uint16`` array restored
    into bf16 is taken as bf16 bits."""
    if dtype == torch.bfloat16 and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = pathlib.Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._inflight: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---------------------------------------------------------------- save --
    def save(self, step: int, tree: dict) -> None:
        """Save a nested dict of tensors or numpy arrays as ``step``."""
        self.wait()  # at most one async save in flight
        host = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            manifest = {
                "step": step,
                "time": time.time(),
                "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                         for k, v in host.items()},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if self.cfg.async_save:
            def _run():
                try:
                    _write()
                except Exception as e:   # re-raised by wait()
                    self._error = e

            self._inflight = threading.Thread(target=_run, daemon=True)
            self._inflight.start()
        else:
            _write()

    def wait(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------------- load --
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: dict,
                device: "str | torch.device | None" = None) -> dict:
        """Restore into the structure of ``like``, a nested dict whose
        leaves have the shapes and torch dtypes to restore (tensors, meta
        tensors will do), as tensors on ``device`` (the card unless the
        caller asks for another)."""
        dev = resolve_device(device)
        leaves = {}
        with np.load(self.dir / f"step_{step}" / "arrays.npz") as arrays:
            for key, ref in _flatten_with_paths(like).items():
                a = arrays[key]
                if list(a.shape) != list(ref.shape):
                    raise ValueError(f"checkpoint leaf {key}: shape {a.shape} "
                                     f"!= {tuple(ref.shape)}")
                leaves[key] = _tensor(a, ref.dtype, dev)
        return _unflatten(leaves)
