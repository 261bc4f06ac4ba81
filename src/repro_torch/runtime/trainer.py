"""Training loop: auto-resume, async checkpointing, straggler monitoring.

The reference's ``runtime/trainer.py`` on one device, the CUDA card unless
the caller asks for another.  Fault-tolerance contract:

* the loop can be killed at any point and restarted with the same config —
  it resumes from the newest complete checkpoint (atomic rename) and the
  data pipeline re-synchronises from the step index alone;
* checkpoints are written asynchronously, at most one save in flight, in
  the reference's format (either package resumes the other's);
* every step is timed by the BottleMod progress monitor; stragglers raise
  events, counted in the run summary.

:meth:`Trainer.train_step` is eager PyTorch: the forward, ``loss.backward()``
and :func:`repro_torch.optim.adamw_update`.  The reference jits its step;
capturing this one in a graph is a speed change, not part of the port.  No
``mesh``: one card.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint import CheckpointConfig, CheckpointManager
from ..data import DataConfig, SyntheticTokenPipeline
from ..device import resolve_device
from ..models import transformer as T
from ..models.common import ModelConfig, init_params
from ..models.convert import (array_from_tensor, load_reference_tree,
                              to_reference_tree)
from ..optim import OptConfig, adamw_init, adamw_update
from .monitor import ProgressMonitor


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    seed: int = 0
    straggler_threshold: float = 2.0
    predicted_step_s: float | None = None


def data_config_for(cfg: ModelConfig, seq_len: int = 256,
                    global_batch: int = 8) -> DataConfig:
    """The pipeline a model trains on: frame embeddings and per-codebook
    labels for the audio frontend, M-RoPE positions for the vlm."""
    audio = cfg.frontend == "audio"
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch,
                      n_codebooks=cfg.n_codebooks if audio else 0,
                      d_model=cfg.d_model if audio else 0,
                      mrope=cfg.mrope_sections is not None)


class Trainer:
    """``run()`` trains ``model_cfg`` from ``init_params(cfg, seed)`` (or the
    newest checkpoint) for ``train_cfg.steps`` steps and returns the
    reference's summary; the model and optimizer state stay on the trainer
    as ``model`` and ``opt_state``."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainerConfig,
                 opt_cfg: OptConfig | None = None, data_cfg: DataConfig | None = None,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg or OptConfig()
        self.data_cfg = data_cfg or data_config_for(model_cfg)
        self.ckpt = CheckpointManager(CheckpointConfig(directory=train_cfg.ckpt_dir))
        self.monitor = ProgressMonitor(predicted_step_s=train_cfg.predicted_step_s,
                                       threshold=train_cfg.straggler_threshold)
        self.model: T.DecoderLM | None = None
        self.opt_state: dict | None = None

    # ----------------------------------------------------------------- step --
    def init_state(self) -> tuple[T.DecoderLM, dict]:
        """A trainable model from ``init_params(cfg, seed)`` on the device and
        a fresh AdamW state."""
        model = T.DecoderLM(self.model_cfg,
                            init_params(self.model_cfg, self.cfg.seed, self.device))
        model.requires_grad_(True)
        return model, adamw_init(list(model.parameters()), self.opt_cfg)

    def train_step(self, model: T.DecoderLM, opt_state: dict, batch: dict) -> dict:
        """One step on device tensors: forward, ``loss.backward()``, AdamW.
        The gradients stay on the parameters until the next step (a
        parameter the loss does not reach gets zeros, as under JAX).
        Returns ``{"loss", "grad_norm", "lr"}`` as scalar tensors."""
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = T.loss_fn(model, model.cfg, batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        _, _, metrics = adamw_update(grads, opt_state, params, self.opt_cfg)
        return {"loss": loss.detach(), **metrics}

    def device_batch(self, host_batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in host_batch.items()}

    # ---------------------------------------------------------- checkpoints --
    def state_tree(self, model: T.DecoderLM, opt_state: dict,
                   leaf=array_from_tensor) -> dict:
        """``{"params": ..., "opt": {"m", "v", "step"}}`` in the reference's
        layout (its trainer saves this tree): ``leaf`` of each tensor, by
        default a host numpy copy."""
        def tree(ts):
            return to_reference_tree(model, ts, leaf)

        return {"params": tree(list(model.parameters())),
                "opt": {"m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                        "step": leaf(opt_state["step"])}}

    def save(self, step: int, model: T.DecoderLM, opt_state: dict) -> None:
        self.ckpt.save(step, self.state_tree(model, opt_state))

    def restore(self, step: int, model: T.DecoderLM, opt_state: dict) -> None:
        """Load checkpoint ``step`` into ``model`` and ``opt_state`` in place,
        through host memory, one leaf at a time."""
        like = self.state_tree(model, opt_state, leaf=lambda t: t.to("meta"))
        state = self.ckpt.restore(step, like, device="cpu")
        load_reference_tree(model, state["params"], list(model.parameters()))
        load_reference_tree(model, state["opt"]["m"], opt_state["m"])
        load_reference_tree(model, state["opt"]["v"], opt_state["v"])
        opt_state["step"].copy_(state["opt"]["step"])

    # ------------------------------------------------------------------ run --
    def run(self) -> dict:
        model, opt_state = self.init_state()
        start_step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.restore(latest, model, opt_state)
            start_step = latest
            print(f"[trainer] resumed from checkpoint step {latest}")

        pipe = SyntheticTokenPipeline(self.data_cfg).start(step=start_step)
        self.monitor.start()
        losses: list[float] = []
        t0 = time.perf_counter()
        step = start_step
        try:
            while step < self.cfg.steps:
                _, host_batch = pipe.get()
                metrics = self.train_step(model, opt_state, self.device_batch(host_batch))
                loss = float(metrics["loss"])
                losses.append(loss)
                step += 1
                ev = self.monitor.record_step(step)
                if ev is not None:
                    print(f"[trainer] STRAGGLER step {ev.step}: {ev.duration_s:.3f}s "
                          f"({ev.ratio:.1f}x baseline {ev.baseline_s:.3f}s)")
                if step % self.cfg.log_every == 0:
                    print(f"[trainer] step {step}: loss {loss:.4f} "
                          f"({(time.perf_counter() - t0) / max(step - start_step, 1):.3f}s/step)")
                if self.cfg.ckpt_every and step % self.cfg.ckpt_every == 0:
                    self.save(step, model, opt_state)
        finally:
            pipe.stop()
        self.save(step, model, opt_state)
        self.ckpt.wait()
        self.model, self.opt_state = model, opt_state
        return {
            "final_step": step,
            "losses": losses,
            "loss_first": losses[0] if losses else None,
            "loss_last": float(np.mean(losses[-5:])) if losses else None,
            "stragglers": len(self.monitor.events),
            "wall_s": time.perf_counter() - t0,
        }
