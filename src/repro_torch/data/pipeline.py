"""Deterministic synthetic token pipeline with background prefetch.

The reference's ``data/pipeline.py``, which is numpy already, kept here so
that the port imports nothing of the reference.  Every (host, step) pair
maps to its own numpy stream, so

* restarts resume mid-epoch exactly (the step index is the only state),
* each data-parallel host draws a disjoint shard (``host_id``/``n_hosts``),
* a background thread keeps a bounded prefetch queue full, overlapping host
  data generation with device compute.

``batch_at(step)`` gives the reference's batch bit for bit.  Batches are
numpy; the trainer moves them to the device.  The token stream is
Zipf-distributed with a Markov overlay so the loss has learnable structure.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    prefetch: int = 2
    zipf_a: float = 1.3
    n_codebooks: int = 0      # musicgen-style multi-codebook labels
    d_model: int = 0          # >0: emit stub frame embeddings instead of tokens
    mrope: bool = False

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class SyntheticTokenPipeline:
    """Iterator of host-local batches; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_step = 0

    # -- pure generation -----------------------------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, cfg.host_id, step]))
        B, S = cfg.host_batch, cfg.seq_len
        if cfg.d_model:
            emb = rng.normal(0, 0.3, size=(B, S, cfg.d_model)).astype(np.float32)
            out = {"embeddings": emb}
        else:
            # zipf body + shift-structure so next-token prediction is learnable
            z = rng.zipf(cfg.zipf_a, size=(B, S)).astype(np.int64)
            toks = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
            toks[:, 1::2] = (toks[:, ::2][:, : toks[:, 1::2].shape[1]] * 7 + 11) % cfg.vocab_size
            out = {"tokens": toks}
        if cfg.n_codebooks:
            lbl = rng.integers(0, cfg.vocab_size, size=(B, S, cfg.n_codebooks))
            out["labels"] = lbl.astype(np.int32)
        else:
            src = out.get("tokens")
            if src is None:
                out["labels"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
            else:
                out["labels"] = np.concatenate([src[:, 1:], src[:, :1]], axis=1)
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
            out["positions"] = np.broadcast_to(pos[None], (3, B, S)).copy()
        return out

    # -- prefetch loop ---------------------------------------------------------
    def start(self, step: int = 0):
        self._next_step = step
        self._stop.clear()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()
        return self

    def _fill(self):
        while not self._stop.is_set():
            b = self.batch_at(self._next_step)
            while not self._stop.is_set():
                try:
                    self._q.put((self._next_step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_step += 1

    def get(self, timeout: float = 60.0):
        step, batch = self._q.get(timeout=timeout)
        return step, batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        while not self._q.empty():
            self._q.get_nowait()
