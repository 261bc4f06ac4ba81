"""Decoder LM for the attention-only families: dense, vlm (M-RoPE) and audio.

:class:`DecoderLM` holds one :class:`Block` per layer in an
``nn.ModuleList``.  The module-level functions keep the reference package's
names and arguments:

* :func:`forward` / :func:`loss_fn` — full-sequence logits and loss,
* :func:`prefill` — the full forward, last-position logits,
* :func:`init_cache` + :func:`decode_step` — cached single-token decode.

``params`` is a :class:`DecoderLM`.  Build one from a parameter tree in the
reference layout: ``DecoderLM(cfg, init_params(cfg, seed=0))``, or
:func:`repro_torch.models.convert.params_from_arrays` for the reference's
own parameters.  Experts, Mamba and RWKV-6 mixers are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .attention import Attention, attn_decode, attn_forward
from .common import ModelConfig, cross_entropy, rmsnorm

_NOT_PORTED = "not ported yet (ROADMAP queue 1, item 9)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the families this port lacks."""
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts FFN {_NOT_PORTED}")
    if cfg.ssm == "mamba" or cfg.attn_every:
        raise NotImplementedError(f"{cfg.name}: Mamba mixers {_NOT_PORTED}")
    if cfg.ssm == "rwkv6":
        raise NotImplementedError(f"{cfg.name}: RWKV-6 mixers {_NOT_PORTED}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseFFN(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate = _param(w_gate)
        self.w_up = _param(w_up)
        self.w_down = _param(w_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class Block(nn.Module):
    """Pre-norm attention + dense FFN, one layer."""

    def __init__(self, cfg: ModelConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.norm_mixer = _param(p["norm_mixer"])
        self.norm_ffn = _param(p["norm_ffn"])
        self.attn = Attention(**p["attn"])
        self.ffn = DenseFFN(**p["ffn"])

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y, _ = attn_forward(self.attn, rmsnorm(h, self.norm_mixer, cfg.norm_eps),
                            cfg, positions)
        h = h + y
        return h + self.ffn(rmsnorm(h, self.norm_ffn, cfg.norm_eps))

    def decode(self, h: torch.Tensor, c: dict, pos_idx: int) -> torch.Tensor:
        cfg = self.cfg
        y, _, _ = attn_decode(self.attn, rmsnorm(h, self.norm_mixer, cfg.norm_eps),
                              cfg, c["k"], c["v"], pos_idx)
        h = h + y
        return h + self.ffn(rmsnorm(h, self.norm_ffn, cfg.norm_eps))


class DecoderLM(nn.Module):
    """The model, built from a parameter tree in the reference layout.

    ``params["blocks"]["pos{i}"]`` leaves carry a leading group axis
    (``n_groups``); layer ``g * period + i`` takes slice ``g`` of position
    ``i`` — a view, so building the module copies nothing.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        if not cfg.scan_layers:
            raise ValueError(f"{cfg.name}: expected the stacked (scan_layers) "
                             "parameter layout")
        self.cfg = cfg
        if cfg.frontend == "audio":
            self.heads_out = _param(params["heads_out"])
        else:
            self.embed = _param(params["embed"])
            if not cfg.tie_embeddings:
                self.lm_head = _param(params["lm_head"])
        self.final_norm = _param(params["final_norm"])
        blocks = params["blocks"]
        self.blocks = nn.ModuleList(
            Block(cfg, _slice(blocks[f"pos{i}"], g))
            for g in range(cfg.n_groups) for i in range(cfg.period))

    def embed_in(self, batch: dict) -> torch.Tensor:
        if self.cfg.frontend == "audio":
            return batch["embeddings"].to(self.cfg.torch_dtype)   # stub: (B,S,D)
        return self.embed[batch["tokens"].long()]

    def logits_out(self, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(h, self.final_norm, self.cfg.norm_eps)
        if self.cfg.frontend == "audio":
            return torch.einsum("bsd,cdv->bscv", h, self.heads_out)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return h @ w

    def forward(self, batch: dict) -> torch.Tensor:
        h = self.embed_in(batch)
        B, S = h.shape[:2]
        positions = _positions(self.cfg, batch, B, S, h.device)
        for blk in self.blocks:
            h = blk(h, positions)
        return self.logits_out(h)


def _slice(tree: dict, g: int) -> dict:
    return {k: _slice(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int,
               device: torch.device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"].to(device)                 # (B,S) or (3,B,S)
    pos = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        return pos[None].expand(3, B, S)
    return pos


# ---------------------------------------------------------------------------
# the reference package's entry points
# ---------------------------------------------------------------------------

def forward(params: DecoderLM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence logits: (B, S, V) (audio: (B, S, codebooks, V))."""
    return params(batch)


def loss_fn(params: DecoderLM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return cross_entropy(forward(params, cfg, batch), batch["labels"])


def prefill(params: DecoderLM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Prefill: the full forward's (B, S, V) logits at the last position."""
    return forward(params, cfg, batch)[:, -1]


def init_cache(cfg: ModelConfig, batch_size: int, context: int,
               device: "str | torch.device | None" = None) -> dict:
    """Zero KV caches for every layer, stacked per period position:
    ``{"pos{i}": {"k": (G, B, Hkv, kv_len, Dh), "v": ...}}``; a window model's
    ``kv_len`` is ``min(context, window)`` (a ring buffer)."""
    check_supported(cfg)
    dev = resolve_device(device)
    kv_len = min(context, cfg.window) if cfg.window else context
    shape = (cfg.n_groups, batch_size, cfg.n_kv_heads, kv_len, cfg.head_dim)
    return {f"pos{i}": {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}
            for i in range(cfg.period)}


def decode_step(params: DecoderLM, cfg: ModelConfig, cache: dict, batch: dict,
                pos_idx: int):
    """One-token decode.  batch: {"tokens": (B,1)} (audio: {"embeddings":
    (B,1,D)}); ``pos_idx``: absolute position.  Updates ``cache`` in place and
    returns (logits (B,V) or (B,C,V), cache)."""
    h = params.embed_in(batch)
    for layer, blk in enumerate(params.blocks):
        g, i = divmod(layer, cfg.period)
        c: dict[str, Any] = cache[f"pos{i}"]
        h = blk.decode(h, {"k": c["k"][g], "v": c["v"][g]}, pos_idx)
    return params.logits_out(h)[:, 0], cache
