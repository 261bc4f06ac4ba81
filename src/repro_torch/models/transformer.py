"""Decoder LM for every architecture family: dense and MoE transformers
(GQA, RoPE, SWA, M-RoPE), Jamba-style hybrids (Mamba mixers with periodic
attention and periodic MoE), RWKV-6 and the stub-frontend modalities.

:class:`DecoderLM` holds one :class:`Block` per layer in an
``nn.ModuleList``.  The module-level functions keep the reference package's
names and arguments:

* :func:`forward` / :func:`loss_fn` — full-sequence logits and loss,
* :func:`prefill` — the full forward, last-position logits,
* :func:`init_cache` + :func:`decode_step` — cached single-token decode.

``params`` is a :class:`DecoderLM`.  Build one from a parameter tree in the
reference layout: ``DecoderLM(cfg, init_params(cfg, seed=0))``, or
:func:`repro_torch.models.convert.params_from_arrays` for the reference's
own parameters.  Its parameters are frozen, as serving wants them;
``model.requires_grad_(True)`` makes them trainable, as
:class:`repro_torch.runtime.trainer.Trainer` does.

Activations are pinned with :func:`repro_torch.distributed.constrain` at
the reference's sites (the embedding, each block's two residual sums, the
logits): a no-op on plain tensors, a redistribution of ``DTensor``s under
an active ``axis_rules`` context (the dry-run).

Spans (:mod:`repro_torch.runtime.spans`, recorded only under the profiler
or ``spans.recording()``): ``prefill`` and ``decode_step`` are roots;
inside a full forward each block's ``norm`` (its two RMSNorms) and
``logits`` (:meth:`DecoderLM.logits_out` over every position); inside a
decode step each attention layer's ``attn``, which ``attn_decode`` gives
the cache positions it reads and those that hold a token.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed import constrain
from ..runtime.spans import span
from .attention import Attention, attn_decode, attn_forward
from .common import ModelConfig, cross_entropy, rmsnorm
from .mamba import Mamba, mamba_decode, mamba_forward, mamba_init_state
from .moe import MoE, moe_forward
from .rwkv import ChannelMix, TimeMix, rwkv_channel_mix, rwkv_init_state, rwkv_time_mix

ACT = ("batch", "seq", "act_embed")


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
    """Pre-norm mixer + FFN, one layer; the kinds come from
    ``cfg.layer_kind``: mixer attention, Mamba or RWKV-6 time mix; FFN
    dense, MoE or RWKV-6 channel mix."""

    def __init__(self, cfg: ModelConfig, p: dict, kind: dict):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm_mixer = _param(p["norm_mixer"])
        self.norm_ffn = _param(p["norm_ffn"])
        if kind["mixer"] == "attn":
            self.attn = Attention(**p["attn"])
        elif kind["mixer"] == "mamba":
            self.mamba = Mamba(**p["mamba"])
        else:
            self.rwkv = TimeMix(**p["rwkv"])
        if kind["ffn"] == "dense":
            self.ffn = DenseFFN(**p["ffn"])
        elif kind["ffn"] == "moe":
            self.moe = MoE(**p["moe"])
        else:
            self.cmix = ChannelMix(**p["cmix"])

    def _ffn(self, h: torch.Tensor, hn: torch.Tensor,
             state: dict | None = None) -> torch.Tensor:
        """``h`` plus the FFN of ``hn``, which is ``h`` after ``norm_ffn``."""
        if self.kind["ffn"] == "dense":
            return h + self.ffn(hn)
        if self.kind["ffn"] == "moe":
            return h + moe_forward(self.moe, hn, self.cfg)
        y, st = rwkv_channel_mix(self.cmix, hn, self.cfg, state)
        if state is not None:
            state["shift"].copy_(st["shift"])
        return h + y

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with span("norm", h.device):
            hn = rmsnorm(h, self.norm_mixer, cfg.norm_eps)
        if self.kind["mixer"] == "attn":
            y, _ = attn_forward(self.attn, hn, cfg, positions)
        elif self.kind["mixer"] == "mamba":
            y = mamba_forward(self.mamba, hn, cfg)
        else:
            y, _ = rwkv_time_mix(self.rwkv, hn, cfg)
        h = constrain(h + y, ACT)
        with span("norm", h.device):
            hn = rmsnorm(h, self.norm_ffn, cfg.norm_eps)
        return constrain(self._ffn(h, hn), ACT)

    def decode(self, h: torch.Tensor, c: dict, pos_idx: int) -> torch.Tensor:
        """One token; ``c`` is this layer's cache (views), updated in place."""
        cfg = self.cfg
        hn = rmsnorm(h, self.norm_mixer, cfg.norm_eps)
        state = None
        if self.kind["mixer"] == "attn":
            with span("attn", h.device):
                y, _, _ = attn_decode(self.attn, hn, cfg, c["k"], c["v"], pos_idx)
        elif self.kind["mixer"] == "mamba":
            y, st = mamba_decode(self.mamba, hn, cfg, c)
            c["conv"].copy_(st["conv"])
            c["ssm"].copy_(st["ssm"])
        else:
            y, st = rwkv_time_mix(self.rwkv, hn, cfg, state=c["att"])
            c["att"]["shift"].copy_(st["shift"])
            c["att"]["wkv"].copy_(st["wkv"])
            state = c["cmix"]
        h = constrain(h + y, ACT)
        return constrain(self._ffn(h, rmsnorm(h, self.norm_ffn, cfg.norm_eps), state), ACT)


class DecoderLM(nn.Module):
    """The model, built from a parameter tree in the reference layout.

    ``params["blocks"]["pos{i}"]`` leaves carry a leading group axis
    (``n_groups``); layer ``g * period + i`` takes slice ``g`` of position
    ``i`` — a view, so building the module copies nothing.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
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
            Block(cfg, _slice(blocks[f"pos{i}"], g), cfg.layer_kind(i))
            for g in range(cfg.n_groups) for i in range(cfg.period))

    def embed_in(self, batch: dict) -> torch.Tensor:
        if self.cfg.frontend == "audio":
            h = batch["embeddings"].to(self.cfg.torch_dtype)      # stub: (B,S,D)
        else:
            # F.embedding, not indexing: DTensor looks a vocab-sharded table
            # up shard by shard (masked, then summed) instead of gathering it
            h = F.embedding(batch["tokens"].long(), self.embed)
        return constrain(h, ACT)

    def logits_out(self, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(h, self.final_norm, self.cfg.norm_eps)
        if self.cfg.frontend == "audio":
            return constrain(torch.einsum("bsd,cdv->bscv", h, self.heads_out),
                             ("batch", "seq", None, "vocab"))
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return constrain(h @ w, ("batch", "seq", "vocab"))

    def forward(self, batch: dict) -> torch.Tensor:
        """Logits of the whole sequence.  With ``cfg.remat`` and autograd
        on, each scan group (``cfg.period`` layers) runs under
        ``torch.utils.checkpoint``, as the reference wraps its group body in
        ``jax.checkpoint``: the backward runs the group's forward again, and
        the numbers are those without remat."""
        h = self.embed_in(batch)
        B, S = h.shape[:2]
        positions = _positions(self.cfg, batch, B, S, h.device)
        P = self.cfg.period
        remat = self.cfg.remat and torch.is_grad_enabled()
        for g in range(0, len(self.blocks), P):
            group = self.blocks[g:g + P]
            if remat:
                h = checkpoint(_group_forward, group, h, positions,
                               use_reentrant=False)
            else:
                h = _group_forward(group, h, positions)
        with span("logits", h.device):
            return self.logits_out(h)


def _group_forward(blocks: nn.ModuleList, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    for blk in blocks:
        h = blk(h, positions)
    return h


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
    with span("prefill", params.final_norm.device):
        return forward(params, cfg, batch)[:, -1]


def init_cache(cfg: ModelConfig, batch_size: int, context: int,
               device: "str | torch.device | None" = None) -> dict:
    """Zero decode caches for every layer, stacked per period position (a
    leading group axis G = ``n_groups``).  Attention: ``{"pos{i}": {"k":
    (G, B, Hkv, kv_len, Dh), "v": ...}}``; a window model's ``kv_len`` is
    ``min(context, window)`` (a ring buffer).  Mamba: ``{"pos{i}": {"conv":
    (G, B, d_conv - 1, Di), "ssm": (G, B, Di, d_state) float32}}``.  RWKV-6:
    ``{"pos{i}": {"att": {"shift": (G, B, D), "wkv": (G, B, H, N, N)
    float32}, "cmix": {"shift": (G, B, D)}}}``, shifts in the model dtype."""
    dev = resolve_device(device)
    G, dt = cfg.n_groups, cfg.torch_dtype
    kv_len = min(context, cfg.window) if cfg.window else context
    cache: dict[str, Any] = {}
    for i in range(cfg.period):
        mixer = cfg.layer_kind(i)["mixer"]
        if mixer == "attn":
            shape = (G, batch_size, cfg.n_kv_heads, kv_len, cfg.head_dim)
            cache[f"pos{i}"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                                "v": torch.zeros(shape, dtype=dt, device=dev)}
        elif mixer == "mamba":
            cache[f"pos{i}"] = _stack(
                mamba_init_state(cfg, batch_size, dt, dev), G)
        else:
            st = rwkv_init_state(cfg, batch_size, dt, dev)
            cache[f"pos{i}"] = _stack(st, G)
    return cache


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes matching :func:`init_cache` (for the dry-run's
    shardings)."""
    per_pos: dict[str, Any] = {}
    for i in range(cfg.period):
        mixer = cfg.layer_kind(i)["mixer"]
        if mixer == "attn":
            ax = ("layers", "cache_batch", "cache_heads", "kv_seq", None)
            per_pos[f"pos{i}"] = {"k": ax, "v": ax}
        elif mixer == "mamba":
            per_pos[f"pos{i}"] = {"conv": ("layers", "cache_batch", None, "ffn"),
                                  "ssm": ("layers", "cache_batch", "ffn", None)}
        else:
            per_pos[f"pos{i}"] = {
                "att": {"shift": ("layers", "cache_batch", "act_embed"),
                        "wkv": ("layers", "cache_batch", "cache_heads", None, None)},
                "cmix": {"shift": ("layers", "cache_batch", "act_embed")},
            }
    return per_pos


def _stack(tree: dict, G: int) -> dict:
    return {k: _stack(v, G) if isinstance(v, dict)
            else v[None].expand(G, *v.shape).contiguous() for k, v in tree.items()}


def decode_step(params: DecoderLM, cfg: ModelConfig, cache: dict, batch: dict,
                pos_idx: int):
    """One-token decode.  batch: {"tokens": (B,1)} (audio: {"embeddings":
    (B,1,D)}); ``pos_idx``: absolute position.  Updates ``cache`` in place and
    returns (logits (B,V) or (B,C,V), cache)."""
    with span("decode_step", params.final_norm.device):
        h = params.embed_in(batch)
        for layer, blk in enumerate(params.blocks):
            g, i = divmod(layer, cfg.period)
            h = blk.decode(h, _slice(cache[f"pos{i}"], g), pos_idx)
        return params.logits_out(h)[:, 0], cache
