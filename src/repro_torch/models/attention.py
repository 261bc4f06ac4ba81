"""GQA attention: prefill through the flash kernel, and cached decode.

``p`` is a layer's attention parameters, anything with the tensors ``wq``,
``wk``, ``wv`` and ``wo`` as attributes (the :class:`Attention` module), in
the reference layout: ``x @ wq`` maps ``d_model`` to ``n_heads * head_dim``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .common import ModelConfig, apply_mrope, apply_rope


class Attention(nn.Module):
    """One layer's projections (no computation of its own)."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor):
        super().__init__()
        self.wq = nn.Parameter(wq, requires_grad=False)
        self.wk = nn.Parameter(wk, requires_grad=False)
        self.wv = nn.Parameter(wv, requires_grad=False)
        self.wo = nn.Parameter(wo, requires_grad=False)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, Dh)
    k = (x @ p.wk).reshape(B, S, Hk, Dh)
    v = (x @ p.wv).reshape(B, S, Hk, Dh)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Full-sequence attention (prefill).  x: (B, S, D) -> (out, (k, v)).

    Through :func:`flash_attention`, which launches the CUDA kernel on a CUDA
    tensor and runs the plain version on a CPU tensor.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    qh = q.transpose(1, 2)   # (B,H,S,Dh)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    o = flash_attention(qh, kh, vh, causal=True, window=cfg.window)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return o @ p.wo, (kh, vh)


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos_idx: int):
    """Single-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, Hkv, S_ctx, Dh) — for sliding-window models
    the cache is a ring buffer of size ``min(context, window)``.
    ``pos_idx`` is the absolute position of the new token.  The new key and
    value are written into the caches in place (slot ``pos_idx % S_ctx`` for
    a ring); returns (out, cache_k, cache_v).
    """
    B = x.shape[0]
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_ctx = cache_k.shape[2]
    if cfg.window is None and not 0 <= pos_idx < S_ctx:
        raise IndexError(f"position {pos_idx} outside the cache of {S_ctx}")
    positions = torch.full((B, 1), pos_idx, dtype=torch.long, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = pos_idx % S_ctx if cfg.window is not None else pos_idx
    cache_k[:, :, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, slot] = v[:, 0].to(cache_v.dtype)
    # GQA without repeating the cache: query head h = kv * group + g
    qg = q.reshape(B, Hk, H // Hk, Dh).float()
    s = torch.matmul(qg, cache_k.float().transpose(-1, -2))   # (B,Hk,g,S_ctx)
    s = s / torch.sqrt(torch.tensor(float(Dh)))
    kpos = torch.arange(S_ctx, device=x.device)
    if cfg.window is not None:
        # ring buffer: valid entries are the last min(pos+1, window) writes
        valid = kpos < min(pos_idx + 1, S_ctx)
    else:
        valid = kpos <= pos_idx
    s = s.masked_fill(~valid, -1e30)
    o = torch.matmul(torch.softmax(s, dim=-1), cache_v.float())   # (B,Hk,g,Dh)
    o = o.to(x.dtype).reshape(B, 1, H * Dh)
    return o @ p.wo, cache_k, cache_v
