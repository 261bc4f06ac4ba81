"""GQA attention: prefill (the flash kernel on the card, the reference's
plain path elsewhere) and cached decode.

``p`` is a layer's attention parameters, anything with the tensors ``wq``,
``wk``, ``wv`` and ``wo`` as attributes (the :class:`Attention` module), in
the reference layout: ``x @ wq`` maps ``d_model`` to ``n_heads * head_dim``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributed import constrain, local_apply
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
    # the projections pinned to their weights' head axes before the head
    # split, as the head counts divide (no-ops outside the dry-run's rules)
    q = constrain(x @ p.wq, ("batch", "seq", "heads"), (B, S, H)).reshape(B, S, H, Dh)
    k = constrain(x @ p.wk, ("batch", "seq", "kv"), (B, S, Hk)).reshape(B, S, Hk, Dh)
    v = constrain(x @ p.wv, ("batch", "seq", "kv"), (B, S, Hk)).reshape(B, S, Hk, Dh)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _dense_attention(q, k, v, *, causal: bool, window: int | None,
                     f32_scores: bool) -> torch.Tensor:
    """The reference's XLA attention path: q (B,H,S,D), k/v (B,Hkv,S,D) ->
    (B,H,S,D) in q's dtype.  Scores and softmax are float32 with
    ``f32_scores``, else in q's dtype (the "attn_bf16" variant: it halves the
    score chain's traffic); masked scores are -1e30, or -30000 in bf16."""
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    ax = ("batch", "heads", "seq", None)
    return local_apply(lambda *a: _attention_core(*a, causal=causal, window=window,
                                                  f32_scores=f32_scores),
                       (q, kr, vr), (ax, ax, ax), (0,))


def _attention_core(q, kr, vr, *, causal: bool, window: int | None,
                    f32_scores: bool) -> torch.Tensor:
    """:func:`_dense_attention` after the GQA repeat: local to each batch
    row and head."""
    B, H, S, D = q.shape
    cdt = torch.float32 if f32_scores else q.dtype
    kr, vr = kr.to(cdt), vr.to(cdt)
    s = torch.matmul(q.to(cdt), kr.transpose(-1, -2))
    s = s * (1.0 / (D ** 0.5))
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s = torch.where(mask, s, -30000.0 if cdt == torch.bfloat16 else -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), vr).to(q.dtype)


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Full-sequence attention (prefill).  x: (B, S, D) -> (out, (k, v)).

    A CUDA tensor goes through :func:`flash_attention`, the hand-written
    kernel, which computes its softmax in float32 whatever ``cfg.attn_f32``
    says, as the reference's TPU route ignores it.  Any other tensor (the
    CPU, the dry-run's ``meta`` shards) takes the reference's plain path,
    :func:`_dense_attention` with ``f32_scores=cfg.attn_f32``.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    qh = q.transpose(1, 2)   # (B,H,S,Dh)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if x.device.type == "cuda":
        o = flash_attention(qh, kh, vh, causal=True, window=cfg.window)
    else:
        o = _dense_attention(qh, kh, vh, causal=True, window=cfg.window,
                             f32_scores=cfg.attn_f32)
    # pinned to the heads axis as the head count divides, so the
    # gradient's head split meets a placement it can view (24 heads on 16)
    o = constrain(o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim),
                  ("batch", "seq", "heads"), (B, S, cfg.n_heads))
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
    # GQA without repeating the cache: query head h = kv * group + g; the
    # query heads split as the cache's kv heads do (the dry-run's rules)
    q = constrain(q, ("batch", None, "cache_heads", None), (B, 1, Hk, Dh))
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
