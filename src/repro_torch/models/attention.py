"""GQA attention: prefill (the flash kernel on the card, the reference's
plain path elsewhere) and cached decode (the decode-attention kernel on the
card, which reads only the cache slots that hold a token; the plain version
elsewhere and on a mesh).

``p`` is a layer's attention parameters, anything with the tensors ``wq``,
``wk``, ``wv`` and ``wo`` as attributes (the :class:`Attention` module), in
the reference layout: ``x @ wq`` maps ``d_model`` to ``n_heads * head_dim``.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ..distributed import (axis_index, constrain, current_rules, gather_columns, is_sharded,
                           local_apply)
from ..kernels.decode_attention import decode_attention, decode_attention_ref, valid_mask
from ..kernels.flash_attention import flash_attention
from ..runtime.spans import count
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
    """q, k and v, rotated (on a mesh: :func:`_project_qkv_sharded`)."""
    if is_sharded(x):
        return _project_qkv_sharded(p, x, cfg, positions)
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, Dh)
    k = (x @ p.wk).reshape(B, S, Hk, Dh)
    v = (x @ p.wv).reshape(B, S, Hk, Dh)
    return _rotate(q, positions, cfg), _rotate(k, positions, cfg), v


def _rotate(t: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(t, positions, cfg.rope_theta)


def _project_qkv_sharded(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The dry-run's q (B, S, H, Dh) split over the query heads as the
    rules split them.  Where they split over "model", k and v come in the
    same shape and split: each rank projects the kv head(s) its query heads
    read and repeats them to its query heads, as GSPMD gives each rank of
    the reference's program the kv head its query heads use (on a "model"
    axis wider than the kv heads, ranks share one), with no gather.  Where
    they do not, each rank projects a column slice of the kv heads, gathered
    into (B, S, Hk, Dh)."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # pinned to the heads axis before the head split, as the head count
    # divides
    q = constrain(x @ p.wq, ("batch", "seq", "heads"), (B, S, H)).reshape(B, S, H, Dh)
    q = _rotate(q, positions, cfg)
    if not _per_query_head(cfg):
        wk, wv = constrain(p.wk, (None, "heads")), constrain(p.wv, (None, "heads"))
        k = constrain(x @ wk, ("batch", "seq", "kv"), (B, S, Hk)).reshape(B, S, Hk, Dh)
        v = constrain(x @ wv, ("batch", "seq", "kv"), (B, S, Hk)).reshape(B, S, Hk, Dh)
        return q, _rotate(k, positions, cfg), v
    pos_axes = ("batch", "seq") if positions.dim() == 2 else (None, "batch", "seq")
    qax = ("batch", "seq", "heads", None)
    # where the kv heads divide "model" too, each rank holds the columns of
    # its own kv heads (the placement the dry-run computes them in)
    wax = (None, "cache_heads") if kv_heads_split(cfg) else (None, None)
    k, v = local_apply(partial(_kv_per_query_head, cfg=cfg),
                       (q, x, p.wk, p.wv, positions),
                       (qax, ("batch", "seq", None), wax, wax, pos_axes),
                       (0, 0))
    return q, k, v


def _per_query_head(cfg: ModelConfig) -> bool:
    """Whether a mesh step's k and v come per query head: the rules split
    the query heads."""
    return bool(current_rules().spec_for(("heads",), (cfg.n_heads,)))


def kv_heads_split(cfg: ModelConfig) -> bool:
    """Whether the rules split the kv heads (the decode cache's heads): then
    a mesh step computes k and v split by kv head, with the kv projections'
    columns split as the cache's heads are (the launch layer's compute
    placement, ``launch.specs._unshard``)."""
    return bool(current_rules().spec_for(("cache_heads",), (cfg.n_kv_heads,)))


def _kv_per_query_head(q, x, wk, wv, positions, *, cfg: ModelConfig):
    """Local body: k and v (B, S, H_loc, Dh) for this rank's query heads
    (``q``'s ``H_loc`` local heads, from head ``H_loc`` x its "model"
    rank), from the kv heads they read.  ``wk`` and ``wv`` hold every kv
    head's columns, or only this rank's where the kv heads are split."""
    H_loc, Dh = q.shape[2], q.shape[3]
    group = cfg.n_heads // cfg.n_kv_heads
    rank = axis_index("model")
    h0 = rank * H_loc
    j0, j1 = h0 // group, (h0 + H_loc - 1) // group + 1
    # the first column of ``wk``: that of this rank's first kv head, if split
    c0 = 0 if wk.shape[1] == cfg.n_kv_heads * Dh else rank * wk.shape[1]
    cols = slice(j0 * Dh - c0, j1 * Dh - c0)
    B, S, _ = x.shape
    k = (x @ wk[:, cols]).reshape(B, S, j1 - j0, Dh)
    v = (x @ wv[:, cols]).reshape(B, S, j1 - j0, Dh)
    idx = torch.arange(h0, h0 + H_loc, device=x.device) // group - j0
    return _rotate(k, positions, cfg)[:, :, idx], v[:, :, idx]


def _uneven_heads_axis(cfg: ModelConfig) -> str | None:
    """The mesh axis the heads rule names where it does not divide the
    query heads but divides their ``H * Dh`` columns (starcoder2 smoke's 6
    heads on a "model" axis of 4, musicgen's 24 on 16), else None.  The
    projections split there by column, as GSPMD splits them."""
    r = current_rules()
    if r.spec_for(("heads",), (cfg.n_heads,)):
        return None
    sizes = dict(zip(r.mesh.mesh_dim_names, r.mesh.shape))
    axis = next((a for a in r.rules.get("heads", ()) if sizes.get(a, 1) > 1), None)
    return axis if axis and cfg.n_heads * cfg.head_dim % sizes[axis] == 0 else None


def _column_spans(cfg: ModelConfig, n: int) -> list[tuple[int, int, int, int]]:
    """For rank i of ``n`` holding columns ``[i w, (i + 1) w)`` of the
    ``H * Dh`` (``w = H * Dh / n``): the query heads ``[h0, h1)`` those
    columns overlap and the kv heads ``[j0, j1)`` they read."""
    H, Dh = cfg.n_heads, cfg.head_dim
    w, group = H * Dh // n, H // cfg.n_kv_heads
    spans = []
    for i in range(n):
        h0, h1 = i * w // Dh, ((i + 1) * w - 1) // Dh + 1
        spans.append((h0, h1, h0 // group, (h1 - 1) // group + 1))
    return spans


def _my_columns(cfg: ModelConfig, axis: str):
    """(spans, this rank's span, the offset and width of its own columns in
    its heads' ``(h1 - h0) * Dh``) on mesh axis ``axis``."""
    mesh = current_rules().mesh
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    spans = _column_spans(cfg, n)
    r = axis_index(axis)
    w = cfg.n_heads * cfg.head_dim // n
    return spans, spans[r], r * w - spans[r][0] * cfg.head_dim, w


def _attn_by_columns(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                     axis: str) -> torch.Tensor:
    """The dry-run's attention where the query heads do not divide mesh
    axis ``axis``: q, k and v stay split by column as the projections give
    them; each rank gathers the columns of the heads its q columns overlap
    from its neighbours (:func:`gather_columns`), computes those heads, and
    keeps its own columns of their output, which the rows of ``wo`` it
    holds take.  GSPMD splits the reference's heads so, with its halo
    exchanges; gathering q, k and v whole instead would have every rank
    compute every head.  Returns (B, S, D), partial sums over ``axis``."""
    q = x @ p.wq
    k = x @ constrain(p.wk, (None, "heads"))
    v = x @ constrain(p.wv, (None, "heads"))
    ax = ("batch", "seq", "heads")
    pos_axes = ("batch", "seq") if positions.dim() == 2 else (None, "batch", "seq")
    o = local_apply(partial(_columns_body, cfg=cfg, axis=axis), (q, k, v, positions),
                    (ax, ax, ax, pos_axes), (0,))
    return o @ p.wo


def _columns_body(q, k, v, positions, *, cfg: ModelConfig, axis: str):
    """Local body of :func:`_attn_by_columns`."""
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spans, (h0, h1, j0, j1), c0, w = _my_columns(cfg, axis)
    B, S = q.shape[:2]
    qh = gather_columns(q, axis, [(a * Dh, b * Dh) for a, b, _, _ in spans], H * Dh)
    kh, vh = (gather_columns(t, axis, [(c * Dh, d * Dh) for _, _, c, d in spans], Hk * Dh)
              .reshape(B, S, j1 - j0, Dh) for t in (k, v))
    qh = _rotate(qh.reshape(B, S, h1 - h0, Dh), positions, cfg)
    idx = torch.arange(h0, h1, device=q.device) // (H // Hk) - j0
    kh = _rotate(kh, positions, cfg)[:, :, idx]
    o = _attention_core(qh.transpose(1, 2), kh.transpose(1, 2), vh[:, :, idx].transpose(1, 2),
                        causal=True, window=cfg.window, f32_scores=cfg.attn_f32)
    return o.transpose(1, 2).reshape(B, S, (h1 - h0) * Dh)[..., c0:c0 + w]


def _dense_attention(q, k, v, *, causal: bool, window: int | None,
                     f32_scores: bool) -> torch.Tensor:
    """The reference's XLA attention path: q (B,H,S,D), k/v (B,Hkv,S,D),
    or (B,H,S,D) per query head on a mesh -> (B,H,S,D) in q's dtype.
    Scores and softmax are float32 with ``f32_scores``, else in q's dtype
    (the "attn_bf16" variant: it halves the score chain's traffic); masked
    scores are -1e30, or -30000 in bf16."""
    if is_sharded(q) and k.shape[1] == q.shape[1]:      # per query head already
        kr, vr = k, v
    else:
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
    :func:`_dense_attention` with ``f32_scores=cfg.attn_f32``.  On a mesh
    whose heads axis does not divide the query heads the dry-run takes
    :func:`_attn_by_columns` and forms no (k, v) (None): no step reads them.
    """
    B, S, _ = x.shape
    axis = _uneven_heads_axis(cfg) if is_sharded(x) else None
    if axis is not None:
        return _attn_by_columns(p, x, cfg, positions, axis), None
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
    # gradient's head split meets a placement it can view
    o = constrain(o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim),
                  ("batch", "seq", "heads"), (B, S, cfg.n_heads))
    return o @ p.wo, (kh, vh)


def _decode_columns(q, cache_k, cache_v, *, cfg: ModelConfig, axis: str, core):
    """Local body of the decode step where the query heads do not divide
    ``axis``: q (B, 1, H * Dh) whole, the caches whole over ``axis``; this
    rank's own columns of its heads' output (B, 1, w), float32."""
    Dh = cfg.head_dim
    _, (h0, h1, _, _), c0, w = _my_columns(cfg, axis)
    B = q.shape[0]
    idx = torch.arange(h0, h1, device=q.device) // (cfg.n_heads // cfg.n_kv_heads)
    o = core(q[..., h0 * Dh:h1 * Dh].reshape(B, 1, h1 - h0, Dh).transpose(1, 2),
             cache_k[:, idx], cache_v[:, idx])
    return o.transpose(1, 2).reshape(B, 1, (h1 - h0) * Dh)[..., c0:c0 + w]


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
    if is_sharded(q) and _per_query_head(cfg):
        # per query head: each kv head's first copy goes to the cache
        k, v = k[:, :, ::H // Hk], v[:, :, ::H // Hk]
    slot = pos_idx % S_ctx if cfg.window is not None else pos_idx
    cache_k[:, :, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, slot] = v[:, 0].to(cache_v.dtype)
    # the first min(pos + 1, S_ctx) slots hold a token (a ring's are its
    # last writes)
    n_valid = min(pos_idx + 1, S_ctx)
    if not is_sharded(q):
        # GQA without repeating the cache: query head h = kv * group + g; the
        # op counts the slots its route reads
        o = decode_attention(q.reshape(B, Hk, H // Hk, Dh), cache_k, cache_v, n_valid)
        return o.to(x.dtype).reshape(B, 1, H * Dh) @ p.wo, cache_k, cache_v
    # the dry-run on a mesh: the plain core, shard by shard, over all S_ctx
    count(kv_read=S_ctx, kv_valid=n_valid)
    core = partial(decode_attention_ref, valid=valid_mask(S_ctx, n_valid, x.device))
    axis = _uneven_heads_axis(cfg)
    if axis is not None:
        # the query heads do not divide the axis: each rank the heads its
        # columns of wo read, as in :func:`_attn_by_columns`
        cax = ("batch", None, None, None)
        split = current_rules().placements_for(("batch", None, "heads"), (B, 1, H * Dh))
        o = local_apply(partial(_decode_columns, cfg=cfg, axis=axis, core=core),
                        (q.reshape(B, 1, H * Dh), cache_k, cache_v),
                        (("batch", None, None), cax, cax), (split,))
        return o.to(x.dtype) @ p.wo, cache_k, cache_v
    if not kv_heads_split(cfg):
        # the dry-run on a mesh whose "model" axis the kv heads do not
        # divide: the reference's form, the cache repeated to every query
        # head, shard by shard over the batch rows and query heads
        ax = ("batch", "heads", None, None)
        o = local_apply(core, (q.transpose(1, 2), cache_k.repeat_interleave(H // Hk, dim=1),
                               cache_v.repeat_interleave(H // Hk, dim=1)),
                        (ax, ax, ax), (0,))                     # (B,H,1,Dh)
    else:
        # the GQA form as above, the query heads split as the cache's kv
        # heads do, shard by shard
        q = constrain(q, ("batch", None, "cache_heads", None), (B, 1, Hk, Dh))
        ax = ("batch", "cache_heads", None, None)
        o = local_apply(core, (q.reshape(B, Hk, H // Hk, Dh), cache_k, cache_v),
                        (ax, ax, ax), (0,))                     # (B,Hk,g,Dh)
    o = o.to(x.dtype).reshape(B, 1, H * Dh)
    return o @ p.wo, cache_k, cache_v
