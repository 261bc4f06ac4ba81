"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

The reference's ``models/moe.py``, formulation for formulation. Tokens are
routed with ``topk`` and a softmax renormalised over the chosen experts,
bucketed per expert by an exclusive cumulative count (no atomics decide a
position), gathered into a dense ``(E, capacity, D)`` buffer, run through
batched SwiGLU products and combined back.

Capacity drops follow the standard convention: a token routed beyond
``capacity = tokens · top_k · capacity_factor / E`` for an expert is dropped
for that expert (its gate weight is zeroed); the residual stream still
carries it forward.

Three variants (``cfg.moe_impl``):

* ``"global"`` — one bucketing over all ``B·S`` tokens, gather-combine;
* ``"local"`` — per batch row, scatters in both directions (dispatch and
  combine);
* ``"shmap"`` — the reference's expert-parallel form: route over every
  expert, keep a range of them, bucket per batch row (positions by a stable
  sort), compute, scatter back.

On one device ``"local"`` and ``"shmap"`` run every expert, the reference's
meshless path.  On a mesh whose "model" axis divides the experts (the
dry-run's), both run expert-parallel as the reference's ``shard_map`` body
does: each "model" rank keeps its ``E / M`` experts, computes a partial
output on its batch rows and one all-reduce over "model" sums them
(:func:`~repro_torch.distributed.local_apply` with ``reduce_over``).

The global form on a mesh (the dry-run's) partitions as GSPMD partitions
the reference's (:func:`_global_on_mesh`): each "model" rank keeps its
experts and each rank of the data axes a column block of D, the tokens
reach that split by one all-to-all and leave it by another, the gate and
up products sum their column blocks by an all-reduce, so no rank repeats
another's expert products and no rank gathers whole expert outputs.  The
expert products are plain batched matmuls and the scatters
``index_add_``/``scatter_add_``, as the reference computes them outside
any Pallas kernel.  DTensor has no strategy for those scatters, so on a
mesh they run through ``local_apply``: the global form's dispatch and
combine on each rank's column block, the double scatter on each rank's
batch rows.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import (axis_index, block_index, constrain, current_rules, exchange,
                           gather_blocks, is_sharded, local_apply, mesh_axes)
from .common import ModelConfig

__all__ = ["MoE", "moe_forward", "moe_forward_global", "moe_forward_local",
           "moe_forward_shmap"]


class MoE(nn.Module):
    """One layer's router and stacked expert weights (no computation of its
    own): ``router (D, E)``, ``w_gate``/``w_up (E, D, F)``, ``w_down
    (E, F, D)``."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router = nn.Parameter(router, requires_grad=False)
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe_impl == "local":
        return moe_forward_local(p, x, cfg)
    if cfg.moe_impl == "shmap":
        return moe_forward_shmap(p, x, cfg)
    return moe_forward_global(p, x, cfg)


def _route(x: torch.Tensor, router: torch.Tensor, K: int):
    """float32 router logits -> top-k (gates renormalised by a softmax over
    the k, experts)."""
    logits = x.float() @ router.float()
    gates, experts = torch.topk(logits, K, dim=-1)
    return torch.softmax(gates, dim=-1), experts


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    return int(max(1, round(tokens * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts)))


def _swiglu_experts(he: torch.Tensor, w_gate, w_up, w_down,
                    hidden: tuple | None = None) -> torch.Tensor:
    """``he (..., E, C, D)`` through each expert's SwiGLU -> ``(..., E, C, D)``;
    on a mesh the gate and up products are pinned to ``hidden``."""
    g = torch.einsum("...ecd,edf->...ecf", he, w_gate)
    u = torch.einsum("...ecd,edf->...ecf", he, w_up)
    if hidden is not None:
        g, u = constrain(g, hidden), constrain(u, hidden)
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * u, w_down)


def _dispatch(xt: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              n_slots: int) -> torch.Tensor:
    """The kept token copies of ``xt (N, D)`` summed into ``n_slots`` rows
    (``K = slot.numel() // N`` copies a token, in token-major order)."""
    K = slot.shape[0] // xt.shape[0]
    src = torch.repeat_interleave(xt, K, dim=0)               # (N*K, D)
    src = torch.where(keep[:, None], src, 0)
    buf = xt.new_zeros((n_slots, xt.shape[1]))
    buf.index_add_(0, slot, src)
    return buf


def moe_forward_global(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); ``p`` has ``router``, ``w_gate``, ``w_up``
    and ``w_down`` (:class:`MoE`)."""
    if is_sharded(x):
        return _global_on_mesh(p, x, cfg)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xt = x.reshape(N, D)
    gates, experts = _route(xt, p.router, K)                  # (N, K)
    capacity = _capacity(N, cfg)
    slot, keep = _slots(experts, E, capacity)

    # dispatch into a dense (E*capacity, D) buffer; a dropped copy adds 0
    he = _dispatch(xt, slot, keep, E * capacity).reshape(E, capacity, D)
    out_e = _swiglu_experts(he, p.w_gate, p.w_up, p.w_down)

    # combine: gather the slots back, weight by the gates, sum over k
    tok_out = out_e.reshape(E * capacity, D)[slot]             # (N*K, D)
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None].to(tok_out.dtype)
    return (tok_out * w).reshape(N, K, D).sum(1).reshape(B, S, D)


def _slots(experts: torch.Tensor, E: int, capacity: int):
    """The slot of each token copy (``experts`` (N, K), token-major) in the
    (E·capacity) buffer, and whether it is kept: its position within its
    expert is the number of earlier copies routed there (exclusive one-hot
    cumsum); a dropped copy points at its expert's slot 0."""
    flat_expert = experts.reshape(-1)                          # (N*K,)
    onehot = F.one_hot(flat_expert, E)                         # (N*K, E)
    pos_in_expert = torch.cumsum(onehot, 0) - onehot
    pos = torch.gather(pos_in_expert, 1, flat_expert[:, None])[:, 0]
    keep = pos < capacity
    return flat_expert * capacity + torch.where(keep, pos, 0), keep


def _global_on_mesh(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The global form on a mesh, as GSPMD partitions the reference's: each
    "model" rank keeps its experts, each rank of the data axes a column
    block of D.  The tokens go from their row split to that column split by
    one all-to-all over the data axes, each rank scatters every token's
    copies into its experts' slots (the slots of every token: the routing is
    gathered as indices), the gate and up products sum over the data axes'
    column blocks (an all-reduce), the down product's output keeps the
    column split, and the combine is the dispatch reversed: the copies' rows
    gathered locally, one all-to-all back to the row split, the gates
    applied, and one all-reduce over "model" of the partial (B, S, D).
    Where D does not split as the tokens do, every data rank takes every
    token."""
    r = current_rules()
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    capacity = _capacity(N, cfg)
    rows = _batch_axes(r, N)
    if _batch_axes(r, D) != rows:
        rows = ()
    tok, cols = (("batch", None), "batch") if rows else ((None, None), None)
    split = r.spec_for(("experts",), (E,))
    E_loc = E // _axis_size(r, "model") if split else E
    xt = x.reshape(N, D)
    whole = r.placements_for((), ())
    slot, keep, w = local_apply(partial(_route_slots, cfg=cfg, capacity=capacity, rows=rows),
                                (xt, p.router), (tok, (None, None)), (whole, whole, 0))
    he_axes = ("experts", None, cols)
    n = math.prod(_axis_size(r, a) for a in rows)
    he = local_apply(partial(_dispatch_columns, n=n, capacity=capacity, E_loc=E_loc,
                             rows=rows, split=bool(split)),
                     (xt, slot, keep), (tok, (None,), (None,)),
                     (r.placements_for(he_axes, (E, capacity, D)),))
    out_e = constrain(_swiglu_experts(he, constrain(p.w_gate, ("experts", cols, None)),
                                      constrain(p.w_up, ("experts", cols, None)),
                                      constrain(p.w_down, ("experts", None, cols)),
                                      hidden=("experts", None, None)), he_axes)
    out = local_apply(partial(_combine_rows, n=n, K=K, capacity=capacity, E_loc=E_loc,
                              rows=rows, split=bool(split)),
                      (out_e, slot, w), (he_axes, (None,), ("batch",) if rows else (None,)),
                      (r.placements_for(tok, (N, D)),),
                      reduce_over="model" if split else None)
    return constrain(out.reshape(B, S, D), ("batch", "seq", "act_embed"))


def _axis_size(r, name: str) -> int:
    return dict(zip(r.mesh.mesh_dim_names, r.mesh.shape))[name]


def _batch_axes(r, size: int) -> tuple[str, ...]:
    """The mesh axes "batch" splits a dimension of ``size`` over."""
    spec = r.spec_for(("batch",), (size,))
    return mesh_axes(spec[0]) if spec else ()


def _route_slots(xt, router, *, cfg: ModelConfig, capacity: int, rows: tuple):
    """Local body: route this rank's tokens, gather every token's experts
    over ``rows`` (indices only) and return the slot and kept flag of every
    token copy, with this rank's copies' gate weights (zero where dropped)."""
    gates, experts = _route(xt, router, cfg.top_k)
    slot, keep = _slots(gather_blocks(experts, rows), cfg.n_experts, capacity)
    n = gates.numel()
    mine = keep[block_index(rows) * n:][:n]
    return slot, keep, gates.reshape(-1) * mine.to(gates.dtype)


def _local_slots(slot, *, capacity: int, E_loc: int, split: bool):
    """Which copies this "model" rank's experts take, and their slot in its
    (E_loc·capacity) block."""
    lo = axis_index("model") * E_loc * capacity if split else 0
    mine = (slot >= lo) & (slot < lo + E_loc * capacity)
    return mine, torch.where(mine, slot - lo, 0)


def _dispatch_columns(xt, slot, keep, *, n: int, capacity: int, E_loc: int,
                      rows: tuple, split: bool):
    """Local body: this rank's rows to every token's column block (one
    all-to-all over ``rows``, ``n`` ranks), their kept copies scattered
    into this rank's experts' slots -> (E_loc, capacity, D / n)."""
    N_loc, D = xt.shape
    xd = exchange(xt.reshape(N_loc, n, D // n).movedim(1, 0), rows).reshape(-1, D // n)
    mine, local = _local_slots(slot, capacity=capacity, E_loc=E_loc, split=split)
    buf = _dispatch(xd, local, keep & mine, E_loc * capacity)
    return buf.reshape(E_loc, capacity, D // n)


def _combine_rows(out_e, slot, w, *, n: int, K: int, capacity: int, E_loc: int,
                  rows: tuple, split: bool):
    """Local body: every token copy's row of this rank's experts' outputs
    (its column block), back to the row split (one all-to-all over
    ``rows``, ``n`` ranks), weighted by this rank's gates and summed over
    the k copies: this rank's experts' share of its rows' output."""
    mine, local = _local_slots(slot, capacity=capacity, E_loc=E_loc, split=split)
    D_loc = out_e.shape[-1]
    tok = out_e.reshape(-1, D_loc)[local] * mine[:, None].to(out_e.dtype)   # (N*K, D_loc)
    tok = exchange(tok.reshape(n, -1, D_loc), rows).movedim(0, 1).reshape(-1, n * D_loc)
    return (tok * w[:, None].to(tok.dtype)).reshape(-1, K, n * D_loc).sum(1)


def _double_scatter_rows(x, gates, slot, w_gate, w_up, w_down, *,
                         n_slots: int) -> torch.Tensor:
    """Per batch row: scatter the kept token copies into ``n_slots`` expert
    slots (index ``n_slots`` is the sink of dropped copies), run the experts
    and scatter-add their gated outputs back to the token positions."""
    B, S, D = x.shape
    K = slot.shape[1] // S
    E_loc = w_gate.shape[0]
    dev = x.device
    idx = slot[..., None].expand(B, S * K, D)
    src = torch.repeat_interleave(x, K, dim=1)                 # (B, S*K, D)
    buf = x.new_zeros((B, n_slots + 1, D))
    buf.scatter_add_(1, idx, src)
    out_e = _swiglu_experts(buf[:, :n_slots].reshape(B, E_loc, -1, D),
                            w_gate, w_up, w_down)

    tok_idx = (torch.arange(S * K, device=dev) // K).expand(B, S * K)
    w_slot = gates.new_zeros((B, n_slots + 1))
    w_slot.scatter_add_(1, slot, gates.reshape(B, S * K))
    tos = slot.new_full((B, n_slots + 1), S)
    tos.scatter_(1, slot, tok_idx)
    contrib = (out_e.reshape(B, n_slots, D)
               * w_slot[:, :n_slots, None].to(x.dtype))
    out = x.new_zeros((B, S + 1, D))
    out.scatter_add_(1, tos[:, :n_slots, None].expand(B, n_slots, D), contrib)
    return out[:, :S]


def _positions_by_cumsum(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each token copy within its expert's arrival order, per
    batch row: the exclusive one-hot cumsum (the ``moe_local`` form)."""
    onehot = F.one_hot(flat_e, E)                              # (B, S*K, E)
    pos_in_e = torch.cumsum(onehot, 1) - onehot                # exclusive, per row
    return torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]


def _positions_by_sort(flat_e: torch.Tensor) -> torch.Tensor:
    """The positions of :func:`_positions_by_cumsum` without its
    ``(B, S·K, E)`` tensor (the ``moe_shmap`` form): a stable sort groups
    copies by expert, a position is the distance to its segment's start,
    scattered back to arrival order."""
    B, SK = flat_e.shape
    se, order = torch.sort(flat_e, dim=1, stable=True)
    idx = torch.arange(SK, device=flat_e.device).expand(B, SK)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return torch.zeros_like(flat_e).scatter_(1, order, idx - seg_start)


def _bucketed_expert_math(x: torch.Tensor, router, w_gate, w_up, w_down, *,
                          cfg: ModelConfig, e_lo: int, E_loc: int,
                          positions) -> torch.Tensor:
    """Route over ALL experts, keep the local range ``[e_lo, e_lo + E_loc)``,
    bucket per batch row, compute, scatter-add back (a partial output when
    the range is not every expert)."""
    B, S, D = x.shape
    K = cfg.top_k
    cap = _capacity(S, cfg)
    gates, experts = _route(x, router, K)
    flat_e = experts.reshape(B, S * K)
    pos = positions(flat_e)
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_loc)
    keep = (pos < cap) & local
    slot = torch.where(keep, (flat_e - e_lo) * cap + pos, E_loc * cap)
    return _double_scatter_rows(x, gates, slot, w_gate, w_up, w_down,
                                n_slots=E_loc * cap)


def _row_local_forward(p, x: torch.Tensor, cfg: ModelConfig,
                       positions) -> torch.Tensor:
    """The ``moe_local``/``moe_shmap`` body.  On plain tensors every expert
    is local.  On a mesh (DTensor has no strategy for the scatters) it runs
    shard by shard over the batch rows: expert-parallel where the rules
    split the experts over "model", each rank's partial output summed by one
    all-reduce over "model"; else every expert on each rank."""
    E = cfg.n_experts
    args = (x, p.router, p.w_gate, p.w_up, p.w_down)
    if not is_sharded(x):
        return _bucketed_expert_math(*args, cfg=cfg, e_lo=0, E_loc=E,
                                     positions=positions)
    r = current_rules()
    rows, router = ("batch", None, None), (None, None)
    if r.spec_for(("experts",), (E,)) == ("model",):
        E_loc = E // _axis_size(r, "model")
        fn = partial(_bucketed_expert_math, cfg=cfg, e_lo=axis_index("model") * E_loc,
                     E_loc=E_loc, positions=positions)
        experts = ("experts", None, None)
        return local_apply(fn, args, (rows, router, experts, experts, experts), (0,),
                           reduce_over="model")
    fn = partial(_bucketed_expert_math, cfg=cfg, e_lo=0, E_loc=E, positions=positions)
    whole = (None, None, None)
    return local_apply(fn, args, (rows, router, whole, whole, whole), (0,))


def moe_forward_local(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Row-local double-scatter dispatch (the ``moe_local`` variant): the
    capacity and the bucketing are per batch row."""
    return _row_local_forward(p, x, cfg, partial(_positions_by_cumsum, E=cfg.n_experts))


def moe_forward_shmap(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The ``moe_shmap`` variant: expert-parallel over "model" on a mesh, the
    reference's meshless path on one device."""
    return _row_local_forward(p, x, cfg, _positions_by_sort)
