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
* ``"shmap"`` — the reference's expert-parallel form. On one device it is
  the reference's meshless path, :func:`_bucketed_expert_math` over every
  expert; on the dry-run's mesh each rank runs every expert on its batch
  rows, as ``"local"`` does (no expert parallelism).

Activation shardings are pinned with ``constrain(...)`` at the reference's
three sites of the global form (the dispatched buffer, the expert outputs,
the combined output): a no-op on plain tensors, a redistribution of
``DTensor``s in the dry-run. The expert products are plain
batched matmuls and the scatters ``index_add_``/``scatter_add_``, as the
reference computes them outside any Pallas kernel.  DTensor has no
strategy for those scatters, so on a mesh they run through
:func:`~repro_torch.distributed.local_apply`: the global form's dispatch on
replicated tokens, the double scatter on each rank's batch rows.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import constrain, local_apply
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


def _swiglu_experts(he: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """``he (..., E, C, D)`` through each expert's SwiGLU -> ``(..., E, C, D)``."""
    g = torch.einsum("...ecd,edf->...ecf", he, w_gate)
    u = torch.einsum("...ecd,edf->...ecf", he, w_up)
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * u, w_down)


def _dispatch(xt: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              n_slots: int) -> torch.Tensor:
    """The kept token copies of ``xt (N, D)`` summed into ``n_slots`` rows
    (``K = slot.numel() // N`` copies a token, in token-major order)."""
    K = slot.shape[0] // xt.shape[0]
    src = torch.repeat_interleave(xt, K, dim=0)               # (N*K, D)
    src = torch.where(keep[:, None], src, 0)
    buf = torch.zeros((n_slots, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, src)
    return buf


def moe_forward_global(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); ``p`` has ``router``, ``w_gate``, ``w_up``
    and ``w_down`` (:class:`MoE`)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xt = x.reshape(N, D)
    gates, experts = _route(xt, p.router, K)                  # (N, K)
    capacity = _capacity(N, cfg)

    # position of token-slot (n, k) within its expert = number of earlier
    # slots routed to the same expert (exclusive one-hot cumsum)
    flat_expert = experts.reshape(-1)                          # (N*K,)
    onehot = F.one_hot(flat_expert, E)                         # (N*K, E)
    pos_in_expert = torch.cumsum(onehot, 0) - onehot
    pos = torch.gather(pos_in_expert, 1, flat_expert[:, None])[:, 0]
    keep = pos < capacity
    slot = flat_expert * capacity + torch.where(keep, pos, 0)

    # dispatch into a dense (E*capacity, D) buffer; a dropped copy adds 0.
    # The slots index every token, so under DTensor the scatter runs on
    # replicated tokens, one rank's whole buffer (DTensor has no strategy
    # for index_add_); the expert constraint below then keeps each rank's
    # experts, a local slice
    buf = local_apply(partial(_dispatch, n_slots=E * capacity),
                      (xt, slot, keep), ((None, None), (None,), (None,)), (0,))
    he = constrain(buf.reshape(E, capacity, D), ("experts", None, "act_embed"))
    out_e = constrain(_swiglu_experts(he, p.w_gate, p.w_up, p.w_down),
                      ("experts", None, "act_embed"))

    # combine: gather the slots back, weight by the gates, sum over k
    tok_out = out_e.reshape(E * capacity, D)[slot]             # (N*K, D)
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None].to(tok_out.dtype)
    return constrain((tok_out * w).reshape(N, K, D).sum(1).reshape(B, S, D),
                     ("batch", "seq", "act_embed"))


def _double_scatter(x: torch.Tensor, gates: torch.Tensor, slot: torch.Tensor,
                    n_slots: int, w_gate, w_up, w_down) -> torch.Tensor:
    """Per batch row: scatter the kept token copies into ``n_slots`` expert
    slots (index ``n_slots`` is the sink of dropped copies), run the experts
    and scatter-add their gated outputs back to the token positions.  Under
    DTensor it runs shard by shard over the batch rows, every expert on each
    rank (DTensor has no strategy for these scatters)."""
    rows, weight = ("batch", None, None), (None, None, None)
    return local_apply(partial(_double_scatter_rows, n_slots=n_slots),
                       (x, gates, slot, w_gate, w_up, w_down),
                       (rows, rows, ("batch", None), weight, weight, weight),
                       (0,))


def _double_scatter_rows(x, gates, slot, w_gate, w_up, w_down, *,
                         n_slots: int) -> torch.Tensor:
    B, S, D = x.shape
    K = slot.shape[1] // S
    E_loc = w_gate.shape[0]
    dev = x.device
    idx = slot[..., None].expand(B, S * K, D)
    src = torch.repeat_interleave(x, K, dim=1)                 # (B, S*K, D)
    buf = torch.zeros((B, n_slots + 1, D), dtype=x.dtype, device=dev)
    buf.scatter_add_(1, idx, src)
    out_e = _swiglu_experts(buf[:, :n_slots].reshape(B, E_loc, -1, D),
                            w_gate, w_up, w_down)

    tok_idx = (torch.arange(S * K, device=dev) // K).expand(B, S * K)
    w_slot = torch.zeros((B, n_slots + 1), dtype=gates.dtype, device=dev)
    w_slot.scatter_add_(1, slot, gates.reshape(B, S * K))
    tos = torch.full((B, n_slots + 1), S, dtype=torch.int64, device=dev)
    tos.scatter_(1, slot, tok_idx)
    contrib = (out_e.reshape(B, n_slots, D)
               * w_slot[:, :n_slots, None].to(x.dtype))
    out = torch.zeros((B, S + 1, D), dtype=x.dtype, device=dev)
    out.scatter_add_(1, tos[:, :n_slots, None].expand(B, n_slots, D), contrib)
    return out[:, :S]


def moe_forward_local(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Row-local double-scatter dispatch (the ``moe_local`` variant): the
    capacity and the bucketing are per batch row."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = _capacity(S, cfg)
    gates, experts = _route(x, p.router, K)                   # (B, S, K)
    flat_e = experts.reshape(B, S * K)
    onehot = F.one_hot(flat_e, E)                              # (B, S*K, E)
    pos_in_e = torch.cumsum(onehot, 1) - onehot                # exclusive, per row
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, E * cap)      # E*cap = dropped
    return _double_scatter(x, gates, slot, E * cap, p.w_gate, p.w_up,
                           p.w_down)


def _positions_by_sort(flat_e: torch.Tensor) -> torch.Tensor:
    """Position of each token copy within its expert's arrival order, equal
    to the exclusive one-hot cumsum without its ``(B, S·K, E)`` tensor: a
    stable sort groups copies by expert, a position is the distance to its
    segment's start, scattered back to arrival order."""
    B, SK = flat_e.shape
    se, order = torch.sort(flat_e, dim=1, stable=True)
    idx = torch.arange(SK, device=flat_e.device).expand(B, SK)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return torch.zeros_like(flat_e).scatter_(1, order, idx - seg_start)


def _bucketed_expert_math(x: torch.Tensor, router, w_gate, w_up, w_down,
                          cfg: ModelConfig, e_lo: int, E_loc: int):
    """Route over ALL experts, keep the local range ``[e_lo, e_lo + E_loc)``,
    bucket per batch row, compute, scatter-add back (a partial output when
    the range is not every expert)."""
    B, S, D = x.shape
    K = cfg.top_k
    cap = _capacity(S, cfg)
    gates, experts = _route(x, router, K)
    flat_e = experts.reshape(B, S * K)
    pos = _positions_by_sort(flat_e)
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_loc)
    keep = (pos < cap) & local
    slot = torch.where(keep, (flat_e - e_lo) * cap + pos, E_loc * cap)
    return _double_scatter(x, gates, slot, E_loc * cap, w_gate, w_up, w_down)


def moe_forward_shmap(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The ``moe_shmap`` variant on one device: every expert is local, so
    this is the reference's meshless path."""
    return _bucketed_expert_math(x, p.router, p.w_gate, p.w_up, p.w_down,
                                 cfg, 0, cfg.n_experts)
