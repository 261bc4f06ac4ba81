"""Plain PyTorch decode attention: one query position a head against a
key/value cache, float32 scores and softmax over the slots that hold a
token.  The CPU and ``meta`` path of :func:`.ops.decode_attention`, the core
of ``attn_decode``'s sharded branches (the dry-run), and the version the
CUDA kernel is held against on the card.  It follows the reference's
``attn_decode`` (``repro/models/attention.py``): every slot is read, and
those past the valid ones score -1e30, which weighs them exactly 0."""

from __future__ import annotations

import math

import torch

__all__ = ["decode_attention_ref", "summation_bar", "valid_mask"]


def valid_mask(S_ctx: int, n_valid: int, device) -> torch.Tensor:
    """(S_ctx,) bool: the first ``n_valid`` slots hold a token (a ring
    buffer's too: its last writes)."""
    return torch.arange(S_ctx, device=device) < n_valid


def decode_attention_ref(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, *,
                         valid: torch.Tensor) -> torch.Tensor:
    """One query position against a cache: float32 scores over the key
    positions where ``valid``, softmax, the weighted values (float32).
    q (..., G, Dh) against keys and values (..., S_ctx, Dh)."""
    s = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    s = s / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = s.masked_fill(~valid, -1e30)
    return torch.matmul(torch.softmax(s, dim=-1), values.float())


def summation_bar(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, n_valid: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """How far two float32 computations of the same decode attention may
    lie apart by the order of their sums alone, elementwise (float64, q's
    shape), over the first ``n_valid`` slots:

        2^-8 |want|                               (bf16 output only)
        + (P ds) |V| + (P . ds) P|V|              (the scores' sums)
        + (n_valid + 8) 2^-22 P|V|                (the outputs' sums)

    with ds = Dh 2^-22 (|q| |k|^T) / sqrt(Dh) a score's bound and P the
    exact probabilities: each sum of m float32 terms is within m 2^-24 of
    the sum of their magnitudes, taken twice (two computations) and twice
    again (the tensor cores' float32 accumulation truncates).  The card's
    kernel is held to it against :func:`decode_attention_ref` (the tests,
    ``chip_smoke.py``)."""
    D = q.shape[-1]
    qd, kd, vd = (t.double() for t in (q, keys[..., :n_valid, :], values[..., :n_valid, :]))
    s = qd @ kd.transpose(-1, -2) / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    ds = D * 2.0 ** -22 * (qd.abs() @ kd.abs().transpose(-1, -2)) / math.sqrt(D)
    pv = p @ vd.abs()
    bar = (p * ds) @ vd.abs() + (p * ds).sum(-1, keepdim=True) * pv
    bar = bar + (n_valid + 8) * 2.0 ** -22 * pv
    if out_dtype == torch.bfloat16:
        bar = bar + 2.0 ** -8 * (p @ vd).abs()
    return bar + 1e-30
