"""Plain PyTorch version: dense causal GQA attention with an optional
sliding window.  The CPU path of :func:`.ops.flash_attention` and the
version the CUDA kernel is held against on the card."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Dense reference attention.

    q: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0.  ``window``:
    sliding-window size w — query i attends keys in (i-w, i] (Mistral and
    h2o-danube convention).  Returns (B, H, S, D) in q's dtype; scores and
    softmax are float32, masked scores ``-inf``.  The (S, S) score tensor is
    updated in place to hold one copy of it.
    """
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.matmul(q.float(), kr.transpose(-1, -2))
    s /= torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s.masked_fill_(~mask, float("-inf"))
    s -= s.amax(dim=-1, keepdim=True)
    s.exp_()
    s /= s.sum(dim=-1, keepdim=True)
    return torch.matmul(s, vr).to(q.dtype)
