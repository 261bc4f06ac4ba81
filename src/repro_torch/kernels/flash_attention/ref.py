"""Plain PyTorch version: dense causal GQA attention with an optional
sliding window.  The CPU path of :func:`.ops.flash_attention` and the
version the CUDA kernels are held against on the card, with the bars of
:func:`flash_error`."""

from __future__ import annotations

import math

import torch

#: bars against the plain version's float32 result: the max abs error (the
#: bars of the reference's kernel test) and the relative L2 error of a call
MAX_ABS = {torch.float32: 2e-5, torch.bfloat16: 0.03}
REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
#: the bf16 unit roundoff: rounding to bf16 moves x by at most 2^-8 |x|
BF16_U = 2.0 ** -8
ELEM_ABS = 2e-5


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Dense reference attention.

    q: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0.  ``window``:
    sliding-window size w — query i attends keys in (i-w, i] (Mistral and
    h2o-danube convention).  Returns (B, H, S, D) in q's dtype; scores and
    softmax are float32, masked scores ``-inf``.  The (S, S) score tensor is
    updated in place to hold one copy of it, unless an input needs a
    gradient: then the same steps run out of place, so that autograd keeps
    what each step's backward reads.
    """
    B, H, S, D = q.shape
    group = H // k.shape[1]
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.matmul(q.float(), kr.transpose(-1, -2))
    scale = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        s = (s / scale).masked_fill(~mask, float("-inf"))
        s = (s - s.amax(dim=-1, keepdim=True)).exp()
        s = s / s.sum(dim=-1, keepdim=True)
    else:
        s /= scale
        s.masked_fill_(~mask, float("-inf"))
        s -= s.amax(dim=-1, keepdim=True)
        s.exp_()
        s /= s.sum(dim=-1, keepdim=True)
    return torch.matmul(s, vr).to(q.dtype)


def flash_error(got: torch.Tensor, want: torch.Tensor,
                pv: torch.Tensor | None = None) -> dict:
    """A kernel's output ``got`` against ``want``, the plain version in
    float32 on the same inputs (``attention_ref(q.float(), k.float(),
    v.float())``).

    For bf16, ``pv`` is P|V| (``attention_ref(q.float(), k.float(),
    v.float().abs())``) and every element is held to

        |got - want| <= 2^-8 |want| + 2^-8 (P|V|) + 2e-5:

    the output's rounding to bf16 moves it by at most 2^-8 |o|, and rounding
    each probability p_j to bf16 for the P.V product, with l summed from the
    float32 p_j, by at most 2^-8 sum_j p_j |v_j|.  Returns ``max_abs_err``,
    ``rel_l2``, ``elem_ratio`` (the worst element's error over its bar; nan
    in float32) and ``diff_sq`` / ``want_sq``, the sums of squares behind
    ``rel_l2``; :func:`flash_failures` names the bars missed.
    """
    diff = (got.float() - want).abs()
    diff_sq = float(diff.square().sum())
    want_sq = float(want.square().sum())
    ratio = float("nan")
    if pv is not None:
        ratio = float((diff / (BF16_U * (want.abs() + pv) + ELEM_ABS)).max())
    return {"max_abs_err": float(diff.max()),
            "rel_l2": math.sqrt(diff_sq / want_sq) if want_sq else 0.0,
            "elem_ratio": ratio, "diff_sq": diff_sq, "want_sq": want_sq}


def flash_failures(err: dict, dtype: torch.dtype) -> list[str]:
    """The bars of :func:`flash_error`'s result ``err`` that a ``dtype``
    output misses: max abs, relative L2 and, for bf16, the per-element bar
    (which needs P|V|)."""
    bad = []
    if not err["max_abs_err"] < MAX_ABS[dtype]:
        bad.append(f"max abs error {err['max_abs_err']} >= {MAX_ABS[dtype]}")
    if not err["rel_l2"] <= REL_L2[dtype]:
        bad.append(f"relative L2 error {err['rel_l2']} > {REL_L2[dtype]}")
    if dtype == torch.bfloat16 and not err["elem_ratio"] <= 1.0:
        bad.append(f"an element off by {err['elem_ratio']} x its bar "
                   "2^-8 (|want| + P|V|) + 2e-5")
    return bad
