"""Public op: flash attention, routed by the device of its inputs.

A CUDA tensor launches the hand-written kernel (:mod:`.kernel`); a CPU
tensor takes the plain version (:mod:`.ref`), which autograd differentiates
directly.  Nothing falls back: a kernel that fails to build or launch
raises.  The sequence is not padded: the kernel masks keys past S itself.

On the card, inputs that need a gradient go through
:class:`FlashAttentionFn`, whose forward is the kernel and whose backward
recomputes the plain version and differentiates it.  The reference has no
backward kernel either: its gradient is autodiff of its plain path.
Inputs that need no gradient (serving) call the kernel directly.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA kernel forward with a recomputed plain backward.

    The backward holds the plain version's (B, H, S, S) float32 scores and
    what autograd keeps of them (the masked scores, their exponentials and
    the probabilities) for one call at a time: each is 2.1 GB at B = 4,
    H = 32, S = 2048, one layer of yi-9b's training step.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*ins, causal=ctx.causal, window=ctx.window)
            got = iter(torch.autograd.grad(out, [x for x in ins if x.requires_grad],
                                           grad))
        return (*(next(got) if n else None for n in need), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Tiled attention: q (B,H,S,D), k/v (B,Hkv,S,D) -> (B,H,S,D) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices {sorted(map(str, devs))}")
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                     f"{q.device.type}")
