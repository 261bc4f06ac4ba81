"""Public op: flash attention, routed by the device of its inputs.

A CUDA tensor launches the hand-written kernel (:mod:`.kernel`); a CPU
tensor takes the plain version (:mod:`.ref`).  Nothing falls back: a kernel
that fails to build or launch raises.  The sequence is not padded: the
kernel masks keys past S itself.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Tiled attention: q (B,H,S,D), k/v (B,Hkv,S,D) -> (B,H,S,D) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices {sorted(map(str, devs))}")
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=causal,
                                           window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                     f"{q.device.type}")
