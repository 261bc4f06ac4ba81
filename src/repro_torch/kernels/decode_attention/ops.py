"""Public op: decode attention, routed by the device of its inputs.

A CUDA tensor launches the hand-written kernel (:mod:`.kernel`), which
reads the ``n_valid`` slots that hold a token and nothing past them; a CPU
or ``meta`` tensor takes the plain version (:mod:`.ref`), which reads all
``S_ctx`` slots and masks the rest.  Nothing falls back: a kernel that fails
to build or launch, or inputs it does not take, raise.  The route counts
what it reads into the innermost open span (:func:`..runtime.spans.count`).
Serving needs no gradient, so there is no autograd wrapper.
"""

from __future__ import annotations

import torch

from ...runtime.spans import count
from . import kernel
from .ref import decode_attention_ref, valid_mask


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int) -> torch.Tensor:
    """q (B, Hk, G, Dh), the G query heads of each kv head; k and v (B, Hk,
    S_ctx, Dh), a layer's cache, slots 0 .. n_valid - 1 holding a token ->
    (B, Hk, G, Dh) in q's dtype.  Counts ``kv_valid`` (``n_valid``) and
    ``kv_read``, the slots the route reads a (row, kv head): ``n_valid`` on
    the card, ``S_ctx`` on the plain version."""
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices {sorted(map(str, devs))}")
    if q.device.type == "cuda":
        out = kernel.decode_attention_cuda(q.contiguous(), k, v, n_valid)
        count(kv_read=n_valid, kv_valid=n_valid)
        return out
    if q.device.type in ("cpu", "meta"):
        S_ctx = k.shape[2]
        count(kv_read=S_ctx, kv_valid=n_valid)
        return decode_attention_ref(q, k, v, valid=valid_mask(S_ctx, n_valid, q.device)
                                    ).to(q.dtype)
    raise ValueError(f"decode_attention runs on CUDA, CPU or meta tensors, not "
                     f"{q.device.type}")
