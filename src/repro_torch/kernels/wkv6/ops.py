"""Public op: the RWKV-6 wkv recurrence, routed by the device of its inputs.

A CUDA tensor launches the hand-written kernel (:mod:`.kernel`); a CPU
tensor takes the plain chunked version (:mod:`.ref`).  Nothing falls back: a
kernel that fails to build or launch raises.  Inputs are cast to float32, as
the reference's op does.  Nothing is padded in device memory: the kernel
masks a ragged last chunk itself.  Both routes take the same shapes and
chunk sizes (:func:`.kernel.check_shapes`).
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import wkv_chunked_ref


def wkv6(r, k, v, w, u, s0, *, chunk: int = 32):
    """r, k, v, w (B, L, H, N); u (H, N); s0 (B, H, N, N) ->
    (y (B, L, H, N), s_final (B, H, N, N)), both float32."""
    devs = {x.device for x in (r, k, v, w, u, s0)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices {sorted(map(str, devs))}")
    kernel.check_shapes(r, k, v, w, u, s0, chunk)
    args = tuple(x.float().contiguous() for x in (r, k, v, w, u, s0))
    dev = r.device.type
    if dev == "cuda":
        return kernel.wkv6_cuda(*args, chunk=chunk)
    if dev == "cpu":
        return wkv_chunked_ref(*args, chunk=chunk)
    raise ValueError(f"wkv6 runs on CUDA or CPU tensors, not {dev}")
