"""Public op: the RWKV-6 wkv recurrence, routed by the device of its inputs.

A CUDA tensor launches the hand-written kernel (:mod:`.kernel`); a CPU
tensor takes the plain chunked version (:mod:`.ref`), which autograd
differentiates directly.  Nothing falls back: a kernel that fails to build
or launch raises.  Inputs are cast to float32, as the reference's op does.
Nothing is padded in device memory: the kernel masks a ragged last chunk
itself.  Both routes take the same shapes and chunk sizes
(:func:`.kernel.check_shapes`).

On the card, inputs that need a gradient go through :class:`Wkv6Fn`, whose
forward is the kernel and whose backward recomputes the plain chunked
version and differentiates it, as the reference differentiates its XLA
``wkv_chunked``.  Inputs that need no gradient (serving) call the kernel
directly.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import wkv_chunked_ref


class Wkv6Fn(torch.autograd.Function):
    """The CUDA kernel forward with a recomputed plain backward: the
    backward holds the plain version's per-chunk tensors, the largest
    (B, chunk, chunk, H, N) float32 decays, for one call at a time."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk: int):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        return kernel.wkv6_cuda(r, k, v, w, u, s0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
            out = wkv_chunked_ref(*ins, chunk=ctx.chunk)
            got = iter(torch.autograd.grad(out, [x for x in ins if x.requires_grad],
                                           (gy, gs)))
        return (*(next(got) if n else None for n in need), None)


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
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            return Wkv6Fn.apply(*args, chunk)
        return kernel.wkv6_cuda(*args, chunk=chunk)
    if dev == "cpu":
        return wkv_chunked_ref(*args, chunk=chunk)
    raise ValueError(f"wkv6 runs on CUDA or CPU tensors, not {dev}")
