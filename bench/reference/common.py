"""Pieces shared by the references: the precision switch, linear layers in
float32 or fp8, RMSNorm, rotary embeddings, causal attention in blocks.

``precision="f32"`` is the reference. ``precision="fp8"`` is the control:
the same arithmetic with the input of every matrix product rounded to
float8 e4m3, the weights per output column and the activations per row,
each with its own scale, products summed in float32.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
PRECISIONS = ("f32", "fp8")


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``'s
    complement (the amax over ``dim`` maps to 448), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A (in, out) weight in float32, or fp8-rounded per output column."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}, expected one of {PRECISIONS}")
    w = w.float()
    return fp8_round(w, 0) if precision == "fp8" else w


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., in) @ w (in, out), ``w`` already through :func:`weight`."""
    if precision == "fp8":
        x = fp8_round(x, -1)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding: x (n, S, H, Dh), pos (S,) absolute."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                          device=x.device) / Dh))
    ang = pos.float()[:, None] * freqs                     # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, rows: int = 512) -> torch.Tensor:
    """Grouped-query causal attention, float32, ``rows`` queries at a time.
    q (n, S, H, Dh) at absolute positions ``q_offset + i``; k, v
    (n, T, Hk, Dh) at positions ``j``; query i sees keys j <= q_offset + i.
    Returns (n, S, H, Dh)."""
    n, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    kh = k.permute(0, 2, 3, 1)                             # (n, Hk, Dh, T)
    vh = v.permute(0, 2, 1, 3)                             # (n, Hk, T, Dh)
    kpos = torch.arange(T, device=q.device)
    out = torch.empty_like(q)
    for a in range(0, S, rows):
        b = min(a + rows, S)
        qb = q[:, a:b].reshape(n, b - a, Hk, g, Dh).permute(0, 2, 3, 1, 4)
        s = torch.matmul(qb, kh[:, :, None]) / Dh ** 0.5   # (n, Hk, g, rows, T)
        qpos = torch.arange(a, b, device=q.device) + q_offset
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vh[:, :, None])                # (n, Hk, g, rows, Dh)
        out[:, a:b] = o.permute(0, 3, 1, 2, 4).reshape(n, b - a, H, Dh)
    return out
