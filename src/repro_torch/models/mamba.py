"""Mamba (S6) selective-state-space mixer — used by the Jamba hybrid.

The reference's ``models/mamba.py``. Prefill cuts time into chunks of
``CHUNK`` = 64 steps and threads them in a Python loop carrying the state
``h``; inside a chunk the diagonal linear recurrence
``h_t = Ābar_t · h_{t-1} + Bbar_t x_t`` runs as a log-depth Hillis–Steele
scan of tensor ops (6 steps at 64), where the reference runs
``jax.lax.associative_scan``; so the ``(B, L, d_inner, d_state)``
discretised tensors never exist for the whole sequence. The state is
float32, as in the reference.

Decode keeps (conv window, ssm state) per layer and advances one token in
O(d_inner · d_state).

Activations are pinned with :func:`repro_torch.distributed.constrain` where
GSPMD partitions the reference's mixer: d_inner over "model" (the
parameters' "ffn" axis), the x projection's small output whole.  No-ops on
plain tensors; in the dry-run they keep the products and their gradients
split over "model" where DTensor would gather the in-projection's halves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import constrain
from .common import ModelConfig

__all__ = ["CHUNK", "Mamba", "mamba_decode", "mamba_forward",
           "mamba_init_state"]

CHUNK = 64
INNER = ("batch", "seq", "ffn")


class Mamba(nn.Module):
    """One layer's Mamba parameters (no computation of its own)."""

    def __init__(self, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias,
                 a_log, d_skip, out_proj):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("conv_w", conv_w),
                        ("conv_b", conv_b), ("x_proj", x_proj),
                        ("dt_proj", dt_proj), ("dt_bias", dt_bias),
                        ("a_log", a_log), ("d_skip", d_skip),
                        ("out_proj", out_proj)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def _ssm_params(p, x_c: torch.Tensor, cfg: ModelConfig):
    """Common projections: returns dt (B,L,Di), B/C (B,L,S), A (Di,S)."""
    dt_rank = p.dt_proj.shape[0]
    S = cfg.d_state
    xdb = constrain(x_c @ p.x_proj, ("batch", "seq", None))   # (B,L,dt_rank+2S)
    dt_r = xdb[..., :dt_rank]
    B_ssm = xdb[..., dt_rank:dt_rank + S].float()
    C_ssm = xdb[..., dt_rank + S:].float()
    dt = F.softplus(constrain(dt_r @ p.dt_proj, INNER).float() + p.dt_bias.float())
    A = -torch.exp(p.a_log.float())                           # (Di,S)
    return dt, B_ssm, C_ssm, A


def _conv_causal(p, x_in: torch.Tensor, carry: torch.Tensor | None = None):
    """Depthwise causal conv along L.  x_in (B,L,Di); carry (B,C-1,Di)."""
    C = p.conv_w.shape[0]
    if carry is None:
        carry = x_in.new_zeros((x_in.shape[0], C - 1, x_in.shape[2]))
    xp = torch.cat([carry, x_in], dim=1)                      # (B, L+C-1, Di)
    L = x_in.shape[1]
    out = sum(xp[:, i:i + L, :] * p.conv_w[i] for i in range(C))
    return out + p.conv_b, xp[:, -(C - 1):, :]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t · h_{t-1} + b_t`` along dim 1 (h_{-1} =
    0), log-depth: at stride d every element takes in the element d before
    it, ``(a', b') = (a_{t-d} · a_t, b_{t-d} · a_t + b_t)``."""
    d, n = 1, a.shape[1]
    while d < n:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D).  Full sequence (prefill)."""
    B, L, D = x.shape
    Di = cfg.ssm_expand * D
    xz = constrain(x @ p.in_proj, INNER)
    x_in, z = constrain(xz[..., :Di], INNER), constrain(xz[..., Di:], INNER)
    x_c, _ = _conv_causal(p, x_in)
    x_c = F.silu(x_c)
    dt, B_ssm, C_ssm, A = _ssm_params(p, x_c, cfg)

    xf = x_c.float()
    h = torch.zeros((B, Di, cfg.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, L, CHUNK):
        hi = min(lo + CHUNK, L)
        dtc, Bc, Cc = dt[:, lo:hi], B_ssm[:, lo:hi], C_ssm[:, lo:hi]
        Abar = torch.exp(dtc[..., None] * A)                  # (B,C,Di,S)
        Bx = (dtc * xf[:, lo:hi])[..., None] * Bc[:, :, None, :]
        # fold the carried state into the chunk's first step
        Bx = torch.cat([Bx[:, :1] + Abar[:, :1] * h[:, None], Bx[:, 1:]], 1)
        hs = _scan(Abar, Bx)
        ys.append(torch.einsum("bcds,bcs->bcd", hs, Cc))      # (B,C,Di)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + p.d_skip.float() * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.out_proj


def mamba_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: "torch.device | str") -> dict:
    Di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, Di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, Di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """x: (B, 1, D); advances one token.  Returns (out, new_state)."""
    B, _, D = x.shape
    Di = cfg.ssm_expand * D
    xz = constrain(x @ p.in_proj, INNER)
    x_in, z = constrain(xz[..., :Di], INNER), constrain(xz[..., Di:], INNER)
    x_c, new_conv = _conv_causal(p, x_in, state["conv"])
    x_c = F.silu(x_c)
    dt, B_ssm, C_ssm, A = _ssm_params(p, x_c, cfg)
    Abar = torch.exp(dt[:, 0, :, None] * A)                   # (B,Di,S)
    Bx = (dt[:, 0] * x_c[:, 0].float())[..., None] * B_ssm[:, 0, None, :]
    h = Abar * state["ssm"] + Bx
    y = torch.einsum("bds,bs->bd", h, C_ssm[:, 0])[:, None, :]  # (B,1,Di)
    y = y + p.d_skip.float() * x_c.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.out_proj, {"conv": new_conv, "ssm": h}
