"""RWKV-6 ("Finch") attention-free mixer with data-dependent decay.

The reference's ``models/rwkv.py``, layer for layer: the token shift, the
time mix (r, k, v, gate and the decay ``w_t = exp(-exp(x_t @ ww + bias))``
into the wkv recurrence, per-head normalisation, gate, output projection),
the channel mix (``relu(xk @ w_k)^2 @ w_v``) and the decode state.

The wkv recurrence runs through :func:`repro_torch.kernels.wkv6.wkv6`, as the
reference's op does on its own accelerator: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain chunked version, in
float32.  ``wkv_chunked`` and ``wkv_recurrent_ref`` are re-exported from the
kernel package under the reference's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.wkv6 import wkv6
from ..kernels.wkv6.ref import CHUNK
from ..kernels.wkv6.ref import wkv_chunked_ref as wkv_chunked
from ..kernels.wkv6.ref import wkv_recurrent_ref
from .common import ModelConfig

__all__ = ["CHUNK", "ChannelMix", "TimeMix", "rwkv_channel_mix", "rwkv_init_state",
           "rwkv_time_mix", "wkv_chunked", "wkv_recurrent_ref"]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class TimeMix(nn.Module):
    """One layer's time-mix parameters (no computation of its own)."""

    def __init__(self, mix_r, mix_k, mix_v, mix_w, wr, wk, wv, ww, w_bias,
                 u_bonus, wo, g_proj):
        super().__init__()
        for name, t in (("mix_r", mix_r), ("mix_k", mix_k), ("mix_v", mix_v),
                        ("mix_w", mix_w), ("wr", wr), ("wk", wk), ("wv", wv),
                        ("ww", ww), ("w_bias", w_bias), ("u_bonus", u_bonus),
                        ("wo", wo), ("g_proj", g_proj)):
            setattr(self, name, _param(t))


class ChannelMix(nn.Module):
    """One layer's channel-mix parameters (no computation of its own)."""

    def __init__(self, mix_k, w_k, w_v):
        super().__init__()
        self.mix_k = _param(mix_k)
        self.w_k = _param(w_k)
        self.w_v = _param(w_v)


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried ``last``, for t = 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """x: (B, L, D).  state: {"shift": (B, D), "wkv": (B, H, N, N)} or None.
    Returns (out (B, L, D), {"shift": x[:, -1], "wkv": s_final})."""
    B, L, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    xp = _shift(x, None if state is None else state["shift"])
    dx = xp - x
    xr = x + p.mix_r * dx
    xk = x + p.mix_k * dx
    xv = x + p.mix_v * dx
    xw = x + p.mix_w * dx
    r = (xr @ p.wr).reshape(B, L, H, N)
    k = (xk @ p.wk).reshape(B, L, H, N)
    v = (xv @ p.wv).reshape(B, L, H, N)
    g = F.silu(xr @ p.g_proj)
    # Finch: data-dependent decay
    wl = (xw @ p.ww).float() + p.w_bias.float()
    w = torch.exp(-torch.exp(wl)).reshape(B, L, H, N)
    u = p.u_bonus.float().reshape(H, N)
    s0 = (torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
          if state is None else state["wkv"])
    y, s_fin = wkv6(r.float(), k.float(), v.float(), w, u, s0, chunk=cfg.rwkv_chunk)
    # per-head normalisation (GroupNorm(H) stand-in), then the gate
    y = y / torch.clamp(torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True)), min=1e-6)
    y = y.reshape(B, L, D).to(x.dtype) * g
    return y @ p.wo, {"shift": x[:, -1, :], "wkv": s_fin}


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """x: (B, L, D) -> (out, {"shift": x[:, -1]})."""
    xp = _shift(x, None if state is None else state["shift"])
    xk = x + p.mix_k * (xp - x)
    k = torch.square(torch.relu(xk @ p.w_k))
    return k @ p.w_v, {"shift": x[:, -1, :]}


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device: torch.device) -> dict:
    """Zero decode state of one layer: token shifts in the model dtype, the
    wkv state in float32."""
    D = cfg.d_model
    N = cfg.rwkv_head_dim
    H = D // N
    return {
        "att": {"shift": torch.zeros((batch, D), dtype=dtype, device=device),
                "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32, device=device)},
        "cmix": {"shift": torch.zeros((batch, D), dtype=dtype, device=device)},
    }
