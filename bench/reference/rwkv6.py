"""The RWKV-6 ("Finch") decoder as the configuration file states it: its
weights' layout, its work counts, and its plain float32 reference.

The layer: token shift with static mixes, the data-dependent decay
``w = exp(-exp(x_w @ ww + bias))``, the wkv recurrence with bonus ``u``,
per-head RMS normalisation, the SiLU gate, and the squared-ReLU channel
mix. The decay bias and the bonus take RWKV-6's published initialisation
(``time_decay`` and ``time_faaaa`` in RWKV-LM's ``RWKV_Tmix_x060``,
arXiv:2404.05892): the bias runs from -6 to -1 over the channels, so the
first channels keep their state across thousands of tokens and the state
carried from chunk to chunk shapes the last position's output.

The reference recurrence runs chunk by chunk in its exact closed form:
within a chunk each pairwise decay is the product of the decays between two
tokens, taken as the exponential of a difference of float64 prefix sums of
``log w = -exp(x_w @ ww + bias)`` (so no sum of large logs cancels in
float32); the state is carried in float32 from chunk to chunk.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import exact_float32, linear, rmsnorm, weight

F32 = 4
CHUNK = 32


def _layer_ratio(leaf: torch.Tensor) -> torch.Tensor:
    """layer / (layers - 1) for each row of a (layers, D) leaf, float64."""
    L = leaf.shape[0]
    return torch.arange(L, dtype=torch.float64, device=leaf.device) / max(L - 1, 1)


def _channel(leaf: torch.Tensor) -> torch.Tensor:
    """channel / (D - 1) for each column of a (layers, D) leaf, float64."""
    D = leaf.shape[1]
    return torch.arange(D, dtype=torch.float64, device=leaf.device) / max(D - 1, 1)


def time_decay(leaf: torch.Tensor) -> None:
    """RWKV-6's decay bias: -6 + 5 (n / (D-1)) ^ (0.7 + 1.3 layer / (L-1))."""
    n, ratio = _channel(leaf), _layer_ratio(leaf)
    leaf.copy_(-6.0 + 5.0 * n[None, :] ** (0.7 + 1.3 * ratio[:, None]))


def time_bonus(leaf: torch.Tensor) -> None:
    """RWKV-6's bonus u: layer / (L-1) (1 - n / (D-1)) + 0.1 ((n + 1) % 3 - 1)."""
    n, ratio = _channel(leaf), _layer_ratio(leaf)
    zigzag = 0.1 * ((torch.arange(leaf.shape[1], device=leaf.device) + 1) % 3 - 1)
    leaf.copy_(ratio[:, None] * (1.0 - n[None, :]) + zigzag[None, :])


def layout(m: dict) -> list[tuple]:
    """(path, shape, kind, init) of the blocks' leaves, each with a leading
    layer axis: the norms (ones), the static mixes (std 0.01), the time-mix
    and channel-mix matrices (std ``1/sqrt(fan_in)``), the decay bias and
    the bonus (RWKV-6's initialisation)."""
    L, D, F_ = m["n_layers"], m["d_model"], m["d_ff"]
    p, c = "blocks.pos0.rwkv.", "blocks.pos0.cmix."
    return [("blocks.pos0.norm_mixer", (L, D), "f32", 0.0),
            ("blocks.pos0.norm_ffn", (L, D), "f32", 0.0),
            *[(p + n, (L, D), "bf16", 0.01) for n in ("mix_r", "mix_k", "mix_v", "mix_w")],
            *[(p + n, (L, D, D), "bf16", 1 / math.sqrt(D)) for n in ("wr", "wk", "wv", "ww")],
            (p + "w_bias", (L, D), "f32", time_decay),
            (p + "u_bonus", (L, D), "f32", time_bonus),
            (p + "wo", (L, D, D), "bf16", 1 / math.sqrt(D)),
            (p + "g_proj", (L, D, D), "bf16", 1 / math.sqrt(D)),
            (c + "mix_k", (L, D), "bf16", 0.01),
            (c + "w_k", (L, D, F_), "bf16", 1 / math.sqrt(D)),
            (c + "w_v", (L, F_, D), "bf16", 1 / math.sqrt(F_))]


def matrix_params(m: dict) -> int:
    """Weights of every layer's matrix products: r, k, v, w, gate, out and
    the channel mix."""
    L, D, F_ = m["n_layers"], m["d_model"], m["d_ff"]
    return L * (6 * D * D + 2 * D * F_)


def active_matrix_params(m: dict) -> int:
    """The matrix weights one token's products meet: all of them."""
    return matrix_params(m)


def vector_params(m: dict) -> int:
    """Every layer's vectors: two norms, five mixes, decay bias and bonus."""
    return m["n_layers"] * 9 * m["d_model"]


def wkv6_call(m: dict, B: int, S: int, chunk: int = CHUNK) -> tuple[float, float]:
    """(float32 operations, least bytes) of one wkv6 call over r, k, v, w
    (B, S, H, N), u (H, N) and s0 (B, H, N, N), all float32. Operations of
    the chunked form per chunk of R tokens and head: the two state
    contractions (2 R N^2 each), 7 per pairwise decay term over the
    R (R - 1) / 2 pairs, 8 per token and channel. Bytes: the inputs read
    and y and the final state written once."""
    N = m["rwkv_head_dim"]
    H = m["d_model"] // N

    def per_chunk(R: int) -> int:
        return 4 * R * N * N + 7 * (R * (R - 1) // 2) * N + 8 * R * N

    full, rem = divmod(S, chunk)
    ops = B * H * (full * per_chunk(chunk) + (per_chunk(rem) if rem else 0))
    nbytes = F32 * (5 * B * S * H * N + H * N + 2 * B * H * N * N)
    return float(ops), float(nbytes)


def kernel_calls(m: dict, B: int, S: int) -> dict[str, tuple[int, float, float]]:
    """The mixer's kernel calls in one prefill of B prompts of S tokens:
    name -> (calls, operations per call, least bytes per call)."""
    return {"wkv6": (m["n_layers"], *wkv6_call(m, B, S))}


def _shift(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """r, k, v (n, S, H, N) float32, logw (n, S, H, N) float64 (<= 0),
    u (H, N) -> y (n, S, H, N) float32, from a zero state:
    ``y_t = r_t . (S_t + u * k_t v_t^T)``, ``S_{t+1} = w_t * S_t + k_t v_t^T``
    (the decay acting on the key index)."""
    n, S, H, N = r.shape
    state = torch.zeros((n, H, N, N), dtype=torch.float32, device=r.device)
    y = torch.empty_like(r)
    for a in range(0, S, chunk):
        b = min(a + chunk, S)
        C = b - a
        rc, kc, vc = (t[:, a:b].transpose(1, 2) for t in (r, k, v))   # (n, H, C, N)
        lw = logw[:, a:b].transpose(1, 2)
        incl = torch.cumsum(lw, dim=2)                                  # sum_{m<=t}
        excl = incl - lw                                                # sum_{m<t}
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), -1)
        # decay from token s (exclusive) to token t (exclusive), s < t
        diff = excl[:, :, :, None, :] - incl[:, :, None, :, :]          # (n,H,C,C,N)
        dec = torch.where(tri[:, :, None], torch.exp(diff.clamp(max=0.0)), 0.0).float()
        att = torch.einsum("nhtc,nhsc,nhtsc->nhts", rc, kc, dec)
        yc = torch.matmul(att, vc)
        yc += torch.matmul(rc * torch.exp(excl).float(), state)
        yc += torch.sum(rc * u[None, :, None, :] * kc, dim=-1, keepdim=True) * vc
        y[:, a:b] = yc.transpose(1, 2)
        total = incl[:, :, -1:, :]                                      # (n,H,1,N)
        kd = kc * torch.exp(total - incl).float()
        state = state * torch.exp(total[:, :, 0, :, None]).float() + \
            torch.matmul(kd.transpose(-1, -2), vc)
    return y


def _layer(w: dict, i: int, precision: str) -> dict:
    blk = w["blocks"]["pos0"]
    out = {}
    for group in ("rwkv", "cmix"):
        for name, t in blk[group].items():
            key = f"{group}.{name}"
            out[key] = weight(t[i], precision) if t.dim() == 3 else t[i].float()
    out["norm_mixer"], out["norm_ffn"] = blk["norm_mixer"][i], blk["norm_ffn"][i]
    return out


def hidden(w: dict, m: dict, tokens: torch.Tensor, *, precision: str = "f32",
           last_only: bool = False) -> torch.Tensor:
    """tokens (n, S) from an empty state -> final-normed hidden states
    (n, S, D), or (n, D) of the last position with ``last_only``."""
    D, N, eps = m["d_model"], m["rwkv_head_dim"], m["norm_eps"]
    H = D // N
    n, S = tokens.shape
    with exact_float32():
        h = w["embed"][tokens].float()
        for i in range(m["n_layers"]):
            p = _layer(w, i, precision)
            x = rmsnorm(h, p["norm_mixer"], eps)
            dx = _shift(x) - x
            xr, xk = x + p["rwkv.mix_r"] * dx, x + p["rwkv.mix_k"] * dx
            xv, xw = x + p["rwkv.mix_v"] * dx, x + p["rwkv.mix_w"] * dx
            r = linear(xr, p["rwkv.wr"], precision).view(n, S, H, N)
            k = linear(xk, p["rwkv.wk"], precision).view(n, S, H, N)
            v = linear(xv, p["rwkv.wv"], precision).view(n, S, H, N)
            g = F.silu(linear(xr, p["rwkv.g_proj"], precision))
            wl = linear(xw, p["rwkv.ww"], precision) + p["rwkv.w_bias"]
            logw = -torch.exp(wl.double()).view(n, S, H, N)
            y = wkv(r, k, v, logw, p["rwkv.u_bonus"].view(H, N))
            y = y / torch.clamp(torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True)), min=1e-6)
            h = h + linear(y.reshape(n, S, D) * g, p["rwkv.wo"], precision)
            x = rmsnorm(h, p["norm_ffn"], eps)
            xk = x + p["cmix.mix_k"] * (_shift(x) - x)
            kk = torch.square(torch.relu(linear(xk, p["cmix.w_k"], precision)))
            h = h + linear(kk, p["cmix.w_v"], precision)
            del p
        if last_only:
            h = h[:, -1]
        return rmsnorm(h, w["final_norm"], eps)


def logits(w: dict, h: torch.Tensor, *, precision: str = "f32") -> torch.Tensor:
    """Final-normed hidden states (..., D) -> float32 logits (..., V)."""
    with exact_float32():
        return linear(h, weight(w["lm_head"], precision), precision)
