"""The dense decoder with grouped-query attention (Llama form: RMSNorm,
rotary embeddings, SwiGLU): its weights' layout, its work counts, and its
plain float32 reference.

:func:`layout` lists the blocks' leaves that ``bench/harness/weights.py``
draws. :func:`matrix_params`, :func:`active_matrix_params`,
:func:`vector_params`, :func:`kernel_calls` and :func:`decode_cache` count,
over the whole model, what ``bench/work/lm.py`` composes into whole
calls. :func:`hidden` runs prompts or decode continuations through every
layer, one layer at a time, and returns the final-normed hidden states;
:func:`logits` applies the output head. The decode form takes the cache's
first positions as given inputs (``prefix(layer) -> (k, v)``) and computes
the rest itself.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .common import causal_attention, exact_float32, linear, rmsnorm, rope, weight

BF16 = 2


def layout(m: dict) -> list[tuple]:
    """(path, shape, kind, init) of the blocks' leaves, each with a leading
    layer axis: the norms (ones), the attention and SwiGLU matrices (std
    ``1/sqrt(fan_in)``)."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    a, f = "blocks.pos0.attn.", "blocks.pos0.ffn."
    return [("blocks.pos0.norm_mixer", (L, D), "f32", 0.0),
            ("blocks.pos0.norm_ffn", (L, D), "f32", 0.0),
            (a + "wq", (L, D, H * Dh), "bf16", 1 / math.sqrt(D)),
            (a + "wk", (L, D, Hk * Dh), "bf16", 1 / math.sqrt(D)),
            (a + "wv", (L, D, Hk * Dh), "bf16", 1 / math.sqrt(D)),
            (a + "wo", (L, H * Dh, D), "bf16", 1 / math.sqrt(H * Dh)),
            (f + "w_gate", (L, D, F), "bf16", 1 / math.sqrt(D)),
            (f + "w_up", (L, D, F), "bf16", 1 / math.sqrt(D)),
            (f + "w_down", (L, F, D), "bf16", 1 / math.sqrt(F))]


def matrix_params(m: dict) -> int:
    """Weights of every layer's matrix products: q, k, v, o and SwiGLU."""
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return L * (2 * D * H * Dh + 2 * D * Hk * Dh + 3 * D * F)


def active_matrix_params(m: dict) -> int:
    """The matrix weights one token's products meet: all of them."""
    return matrix_params(m)


def vector_params(m: dict) -> int:
    """Every layer's vectors: the two norms."""
    return m["n_layers"] * 2 * m["d_model"]


def causal_pairs(S: int) -> int:
    """(query, key) pairs of a causal mask over S positions."""
    return S * (S + 1) // 2


def flash_call(m: dict, B: int, S: int) -> tuple[float, float]:
    """(operations, least bytes) of one causal attention call over bf16
    q (B, H, S, Dh) and k, v (B, Hkv, S, Dh): 2 Dh for q.k and 2 Dh for
    p.v per attended pair and head; q, k, v read and the output written
    once."""
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ops = 4 * B * H * Dh * causal_pairs(S)
    nbytes = BF16 * B * S * Dh * (2 * H + 2 * Hk)
    return float(ops), float(nbytes)


def kernel_calls(m: dict, B: int, S: int) -> dict[str, tuple[int, float, float]]:
    """The mixer's kernel calls in one prefill of B prompts of S tokens:
    name -> (calls, operations per call, least bytes per call)."""
    return {"flash_attention": (m["n_layers"], *flash_call(m, B, S))}


def decode_cache(m: dict, B: int, pos: int) -> tuple[float, float]:
    """(operations, least bytes) of every layer's attention over its cache
    in one decode step whose new token sits at ``pos``: q.k and p.v over
    positions 0..pos, and the keys and values there moved once (those
    before ``pos`` read, the new ones written)."""
    L, H, Hk, Dh = m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ops = L * 4 * B * H * Dh * (pos + 1)
    nbytes = L * 2 * B * Hk * Dh * BF16 * (pos + 1)
    return float(ops), float(nbytes)


def _layer(w: dict, i: int, precision: str) -> dict:
    blk = w["blocks"]["pos0"]
    out = {k: weight(t[i], precision) for k, t in blk["attn"].items()}
    out.update({k: weight(t[i], precision) for k, t in blk["ffn"].items()})
    out["norm_mixer"], out["norm_ffn"] = blk["norm_mixer"][i], blk["norm_ffn"][i]
    return out


def hidden(w: dict, m: dict, tokens: torch.Tensor, *, precision: str = "f32",
           pos0: int = 0,
           prefix: Callable[[int], tuple[torch.Tensor, torch.Tensor]] | None = None,
           last_only: bool = False) -> torch.Tensor:
    """tokens (n, S) at positions ``pos0 .. pos0 + S - 1`` -> final-normed
    hidden states (n, S, D), or (n, D) of the last position with
    ``last_only``. ``prefix(layer)`` gives the keys and values at positions
    0 .. pos0 - 1, (n, Hk, pos0, Dh) each; None when ``pos0`` is 0."""
    H, Hk, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    n, S = tokens.shape
    pos = torch.arange(pos0, pos0 + S, device=tokens.device)
    with exact_float32():
        h = w["embed"][tokens].float()
        for i in range(m["n_layers"]):
            p = _layer(w, i, precision)
            x = rmsnorm(h, p["norm_mixer"], eps)
            q = rope(linear(x, p["wq"], precision).view(n, S, H, Dh), pos, theta)
            k = rope(linear(x, p["wk"], precision).view(n, S, Hk, Dh), pos, theta)
            v = linear(x, p["wv"], precision).view(n, S, Hk, Dh)
            if pos0:
                pk, pv = prefix(i)
                k = torch.cat([pk.float().transpose(1, 2), k], dim=1)
                v = torch.cat([pv.float().transpose(1, 2), v], dim=1)
            o = causal_attention(q, k, v, pos0).reshape(n, S, H * Dh)
            h = h + linear(o, p["wo"], precision)
            x = rmsnorm(h, p["norm_ffn"], eps)
            a = F.silu(linear(x, p["w_gate"], precision)) * linear(x, p["w_up"], precision)
            h = h + linear(a, p["w_down"], precision)
            del p
        if last_only:
            h = h[:, -1]
        return rmsnorm(h, w["final_norm"], eps)


def logits(w: dict, h: torch.Tensor, *, precision: str = "f32") -> torch.Tensor:
    """Final-normed hidden states (..., D) -> float32 logits (..., V)."""
    with exact_float32():
        return linear(h, weight(w["lm_head"], precision), precision)
