"""Shared model machinery: config, parameter specs, norms, RoPE.

Parameters are declared through :class:`Spec` leaves carrying their logical
axis names, in the reference package's layout: the blocks of a scanned
group are stacked on a leading ``layers`` axis of length ``n_groups``.
:func:`init_params` materialises that tree as tensors on the target device;
:class:`repro_torch.models.transformer.DecoderLM` unstacks it into one
module per layer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1               # every Nth layer uses MoE FFN (jamba: 2)
    # attention
    window: int | None = None        # sliding-window attention (h2o-danube)
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    # hybrid / ssm
    attn_every: int = 0              # jamba: 1 attention layer per this many (0 = all attn)
    ssm: str | None = None           # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # modality stub
    frontend: str | None = None      # "audio" (musicgen) | "vision" (qwen2-vl)
    n_codebooks: int = 1             # musicgen: 4
    # numerics / structure
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # perf-iteration levers (defaults = the reference baseline)
    moe_impl: str = "global"           # global | local (double-scatter) | shmap
    attn_f32: bool = True              # kept for parity; attention is always f32
    rwkv_bf16: bool = False            # bf16 intra-mixer math in rwkv6
    rwkv_chunk: int = 32               # wkv chunk length

    # ---- derived -----------------------------------------------------------
    @property
    def period(self) -> int:
        """Layers per scanned group (heterogeneous block period)."""
        p = 1
        if self.attn_every:
            p = self.attn_every
        if self.n_experts and self.moe_every > 1:
            p = max(p, self.moe_every)
        return p

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not split "
                             f"into groups of {self.period}")
        return self.n_layers // self.period

    def layer_kind(self, pos: int) -> dict[str, Any]:
        """Mixer/FFN kinds for period position ``pos``."""
        if self.ssm == "rwkv6":
            mixer = "rwkv6"
        elif self.attn_every and (pos % self.attn_every) != self.attn_every // 2:
            mixer = "mamba"
        else:
            mixer = "attn"
        if self.n_experts and (pos % self.moe_every) == self.moe_every - 1:
            ffn = "moe"
        elif self.ssm == "rwkv6":
            ffn = "rwkv_cmix"
        else:
            ffn = "dense"
        return {"mixer": mixer, "ffn": ffn}

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        return sum(math.prod(s.shape) for s in param_specs(self).values())

    def active_params(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        total = self.n_params()
        if not self.n_experts:
            return total
        expert_total = sum(math.prod(s.shape) for s in param_specs(self).values()
                           if "experts" in s.axes)
        return total - expert_total + int(expert_total * self.top_k / self.n_experts)


@dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"     # normal | zeros | ones | small
    dtype: str | None = None  # override model dtype (e.g. f32 for norms)


# ==========================================================================
# Parameter spec tree
# ==========================================================================

def _lead(g: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """g = leading group count (stacked scan layers); 0 = unstacked."""
    return ((g,), ("layers",)) if g else ((), ())


def _attn_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, la = _lead(g)
    return {
        "wq": Spec(lead + (D, H * Dh), la + ("embed", "heads")),
        "wk": Spec(lead + (D, Hk * Dh), la + ("embed", "kv")),
        "wv": Spec(lead + (D, Hk * Dh), la + ("embed", "kv")),
        "wo": Spec(lead + (H * Dh, D), la + ("heads", "embed")),
    }


def _dense_ffn_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D, F = cfg.d_model, cfg.d_ff
    lead, la = _lead(g)
    return {
        "w_gate": Spec(lead + (D, F), la + ("embed", "ffn")),
        "w_up": Spec(lead + (D, F), la + ("embed", "ffn")),
        "w_down": Spec(lead + (F, D), la + ("ffn", "embed")),
    }


def _moe_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead, la = _lead(g)
    return {
        "router": Spec(lead + (D, E), la + ("embed", None)),
        "w_gate": Spec(lead + (E, D, F), la + ("experts", "embed", "ffn")),
        "w_up": Spec(lead + (E, D, F), la + ("experts", "embed", "ffn")),
        "w_down": Spec(lead + (E, F, D), la + ("experts", "ffn", "embed")),
    }


def _mamba_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    S, C = cfg.d_state, cfg.d_conv
    lead, la = _lead(g)
    dt_rank = max(D // 16, 1)
    return {
        "in_proj": Spec(lead + (D, 2 * Di), la + ("embed", "ffn")),
        "conv_w": Spec(lead + (C, Di), la + (None, "ffn")),
        "conv_b": Spec(lead + (Di,), la + ("ffn",), init="zeros"),
        "x_proj": Spec(lead + (Di, dt_rank + 2 * S), la + ("ffn", None)),
        "dt_proj": Spec(lead + (dt_rank, Di), la + (None, "ffn")),
        "dt_bias": Spec(lead + (Di,), la + ("ffn",), init="small"),
        "a_log": Spec(lead + (Di, S), la + ("ffn", None), init="small", dtype="float32"),
        "d_skip": Spec(lead + (Di,), la + ("ffn",), init="ones", dtype="float32"),
        "out_proj": Spec(lead + (Di, D), la + ("ffn", "embed")),
    }


def _rwkv_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D = cfg.d_model
    lead, la = _lead(g)
    return {
        "mix_r": Spec(lead + (D,), la + ("embed",), init="small"),
        "mix_k": Spec(lead + (D,), la + ("embed",), init="small"),
        "mix_v": Spec(lead + (D,), la + ("embed",), init="small"),
        "mix_w": Spec(lead + (D,), la + ("embed",), init="small"),
        "wr": Spec(lead + (D, D), la + ("embed", "heads")),
        "wk": Spec(lead + (D, D), la + ("embed", "heads")),
        "wv": Spec(lead + (D, D), la + ("embed", "heads")),
        "ww": Spec(lead + (D, D), la + ("embed", "heads")),  # data-dependent decay proj
        "w_bias": Spec(lead + (D,), la + ("heads",), init="small", dtype="float32"),
        "u_bonus": Spec(lead + (D,), la + ("heads",), init="small", dtype="float32"),
        "wo": Spec(lead + (D, D), la + ("heads", "embed")),
        "g_proj": Spec(lead + (D, D), la + ("embed", "heads")),
    }


def _rwkv_cmix_specs(cfg: ModelConfig, g: int) -> dict[str, Spec]:
    D, F = cfg.d_model, cfg.d_ff
    lead, la = _lead(g)
    return {
        "mix_k": Spec(lead + (D,), la + ("embed",), init="small"),
        "w_k": Spec(lead + (D, F), la + ("embed", "ffn")),
        "w_v": Spec(lead + (F, D), la + ("ffn", "embed")),
    }


def block_specs(cfg: ModelConfig) -> dict[str, dict[str, Spec]]:
    """Specs for one scanned group: per period position, mixer + ffn + norms."""
    g = cfg.n_groups if cfg.scan_layers else 0
    lead, la = _lead(g)
    out: dict[str, dict[str, Spec]] = {}
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)
        sub: dict[str, Any] = {
            "norm_mixer": Spec(lead + (cfg.d_model,), la + ("embed",), init="ones", dtype="float32"),
            "norm_ffn": Spec(lead + (cfg.d_model,), la + ("embed",), init="ones", dtype="float32"),
        }
        if kind["mixer"] == "attn":
            sub["attn"] = _attn_specs(cfg, g)
        elif kind["mixer"] == "mamba":
            sub["mamba"] = _mamba_specs(cfg, g)
        elif kind["mixer"] == "rwkv6":
            sub["rwkv"] = _rwkv_specs(cfg, g)
        if kind["ffn"] == "dense":
            sub["ffn"] = _dense_ffn_specs(cfg, g)
        elif kind["ffn"] == "moe":
            sub["moe"] = _moe_specs(cfg, g)
        elif kind["ffn"] == "rwkv_cmix":
            sub["cmix"] = _rwkv_cmix_specs(cfg, g)
        out[f"pos{pos}"] = sub
    return out


def param_specs(cfg: ModelConfig) -> dict[str, Spec]:
    """Flat ``{'a.b.c': Spec}`` for the whole model."""
    specs: dict[str, Spec] = {}

    def rec(prefix: str, tree):
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Spec):
                specs[path] = v
            else:
                rec(path, v)

    top: dict[str, Any] = {}
    if cfg.frontend == "audio":
        # stub frontend: frame embeddings arrive precomputed; per-codebook
        # output heads remain
        top["heads_out"] = Spec((cfg.n_codebooks, cfg.d_model, cfg.vocab_size),
                                (None, "embed", "vocab"))
    else:
        top["embed"] = Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
        if not cfg.tie_embeddings:
            top["lm_head"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    top["final_norm"] = Spec((cfg.d_model,), ("embed",), init="ones", dtype="float32")
    top["blocks"] = block_specs(cfg)
    rec("", top)
    return specs


def unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    """``{'a.b': x}`` -> ``{'a': {'b': x}}``."""
    tree: dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _init_leaf(gen: torch.Generator, spec: Spec, cfg: ModelConfig,
               device: torch.device) -> torch.Tensor:
    dt = torch.float32 if spec.dtype == "float32" else cfg.torch_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "small":
        std = 0.01
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dt, device=device)
    # drawn in float32 one leading slice at a time, so a stacked bf16 leaf
    # needs no float32 copy of its whole size
    for sl in out.view(-1, *spec.shape[-2:]) if len(spec.shape) > 2 else (out,):
        sl.copy_(std * torch.randn(sl.shape, generator=gen, dtype=torch.float32,
                                   device=device))
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: "str | torch.device | None" = None) -> dict:
    """Random parameters in the reference layout, as a nested dict of tensors.

    The reference's rules (``std = 1/sqrt(fan_in)``, ``small`` = 0.01,
    zeros, ones; float32 for norms and the SSM leaves that ask for it), drawn
    from one ``torch.Generator`` seeded with ``seed`` on the target device,
    so every leaf is made on the card and never passes through host memory.
    The numbers differ from the reference's ``jax.random`` draws; parity
    tests carry the reference's parameters across instead
    (:mod:`repro_torch.models.convert`).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = {p: _init_leaf(gen, s, cfg, dev) for p, s in param_specs(cfg).items()}
    return unflatten(flat)


# ==========================================================================
# numerics helpers
# ==========================================================================

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int -> rotated x."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (Dh/2,)
    ang = positions[..., None].float() * freqs                # (..., S, Dh/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (3, ..., S); head-dim halves split into
    ``sections`` (temporal/height/width) each rotated by its own stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    sel = torch.tensor([i for i, s in enumerate(sections) for _ in range(s)],
                       device=x.device)
    pos = positions3.index_select(0, sel)                     # (half, ..., S)
    ang = torch.movedim(pos, 0, -1).float() * freqs           # (..., S, half)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32; labels == ignore_id are masked."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(torch.sum(mask), min=1.0)
