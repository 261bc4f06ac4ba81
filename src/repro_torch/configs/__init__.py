"""Configurations of the torch port: the paper's Sect. 5 workflow
(:mod:`.paper_workflow`) and the language-model architectures.

``--arch <id>`` resolution for the launchers goes through
:func:`get_config` / :func:`get_smoke_config`.  The shape table mirrors the
reference's: every architecture pairs with the four LM shapes; ``long_500k``
only applies to sub-quadratic architectures.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

from repro_torch.models.common import ModelConfig

ARCHS: dict[str, str] = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-9b": "yi_9b",
    "deepseek-7b": "deepseek_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)


#: perf-iteration variants.  Names map to config overrides; the baseline
#: (no variant) stays the reference configuration.
VARIANTS: dict[str, dict] = {
    "moe_local": {"moe_impl": "local"},           # row-local double-scatter
    "moe_shmap": {"moe_impl": "shmap"},           # explicit expert-parallel combine
    "attn_bf16": {"attn_f32": False},             # bf16 attention scores/softmax
    "rwkv_bf16": {"rwkv_bf16": True},             # bf16 intra-mixer math (f32 state kept)
    "no_remat": {"remat": False},                 # trade memory for recompute
    "rwkv_chunk16": {"rwkv_chunk": 16},           # halve intra-chunk W traffic
    "rwkv_chunk64": {"rwkv_chunk": 64},
}


#: variants the port does not honour, with the reason: its flash kernel and
#: the kernel's plain version compute scores and softmax in f32 whatever
#: ``attn_f32`` says, and its wkv6 kernel is float32 only, like the TPU's.
UNSUPPORTED_VARIANTS = {
    "attn_bf16": "attention always computes in f32",
    "rwkv_bf16": "the wkv recurrence always computes in f32 (the bf16 "
                 "intra-chunk form is not ported yet)",
}


def apply_variants(cfg: ModelConfig, names: list[str]) -> ModelConfig:
    overrides: dict = {}
    for n in names:
        if not n:
            continue
        if n not in VARIANTS:
            raise KeyError(f"unknown variant {n!r}; choose from {sorted(VARIANTS)}")
        if n in UNSUPPORTED_VARIANTS:
            raise ValueError(f"variant {n!r} has no effect in this package: "
                             f"{UNSUPPORTED_VARIANTS[n]}")
        overrides.update(VARIANTS[n])
    return dataclasses.replace(cfg, **overrides)


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Can this arch run the 512k-context decode shape?"""
    return cfg.window is not None or cfg.ssm is not None or cfg.attn_every > 0


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if is_subquadratic(cfg):
        out.append("long_500k")
    return out
