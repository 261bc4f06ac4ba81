"""jamba-v0.1-52b [hybrid] — 32L d4096 32H (GQA kv=8) d_ff=14336,
vocab 65536; Mamba+attention 1:7 interleave (1 attention layer per 8),
MoE 16 experts top-2 on every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, ssm="mamba", d_state=16, d_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    n_experts=4, top_k=2, moe_every=2,
    attn_every=8, ssm="mamba", d_state=8, d_conv=4, ssm_expand=2,
    dtype="float32",
)
