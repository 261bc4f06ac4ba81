"""kimi-k2-1t-a32b [moe] — 61L d7168 64H (GQA kv=8) d_ff=2048/expert,
vocab 163840, MoE 384 experts top-8.  [arXiv:2501.kimi2; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=128,
    n_experts=384, top_k=8, capacity_factor=1.25, moe_every=1,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=256, head_dim=16, n_experts=8, top_k=2, moe_every=1,
    dtype="float32",
)
