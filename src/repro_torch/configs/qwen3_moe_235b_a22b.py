"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) d_ff=1536/expert,
vocab 151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8, capacity_factor=1.25, moe_every=1,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16, n_experts=4, top_k=2, moe_every=1,
    dtype="float32",
)
