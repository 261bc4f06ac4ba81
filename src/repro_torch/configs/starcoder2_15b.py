"""starcoder2-15b [dense] — 40L d6144 48H (GQA kv=4) d_ff=24576,
vocab 49152; GQA + RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
    vocab_size=256, head_dim=16, dtype="float32",
)
