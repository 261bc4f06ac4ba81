"""deepseek-7b [dense] — 30L d4096 32H (kv=32: full MHA) d_ff=11008,
vocab 102400; llama-arch.  [arXiv:2401.02954; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400, head_dim=128,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16, dtype="float32",
)
