"""h2o-danube-3-4b [dense] — 24L d3840 32H (GQA kv=8) d_ff=10240,
vocab 32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, head_dim=120, window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, window=32, dtype="float32",
)
