"""qwen2-vl-72b [vlm] — 80L d8192 64H (GQA kv=8) d_ff=29568, vocab 152064;
M-RoPE (temporal/height/width sections), dynamic resolution.  The vision
frontend is a STUB: input_specs() provides token ids + precomputed M-RoPE
position ids.  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, head_dim=128,
    mrope_sections=(16, 24, 24),
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, mrope_sections=(2, 3, 3),
    dtype="float32",
)
