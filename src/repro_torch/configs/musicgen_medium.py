"""musicgen-medium [audio] — 48L d1536 24H (kv=24) d_ff=6144, vocab 2048
per codebook (4 codebooks); decoder-only over EnCodec tokens.  The EnCodec
frontend is a STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64,
    frontend="audio", n_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=64, head_dim=16, frontend="audio", n_codebooks=4,
    dtype="float32",
)
