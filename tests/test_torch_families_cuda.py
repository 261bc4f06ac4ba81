"""deepseek-7b, h2o-danube-3-4b, starcoder2-15b, musicgen-medium and
qwen2-vl-72b on the card: each smoke config's prefill against the same
model on the CPU.

The smoke configs are float32, so the card's attention is the float32
flash kernel: MHA (deepseek, musicgen at head_dim 16), h2o-danube's window
of 32 at S = 48, starcoder2's group of 3, qwen2-vl's M-RoPE on image
positions; musicgen takes frame embeddings and gives 4 codebooks' logits.
Logits at rtol/atol 1e-4 with TF32 off.  Every test needs a card
(``-m requires_cuda``) and skips without one.  This file imports no JAX:
the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params

from mrope_image_positions import mrope_positions

FAMILIES = ["deepseek-7b", "h2o-danube-3-4b", "starcoder2-15b", "musicgen-medium",
            "qwen2-vl-72b"]
B, S = 2, 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _batch(cfg):
    rng = np.random.default_rng(1)
    if cfg.frontend == "audio":
        emb = 0.1 * rng.standard_normal((B, S, cfg.d_model))
        batch = {"embeddings": torch.tensor(emb, dtype=torch.float32)}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.mrope_sections is not None:
        batch["positions"] = mrope_positions(B, S, 8, (4, 6))
    return batch


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_prefill_on_the_card_matches_cpu(cuda, arch):
    from repro_torch.kernels.flash_attention import kernel as fa

    cfg = configs.get_smoke_config(arch)
    if cfg.window is not None:
        assert cfg.window < S, "the window must bite"
    tree = init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    with torch.inference_mode():
        want = T.prefill(T.DecoderLM(cfg, tree), cfg, batch)
        fa.reset_launches()
        got = T.prefill(T.DecoderLM(cfg, _to(tree, cuda)), cfg, _to(batch, cuda))
        torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == cfg.n_layers
    shape = (B, cfg.n_codebooks, cfg.vocab_size) if cfg.frontend == "audio" else (B, cfg.vocab_size)
    assert tuple(got.shape) == shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
