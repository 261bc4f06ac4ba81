"""The torch port's flash attention against the reference package's.

The same numpy-seeded q, k and v go through
``repro.kernels.flash_attention.attention_ref`` and the port's
``attention_ref`` / ``flash_attention`` (a CPU tensor takes the plain
version).  Tolerance: max abs 2e-5 in float32, the bar of
``tests/test_kernel_flash_attention.py``.  One small case runs the Pallas
kernel in interpret mode (about a second); it is causal, so the reference's
padding of S does not enter its softmax.

The CUDA kernel is held against the plain version by the ``requires_cuda``
test in ``tests/test_torch_isolation.py``, which imports no JAX and so also
runs on a machine with a card; it skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel

ATOL = 2e-5
BF16_ATOL = 0.03


def _qkv(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))


CASES = [
    # B, H, Hkv, S, D, causal, window
    (1, 2, 2, 64, 16, True, None),      # MHA
    (2, 4, 2, 37, 16, True, None),      # GQA group 2, ragged S
    (1, 8, 1, 100, 64, True, None),     # MQA
    (1, 8, 1, 1, 128, True, None),      # one token
    (2, 4, 2, 130, 120, True, 32),      # window, head_dim 120
    (1, 4, 4, 100, 32, False, None),    # not causal, ragged S
    (1, 4, 2, 77, 16, False, 20),       # window without the causal mask
]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", CASES)
def test_attention_ref_matches_reference(B, H, Hkv, S, D, causal, window):
    q, k, v = _qkv(S + D, B, H, Hkv, S, D)
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    assert np.abs(got.numpy() - want).max() < ATOL


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", CASES[:3] + CASES[4:5])
def test_cpu_op_is_the_plain_version(B, H, Hkv, S, D, causal, window):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, B, H, Hkv, S, D))
    # non-contiguous inputs, as attn_forward hands them over
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal, window=window),
                               rtol=0, atol=0)


def test_bf16_keeps_dtype_and_accumulates_in_f32():
    q, k, v = _qkv(2, 1, 2, 1, 128, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = attention_ref(tq, tk, tv)
    want = np.asarray(jax_attention_ref(*(jnp.asarray(x.float().numpy())
                                          for x in (tq, tk, tv))))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - want).max() < BF16_ATOL


def test_pallas_interpret_agrees_with_port():
    """The TPU kernel itself (interpret mode) against the port's plain version."""
    q, k, v = _qkv(3, 1, 2, 1, 128, 16)
    out = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, window=32, block_q=64,
                                            block_k=64, interpret=True))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=32)
    assert np.abs(got.numpy() - out).max() < ATOL


def test_op_rejects_bad_arguments():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 1, 8, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_cuda(q, k, v)
