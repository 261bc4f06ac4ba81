"""The torch port's flash attention against the reference package's.

The same numpy-seeded q, k and v go through
``repro.kernels.flash_attention.attention_ref`` and the port's
``attention_ref`` / ``flash_attention`` (a CPU tensor takes the plain
version).  Tolerance: max abs 2e-5 in float32, the bar of
``tests/test_kernel_flash_attention.py``.  One small case runs the Pallas
kernel in interpret mode (about a second); it is causal, so the reference's
padding of S does not enter its softmax.

The CUDA kernels are held against the plain version by the ``requires_cuda``
test in ``tests/test_torch_isolation.py``, which imports no JAX and so also
runs on a machine with a card; it skips without one.  Here, on the CPU, a
plain PyTorch emulation of the tensor-core kernel's arithmetic (tiled online
softmax, probabilities rounded to bf16 for P.V, l summed in float32) is held
against the reference's ``attention_ref`` within the derived bf16 bar of
``flash_error``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                  flash_error, flash_failures)
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


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "tc"),        # yi-9b, deepseek-7b, qwen2-vl, ...
    (torch.bfloat16, 120, "tc"),        # h2o-danube-3-4b
    (torch.bfloat16, 64, "tc"),         # musicgen
    (torch.bfloat16, 16, "tc"),         # the smoke configs
    (torch.bfloat16, 100, "f32"),       # D % 8 != 0: no TMA row stride
    (torch.bfloat16, 12, "f32"),
    (torch.float32, 128, "f32"),
    (torch.float32, 16, "f32"),
])
def test_route_by_dtype_and_head_dim(dtype, D, want):
    assert kernel.route(dtype, D) == want


def test_tensor_core_kernel_source_and_flags():
    src = kernel.SOURCES[0].read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "cudaGetDriverEntryPoint", "flash_attention_tc_launch",
                   "flash_attention_launch"):
        assert needle in src, needle
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert not any("fast_math" in f or "lcuda" in f for f in kernel.NVCC_FLAGS)
    assert "__expf" not in src and "exp2f" not in src
    assert set(kernel.launches) == {"flash_attention", "flash_attention_tc"}


def _emulate_tc(q, k, v, *, causal, window, block_q=128, block_k=128):
    """The tensor-core kernel's arithmetic in plain PyTorch, block by block:
    key tiles from the window's first to the diagonal; float32 scores of the
    bf16 operands, scaled, masked to -1e30; online softmax; the
    probabilities rounded to bf16 for P.V with l summed from the float32
    ones; acc / max(l, 1e-30) rounded to bf16."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    out = torch.empty((B, H, S, D))
    for q0 in range(0, S, block_q):
        rows = torch.arange(q0, min(q0 + block_q, S))
        k_begin = max(0, q0 - window + 1) if window else 0
        k_end = int(rows[-1]) + 1 if causal else S
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), D))
        for k0 in range(k_begin // block_k * block_k, k_end, block_k):
            cols = torch.arange(k0, min(k0 + block_k, S))
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2) * (1.0 / math.sqrt(D))
            ok = torch.ones((len(rows), len(cols)), dtype=torch.bool)
            if causal:
                ok &= cols[None] <= rows[:, None]
            if window:
                ok &= cols[None] > rows[:, None] - window
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new), torch.tensor(0.0))
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)
    return out.bfloat16()


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,block", [
    (1, 4, 4, 64, 16, True, None, 128),     # MHA, one tile
    (2, 4, 2, 37, 64, True, None, 16),      # GQA 2, ragged S, several tiles
    (1, 8, 1, 300, 128, True, None, 128),   # MQA, ragged last tile
    (2, 8, 2, 130, 120, True, 32, 32),      # window, head_dim 120
    (1, 4, 2, 100, 32, False, None, 32),    # not causal, ragged S
    (1, 4, 2, 77, 16, False, 20, 16),       # window without the causal mask
    (1, 16, 2, 256, 128, True, 64, 128),    # GQA 8, window 64
])
def test_bf16_probabilities_stay_within_the_derived_bar(B, H, Hkv, S, D, causal,
                                                         window, block):
    """bf16-representable q, k, v (numpy-seeded): the emulated kernel
    against the reference's float32 attention_ref within max abs 0.03,
    relative L2 4e-3 and 2^-8 (|want| + P|V|) + 2e-5 per element."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(7 * S + D, B, H, Hkv, S, D))
    got = _emulate_tc(q, k, v, causal=causal, window=window, block_q=block,
                      block_k=block)
    j = [jnp.asarray(x.float().numpy()) for x in (q, k, v)]
    want = np.array(jax_attention_ref(*j, causal=causal, window=window))
    pv = np.array(jax_attention_ref(j[0], j[1], jnp.abs(j[2]), causal=causal,
                                      window=window))
    err = flash_error(got, torch.from_numpy(want), torch.from_numpy(pv))
    assert not flash_failures(err, torch.bfloat16), err
    assert err["elem_ratio"] > 0.0


def test_flash_error_names_the_bars_missed():
    want = torch.tensor([[1.0, -2.0, 0.5]])
    pv = torch.tensor([[1.5, 2.0, 1.0]])
    exact = flash_error(want.bfloat16(), want, pv)
    assert not flash_failures(exact, torch.bfloat16)
    assert flash_failures(flash_error(want, want), torch.float32) == []
    # one element a bf16 step (2^-7 at 1.0) plus its share of P|V| off
    off = want + torch.tensor([[2.0 ** -7 + 2.0 ** -8 * 1.5, 0.0, 0.0]])
    bad = flash_failures(flash_error(off, want, pv), torch.bfloat16)
    assert len(bad) == 2 and "element" in bad[1] and "relative L2" in bad[0]
    assert "max abs" in flash_failures(flash_error(want + 0.05, want, pv),
                                       torch.bfloat16)[0]
