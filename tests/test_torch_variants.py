"""The bf16 perf-iteration variants, ``attn_bf16`` and ``rwkv_bf16``, against
the reference's.

Inputs are made with numpy from a seed and fed to both packages on the CPU.
Bars: the plain attention path on bf16 inputs at relative L2 1e-2 (with
bf16 scores two bf16 softmaxes whose sums round at other places; with
float32 scores the same float32 result rounded to a bf16 output), on
float32 inputs at 1e-5; the bf16 wkv forms at relative L2 2e-3 against the reference's
``wkv_chunked(compute_dtype=bfloat16)`` (they round at the same points, and
products of bf16 values are exact in float32, so only the order of the
float32 sums differs: measured about 1e-5 for the chunked form and 1e-4 for
the kernel's two-phase form, whose rounding of att meets other sums).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import VARIANTS as JAX_VARIANTS
from repro.models.attention import _dense_attention as jax_dense_attention
from repro.models.rwkv import wkv_chunked as jax_wkv_chunked
from repro_torch import configs
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.kernels.wkv6.ops import Wkv6Fn
from repro_torch.kernels.wkv6.ref import wkv_chunked_ref, wkv_two_phase_ref
from repro_torch.models.attention import _dense_attention

ATTN_BF16_REL_L2 = 1e-2
ATTN_F32_REL_L2 = 1e-5
WKV_BF16_REL_L2 = 2e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_variants_apply():
    for name in ("attn_bf16", "rwkv_bf16"):
        assert configs.VARIANTS[name] == JAX_VARIANTS[name]
    cfg = configs.apply_variants(configs.get_config("rwkv6-1.6b"), ["attn_bf16", "rwkv_bf16"])
    assert (cfg.attn_f32, cfg.rwkv_bf16) == (False, True)


def _qkv(seed, B, H, Hk, S, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, S, D), (B, Hk, S, D), (B, Hk, S, D)))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("f32_scores", [False, True])
def test_dense_attention_matches_reference(f32_scores, window):
    """bf16 inputs; scores and softmax in bf16 (the variant) or float32."""
    q, k, v = _qkv(3, 2, 4, 2, 37, 16)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jax_dense_attention(jq, jk, jv, causal=True, window=window, f32_scores=f32_scores)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _dense_attention(tq, tk, tv, causal=True, window=window, f32_scores=f32_scores)
    assert got.dtype == torch.bfloat16
    rel = _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    print(f"f32_scores={f32_scores} window={window}: relative L2 {rel:.3e}")
    assert rel <= ATTN_BF16_REL_L2, rel


def test_dense_attention_float32_matches_reference():
    q, k, v = _qkv(4, 1, 6, 3, 29, 8)
    want = jax_dense_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=None,
                               f32_scores=True)
    got = _dense_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=None,
                           f32_scores=True)
    assert _rel(got.numpy(), np.asarray(want)) <= ATTN_F32_REL_L2


def _wkv_inputs(seed, B, L, H, N, scale=2.0, s0=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, L, H, N)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(scale * rng.standard_normal((B, L, H, N)))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    st = (0.2 * rng.standard_normal((B, H, N, N)) if s0 else np.zeros((B, H, N, N)))
    return r, k, v, w, u, st.astype(np.float32)


WKV_CASES = [  # (B, L, H, N, chunk, scale, s0)
    (2, 77, 3, 16, 32, 2.0, True),     # ragged, state carried in
    (1, 64, 2, 64, 32, 2.0, False),    # model-sized head, no s0
    (1, 50, 2, 24, 16, 3.5, True),     # near-zero decays, chunk 16
    (2, 130, 2, 32, 64, 2.0, True),    # chunk 64, ragged
    (3, 1, 2, 64, 32, 2.0, True),      # one token: a decode step
]


@pytest.mark.parametrize("B,L,H,N,chunk,scale,s0", WKV_CASES)
def test_bf16_wkv_matches_reference(B, L, H, N, chunk, scale, s0):
    a = _wkv_inputs(B * 100 + L, B, L, H, N, scale, s0)
    yj, sj = jax_wkv_chunked(*(jnp.asarray(x) for x in a), chunk=chunk,
                             compute_dtype=jnp.bfloat16)
    t = tuple(torch.from_numpy(x) for x in a)
    y, s = wkv_chunked_ref(*t, chunk=chunk, compute_dtype=torch.bfloat16)
    assert _rel(y.numpy(), yj) <= WKV_BF16_REL_L2
    assert _rel(s.numpy(), sj) <= WKV_BF16_REL_L2
    # the op's CPU route is the plain version, bit for bit
    yo, so = wkv6(*t, chunk=chunk, compute_dtype=torch.bfloat16)
    assert torch.equal(yo, y) and torch.equal(so, s)
    # the rounding is real: the float32 form differs by more than the bar's
    # tenth
    yf, _ = wkv_chunked_ref(*t, chunk=chunk)
    assert _rel(y.numpy(), yf.numpy()) > WKV_BF16_REL_L2 / 10
    if chunk % 16 == 0:
        y2, s2 = wkv_two_phase_ref(*t, chunk=chunk, compute_dtype=torch.bfloat16)
        assert _rel(y2.numpy(), yj) <= WKV_BF16_REL_L2
        assert _rel(s2.numpy(), sj) <= WKV_BF16_REL_L2


def test_compute_dtype_is_checked():
    t = tuple(torch.from_numpy(x) for x in _wkv_inputs(0, 1, 8, 1, 8))
    with pytest.raises(ValueError, match="compute_dtype"):
        wkv6(*t, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        wkv_chunked_ref(*t, compute_dtype=torch.float64)


@pytest.mark.parametrize("need", ["rkvwus", "w"])
def test_bf16_wrapper_backward_is_the_plain_gradient(monkeypatch, need):
    """Wkv6Fn in the bf16 mode differentiates the bf16 plain version (its
    CUDA launch replaced by that plain version): bit for bit."""
    monkeypatch.setattr(wk, "wkv6_cuda", wkv_chunked_ref)
    a = tuple(torch.from_numpy(x) for x in _wkv_inputs(7, 2, 45, 2, 8))
    gen = torch.Generator().manual_seed(1)
    cy, cs = torch.randn((2, 45, 2, 8), generator=gen), torch.randn((2, 2, 8, 8), generator=gen)
    grads = []
    for fn in (lambda *x: Wkv6Fn.apply(*x, 16, torch.bfloat16),
               lambda *x: wkv_chunked_ref(*x, chunk=16, compute_dtype=torch.bfloat16)):
        ins = [x.clone().requires_grad_(n in need) for x, n in zip(a, "rkvwus")]
        y, s = fn(*ins)
        ((y * cy).sum() + (s * cs).sum()).backward()
        grads.append([x.grad for x in ins])
    for n, got, want in zip("rkvwus", *grads):
        assert (got is None) == (n not in need)
        assert got is None or torch.equal(got, want)


def test_rwkv_bf16_decode_rounds_too():
    """The reference's decode runs the same bf16 function on one token, so
    the port's decode step in the variant differs from the float32 one."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg = configs.get_smoke_config("rwkv6-1.6b")
    bf = dataclasses.replace(cfg, rwkv_bf16=True)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                                        (2, 1)))}
    outs = []
    for c in (cfg, bf):
        model = T.DecoderLM(c, init_params(c, seed=0, device="cpu"))
        cache = T.init_cache(c, 2, 8, device="cpu")
        with torch.inference_mode():
            T.decode_step(model, c, cache, toks, 0)
            outs.append(T.decode_step(model, c, cache, toks, 1)[0].float())
    assert not torch.equal(outs[0], outs[1])
    assert _rel(outs[1].numpy(), outs[0].numpy()) <= 5e-2
