"""The port's decode attention (``repro_torch.kernels.decode_attention``).

On the CPU: the op returns the plain version's answer bit for bit (the
arithmetic ``attn_decode`` ran before the kernel, written out here),
``attn_decode`` is unchanged bit for bit, the wrapper's checks refuse what
the kernel does not take, and the split plan covers the valid positions
with whole tiles.

On the card (``requires_cuda``; skips without one): the kernel against the
plain version on the same inputs, every slot past ``n_valid`` filled with
NaN for the kernel and zeroed for the plain version.  The kernel never
reads those slots, so its output stays finite.  The bar is float32
summation noise, to first order, for both versions (``summation_bar`` in
``kernels/decode_attention/ref.py``).  This file imports no
JAX: the card's machine has none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.decode_attention import (decode_attention, decode_attention_ref,
                                                   summation_bar, valid_mask)
from repro_torch.kernels.decode_attention import kernel
from repro_torch.models import attention as A
from repro_torch.models.common import init_params
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime import spans


def _old_core(q, keys, values, *, valid):
    """``attn_decode``'s core before the kernel, as it stood."""
    s = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    s = s / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = s.masked_fill(~valid, -1e30)
    return torch.matmul(torch.softmax(s, dim=-1), values.float())


def _qkv(seed, B, Hk, G, S, D, dtype, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
                 .to(dtype).to(device)
                 for shape in ((B, Hk, G, D), (B, Hk, S, D), (B, Hk, S, D)))


# ---------------------------------------------------------------- the CPU ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hk,G,S,D,n_valid", [
    (2, 2, 4, 50, 16, 1), (2, 2, 4, 50, 16, 37), (1, 4, 1, 64, 64, 64),
    (3, 1, 12, 70, 120, 65), (2, 2, 16, 33, 128, 2)])
def test_cpu_op_is_the_old_core(dtype, B, Hk, G, S, D, n_valid):
    q, k, v = _qkv(B * S + D, B, Hk, G, S, D, dtype)
    got = decode_attention(q, k, v, n_valid)
    want = _old_core(q, k, v, valid=torch.arange(S) < n_valid).to(dtype)
    assert got.dtype == dtype and got.shape == (B, Hk, G, D)
    assert torch.equal(got, want)
    assert torch.equal(decode_attention_ref(q, k, v, valid=valid_mask(S, n_valid, "cpu")),
                       _old_core(q, k, v, valid=torch.arange(S) < n_valid))


def _old_attn_decode(p, x, cfg, cache_k, cache_v, pos_idx):
    """``attn_decode``'s unsharded path before the kernel, as it stood."""
    B = x.shape[0]
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_ctx = cache_k.shape[2]
    positions = torch.full((B, 1), pos_idx, dtype=torch.long)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    q, k, v = A._project_qkv(p, x, cfg, positions)
    slot = pos_idx % S_ctx if cfg.window is not None else pos_idx
    cache_k[:, :, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, slot] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(S_ctx) < min(pos_idx + 1, S_ctx)
    o = _old_core(q.reshape(B, Hk, H // Hk, Dh), cache_k, cache_v, valid=valid)
    return o.to(x.dtype).reshape(B, 1, H * Dh) @ p.wo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,pos", [("yi-9b", 5), ("h2o-danube-3-4b", 40),
                                      ("starcoder2-15b", 0), ("qwen2-vl-72b", 9)])
def test_cpu_attn_decode_unchanged(dtype, arch, pos):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    attn = DecoderLM(cfg, init_params(cfg, 0, "cpu")).blocks[0].attn
    S_ctx = min(48, cfg.window) if cfg.window else 48
    shape = (2, cfg.n_kv_heads, S_ctx, cfg.head_dim)
    gen = torch.Generator().manual_seed(pos)
    ck = torch.randn(shape, generator=gen).to(cfg.torch_dtype)
    cv = torch.randn(shape, generator=gen).to(cfg.torch_dtype)
    x = torch.randn((2, 1, cfg.d_model), generator=gen).to(cfg.torch_dtype)
    with torch.inference_mode():
        want = _old_attn_decode(attn, x, cfg, ck.clone(), cv.clone(), pos)
        got, gk, gv = A.attn_decode(attn, x, cfg, ck.clone(), cv.clone(), pos)
        _old_attn_decode(attn, x, cfg, ck, cv, pos)
    assert torch.equal(got, want)
    assert torch.equal(gk, ck) and torch.equal(gv, cv)


def _counted(q, k, v, n_valid):
    """The op inside a recorded span -> (output, the span's counts)."""
    spans.clear()
    with spans.recording(), spans.span("attn"):
        out = decode_attention(q, k, v, n_valid)
    (rec,) = spans.finished()
    return out, rec.counts


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_positions_read_by_route(device):
    """The plain route reads every slot and counts them: ``kv_read`` is
    S_ctx; the card's route counts n_valid (``test_kernel_at_the_serving_shape``)."""
    q, k, v = (t.to(device) for t in _qkv(0, 2, 2, 4, 40, 16, torch.bfloat16))
    out, counts = _counted(q, k, v, 9)
    assert out.shape == q.shape and out.device.type == device
    assert counts == {"kv_read": 40, "kv_valid": 9}


def _bad(case):
    q, k, v = _qkv(0, 2, 2, 4, 20, 16, torch.bfloat16)
    n = 5
    if case == "q 3-D":
        q = q[0]
    elif case == "k dtype":
        k = k.float()
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "v not contiguous":
        v = v.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "k shape":
        k = k[:, :1].contiguous()
    elif case == "v length":
        v = v[:, :, :10].contiguous()
    elif case == "group 17":
        q, k, v = _qkv(0, 2, 2, 17, 20, 16, torch.bfloat16)
    elif case == "head_dim 12":
        q, k, v = _qkv(0, 2, 2, 4, 20, 12, torch.bfloat16)
    elif case == "head_dim 136":
        q, k, v = _qkv(0, 2, 2, 4, 20, 136, torch.bfloat16)
    elif case == "n_valid 0":
        n = 0
    elif case == "n_valid past the cache":
        n = 21
    return q, k, v, n


@pytest.mark.parametrize("case", ["q 3-D", "k dtype", "float16", "v not contiguous",
                                  "k shape", "v length", "group 17", "head_dim 12",
                                  "head_dim 136", "n_valid 0", "n_valid past the cache"])
def test_check_inputs_refuses(case):
    with pytest.raises(ValueError):
        kernel.check_inputs(*_bad(case))


def test_check_inputs_takes_the_served_shapes():
    for D, G in ((16, 1), (64, 3), (120, 12), (128, 16), (8, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(1, 1, 2, G, 9, D, dtype)
            kernel.check_inputs(q, k, v, 9)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _qkv(0, 1, 1, 2, 8, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.decode_attention_cuda(q, k, v, 4)
    with pytest.raises(ValueError, match="different devices"):
        decode_attention(q, k.to("meta"), v, 4)


@pytest.mark.parametrize("blocks,n_valid,tile,slots,want", [
    (512, 2250, 64, 264, (1, 2304)),       # yi-9b at 128 sequences: one launch
    (264, 4096, 64, 264, (1, 4096)),
    (32, 2250, 64, 264, (8, 320)),         # 8 sequences: 8 splits of 5 tiles
    (2, 1, 64, 264, (1, 64)),
    (1, 130, 32, 660, (5, 32)),            # one tile a split at most
    (8, 65, 64, 264, (2, 64)),
])
def test_plan_splits(blocks, n_valid, tile, slots, want):
    assert kernel.plan_splits(blocks, n_valid, tile, slots) == want


def test_plan_splits_covers_every_position_once():
    for blocks in (1, 3, 8, 32, 100, 263, 264, 1000):
        for n_valid in (1, 2, 63, 64, 65, 1000, 2250, 4096, 32768):
            for tile in (32, 64):
                splits, per = kernel.plan_splits(blocks, n_valid, tile, 264)
                assert per % tile == 0 and splits >= 1
                assert (splits - 1) * per < n_valid <= splits * per   # none empty
                assert splits == 1 or blocks * splits <= 264         # one wave


# --------------------------------------------------------------- the card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _hold(q, k, v, n_valid):
    """The kernel on a cache whose slots past ``n_valid`` hold NaN, against
    the plain version on the same cache with them zeroed; returns the worst
    error over its bar."""
    S = k.shape[2]
    kz, vz = k.clone(), v.clone()
    kz[:, :, n_valid:] = 0
    vz[:, :, n_valid:] = 0
    kn, vn = k.clone(), v.clone()
    kn[:, :, n_valid:] = float("nan")
    vn[:, :, n_valid:] = float("nan")
    got = kernel.decode_attention_cuda(q, kn, vn, n_valid)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all()), "a slot past n_valid reached the output"
    want = decode_attention_ref(q, kz, vz, valid=valid_mask(S, n_valid, q.device))
    bar = summation_bar(q, k, v, n_valid, q.dtype)
    ratio = float(((got.double() - want.double()).abs() / bar).max())
    assert ratio <= 1.0, f"error {ratio} x the float32 bar at n_valid {n_valid}"
    return ratio


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("D", [16, 64, 120, 128])
def test_kernel_matches_plain(cuda, D, G, dtype):
    S = 130
    calls = splits = 0
    kernel.reset_launches()
    for B in (1, 8, 128):
        q, k, v = _qkv(B + G + D, B, 2, G, S, D, dtype, cuda)
        for n_valid in (1, 2, 63, 64, 65, S):
            _hold(q, k, v, n_valid)
            calls += 1
            n_split, _ = kernel.plan_splits(B * 2, n_valid, kernel.TILE[dtype],
                                            kernel.slots(cuda, D, dtype))
            splits += n_split > 1
    assert kernel.launches == {"decode_attention": calls, "decode_attention_split": splits}
    assert 0 < splits < calls           # both routes ran


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_valid", [2250, 4096])
def test_kernel_at_the_serving_shape(cuda, n_valid):
    """yi-9b decoding 128 sequences over a 4,096-slot cache: 512 blocks, one
    launch and no split, against the plain version; the op counts the
    n_valid slots the kernel reads."""
    q, k, v = _qkv(n_valid, 128, 4, 8, 4096, 128, torch.bfloat16, cuda)
    kernel.reset_launches()
    _hold(q, k, v, n_valid)
    _, counts = _counted(q, k, v, n_valid)
    assert counts == {"kv_read": n_valid, "kv_valid": n_valid}
    assert kernel.launches == {"decode_attention": 2, "decode_attention_split": 0}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,steps", [("h2o-danube-3-4b", 45), ("starcoder2-15b", 12),
                                        ("deepseek-7b", 12)])
def test_attn_decode_on_the_card(cuda, dtype, arch, steps):
    """``attn_decode`` step by step on the card against the CPU, the cache
    written by both; h2o-danube's ring of 32 wraps after 32 steps, so its
    valid slots are a full ring out of order."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    attn = DecoderLM(cfg, init_params(cfg, 0, "cpu")).blocks[0].attn
    S_ctx = min(64, cfg.window) if cfg.window else 64
    shape = (2, cfg.n_kv_heads, S_ctx, cfg.head_dim)
    caches = [torch.zeros(shape, dtype=cfg.torch_dtype) for _ in range(2)]
    card = [c.to(cuda) for c in caches]
    attn_card = DecoderLM(cfg, init_params(cfg, 0, "cpu")).to(cuda).blocks[0].attn
    gen = torch.Generator().manual_seed(steps)
    kernel.reset_launches()
    with torch.inference_mode():
        for pos in range(steps):
            x = torch.randn((2, 1, cfg.d_model), generator=gen).to(cfg.torch_dtype)
            want, *caches = A.attn_decode(attn, x, cfg, *caches, pos)
            got, *card = A.attn_decode(attn_card, x.to(cuda), cfg, *card, pos)
            tol = 2e-2 if dtype == "bfloat16" else 1e-4
            torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)
    assert kernel.launches["decode_attention"] == steps
