"""The work counts (``bench/work/lm.py`` and each family's counts in
``bench/reference``) against counts made by hand."""

from __future__ import annotations

import math

import pytest

from conftest import ROOT

from bench import run as R
from bench.reference import dense_gqa, rwkv6
from bench.work import lm, peaks

YI = R.load_json(ROOT / "bench" / "configs" / "yi-9b.json")["model"]
RWKV = R.load_json(ROOT / "bench" / "configs" / "rwkv6-1.6b.json")["model"]


def test_peaks():
    assert peaks.BF16_FLOPS == 989.4e12 and peaks.HBM_BYTES_S == 3.35e12
    assert peaks.F32_FLOPS == 67e12


def test_parameter_counts():
    # yi-9b: q and o 4096 x 4096, k and v 4096 x 512, three 4096 x 11008
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert per_layer == 173_015_040 == dense_gqa.layer_matrix_params(YI)
    assert lm.param_count(dense_gqa, YI) == pytest.approx(8.83e9, rel=1e-3)
    assert lm.param_count(rwkv6, RWKV) == pytest.approx(1.58e9, rel=2e-3)
    assert 2 * lm.param_count(dense_gqa, YI) == pytest.approx(17.66e9, rel=1e-3)


def test_yi_prefill_b4_s4096():
    """2 x 8.30e9 x 16,384 for the layers' products, 2.64e13 for causal
    attention, the output head for the 4 last positions."""
    gemm = 2 * 48 * 173_015_040 * 4 * 4096
    attn = 48 * 4 * 4 * 32 * 128 * (4096 * 4097 // 2)
    head = 2 * 4096 * 64000 * 4
    assert gemm == pytest.approx(2 * 8.30e9 * 16_384, rel=1e-3)
    assert attn == pytest.approx(2.64e13, rel=1e-2)
    assert lm.prefill_call(dense_gqa, YI, 4, 4096) == gemm + attn + head
    assert lm.prefill_call(dense_gqa, YI, 4, 4096) == pytest.approx(2.98e14, rel=1e-2)


def test_flash_call_bound():
    """B = 2: 0.2780 ms on the operations side (bytes 0.045 ms)."""
    ops, nbytes = dense_gqa.flash_call(YI, 2, 4096)
    assert ops == 4 * 2 * 32 * 128 * (4096 * 4097 // 2)
    assert nbytes == 2 * (2 * 2 * 32 * 4096 * 128 + 2 * 2 * 4 * 4096 * 128)
    assert lm.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.2780, rel=1e-3)
    assert nbytes / peaks.HBM_BYTES_S * 1e3 == pytest.approx(0.045, rel=0.05)


def test_wkv6_call_bound():
    """(2, 4096, 32, 64) float32: 0.1008 ms on the bytes side; chunk 32."""
    ops, nbytes = rwkv6.wkv6_call(RWKV, 2, 4096)
    assert nbytes == 4 * (5 * 2 * 4096 * 32 * 64 + 32 * 64 + 2 * 2 * 32 * 64 * 64)
    per_chunk = 4 * 32 * 64 * 64 + 7 * (32 * 31 // 2) * 64 + 8 * 32 * 64
    assert ops == 2 * 32 * 128 * per_chunk
    assert lm.bound_s(ops, nbytes, peaks.F32_FLOPS) * 1e3 == pytest.approx(0.1008, rel=1e-3)
    assert ops / peaks.F32_FLOPS < nbytes / peaks.HBM_BYTES_S


def test_rwkv_prefill_b8():
    per_layer = 6 * 2048 * 2048 + 2 * 2048 * 7168
    want = (2 * 24 * per_layer * 8 * 4096 + 2 * 2048 * 65536 * 8
            + 24 * rwkv6.wkv6_call(RWKV, 8, 4096)[0])
    assert lm.prefill_call(rwkv6, RWKV, 8, 4096) == want


def test_decode_step_at_2048():
    ops = lm.decode_step(dense_gqa, YI, 128, 2048)
    assert ops == (2 * 48 * 173_015_040 * 128 + 2 * 4096 * 64000 * 128
                   + 48 * 4 * 128 * 32 * 128 * 2049)
    nbytes = lm.decode_step_bytes(dense_gqa, YI, 128, 2048)
    weights = 2 * (48 * 173_015_040 + 4096 * 64000) + 4 * (2 * 48 * 4096 + 4096)
    cache = 48 * 2 * 128 * 4 * 128 * 2 * 2049
    assert nbytes == weights + 2 * 128 * 4096 + cache
    assert nbytes == pytest.approx(43.2e9, rel=1e-2)
    assert math.isclose(nbytes / peaks.HBM_BYTES_S * 1e3, 12.9, rel_tol=1e-2)


def test_kernel_calls_by_family():
    """Each family names its mixer's kernel calls: 48 flash calls in a
    yi-9b prefill, 24 wkv6 calls in an rwkv6 one, and neither the other's."""
    assert dense_gqa.kernel_calls(YI, 4, 4096) == {
        "flash_attention": (48, *dense_gqa.flash_call(YI, 4, 4096))}
    assert rwkv6.kernel_calls(RWKV, 8, 4096) == {
        "wkv6": (24, *rwkv6.wkv6_call(RWKV, 8, 4096))}


def test_rwkv6_published_decay_and_bonus():
    """The decay bias runs from -6 to -1 over the channels (exponent 0.7 in
    the first layer, 2.0 in the last); the bonus from the layer ratio down,
    with the 0.1 zigzag."""
    import torch

    bias = torch.empty((24, 2048), dtype=torch.float32)
    rwkv6.time_decay(bias)
    assert bias[:, 0].eq(-6).all() and bias[:, -1].eq(-1).all()
    assert bias[0, 1023].item() == pytest.approx(-6 + 5 * (1023 / 2047) ** 0.7, rel=1e-6)
    assert bias[23, 1023].item() == pytest.approx(-6 + 5 * (1023 / 2047) ** 2.0, rel=1e-6)
    u = torch.empty((24, 2048), dtype=torch.float32)
    rwkv6.time_bonus(u)
    assert u[0, :3].tolist() == pytest.approx([0.0, 0.1, -0.1])
    assert u[23, 0].item() == pytest.approx(1.0)
    assert u[23, 2047].item() == pytest.approx(0.1 * ((2048 % 3) - 1))
