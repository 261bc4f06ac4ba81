"""The work counts (``bench/work/lm.py`` and each family's counts in
``bench/reference``) against counts made by hand."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from conftest import ROOT

from bench import run as R
from bench.reference import dense_gqa, rwkv6
from bench.work import lm, peaks

YI = R.load_json(ROOT / "bench" / "configs" / "yi-9b.json")["model"]
RWKV = R.load_json(ROOT / "bench" / "configs" / "rwkv6-1.6b.json")["model"]
DEEPSEEK = R.load_json(ROOT / "bench" / "configs" / "deepseek-7b.json")["model"]


def test_peaks():
    assert peaks.BF16_FLOPS == 989.4e12 and peaks.HBM_BYTES_S == 3.35e12
    assert peaks.F32_FLOPS == 67e12


def test_parameter_counts():
    # yi-9b: q and o 4096 x 4096, k and v 4096 x 512, three 4096 x 11008
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert per_layer == 173_015_040
    assert 48 * per_layer == dense_gqa.matrix_params(YI) == dense_gqa.active_matrix_params(YI)
    assert dense_gqa.vector_params(YI) == 48 * 2 * 4096
    assert rwkv6.matrix_params(RWKV) == rwkv6.active_matrix_params(RWKV) == 24 * (
        6 * 2048 * 2048 + 2 * 2048 * 7168)
    assert rwkv6.vector_params(RWKV) == 24 * 9 * 2048
    assert lm.param_count(dense_gqa, YI) == pytest.approx(8.83e9, rel=1e-3)
    assert lm.param_count(rwkv6, RWKV) == pytest.approx(1.58e9, rel=2e-3)
    assert 2 * lm.param_count(dense_gqa, YI) == pytest.approx(17.66e9, rel=1e-3)
    # deepseek-7b: full multi-head attention, 30 layers, a 102,400 vocabulary
    assert lm.param_count(dense_gqa, DEEPSEEK) == 6_910_365_696
    assert 2 * lm.param_count(dense_gqa, DEEPSEEK) == pytest.approx(13.82e9, rel=1e-3)


@pytest.mark.parametrize("count,want", [
    (lambda: lm.prefill_call(dense_gqa, YI, 4, 4096), 298525946544128.0),
    (lambda: lm.prefill_call(rwkv6, RWKV, 8, 4096), 86364007694336.0),
    (lambda: lm.decode_step(dense_gqa, YI, 128, 2048), 2399376769024.0),
    (lambda: lm.decode_step(dense_gqa, YI, 128, 4095), 2605434535936.0),
    (lambda: lm.decode_step_bytes(dense_gqa, YI, 128, 2048), 42918756352.0),
    (lambda: lm.decode_step_bytes(dense_gqa, YI, 128, 4095), 68675977216.0),
    (lambda: lm.prefill_call(dense_gqa, DEEPSEEK, 4, 4096), 215442941542400.0),
], ids=["yi-9b.prefill-4k", "rwkv6-1.6b.prefill-4k", "yi-9b.decode-b128.ops@2048",
        "yi-9b.decode-b128.ops@4095", "yi-9b.decode-b128.bytes@2048",
        "yi-9b.decode-b128.bytes@4095", "deepseek-7b.prefill-4k"])
def test_the_cells_counts_as_written(count, want):
    """The counts that ``mfu`` and ``decode.hbm_share`` read at the cells'
    shapes, as literals: the first six as the per-layer counts of PRs 31-33
    gave them, so whole-model counts move no reading."""
    assert count() == want


def test_deepseek_prefill_b4_s4096():
    """1.989e14 in the layers' products, 1.650e13 in flash (group 1), the
    head over 4 rows at a 102,400 vocabulary."""
    gemm = 2 * 30 * (4 * 4096 * 4096 + 3 * 4096 * 11008) * 4 * 4096
    attn = 30 * 4 * 4 * 32 * 128 * (4096 * 4097 // 2)
    head = 2 * 4096 * 102400 * 4
    assert gemm == pytest.approx(1.989e14, rel=1e-3)
    assert attn == pytest.approx(1.650e13, rel=1e-3)
    assert lm.prefill_call(dense_gqa, DEEPSEEK, 4, 4096) == gemm + attn + head
    ops, nbytes = dense_gqa.flash_call(DEEPSEEK, 4, 4096)
    assert lm.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.5558, rel=1e-3)


#: a stand-in family whose period mixes two layer kinds: an attention layer
#: with a dense SwiGLU, then a recurrent layer with a mixture of
#: ``n_experts`` SwiGLU experts of which ``top_k`` meet each token
def _period(m: dict, experts: int) -> int:
    D, F, E = m["d_model"], m["d_ff"], m["n_experts"]
    attn, rec, ffn = 4 * D * D, 3 * D * D, 3 * D * F
    return attn + ffn + rec + D * E + experts * ffn


MIXED = SimpleNamespace(
    matrix_params=lambda m: m["n_layers"] // 2 * _period(m, m["n_experts"]),
    active_matrix_params=lambda m: m["n_layers"] // 2 * _period(m, m["top_k"]),
    vector_params=lambda m: m["n_layers"] * 2 * m["d_model"],
    kernel_calls=lambda m, B, S: {"flash_attention": (m["n_layers"] // 2, 1000.0 * B * S, 0.0),
                                  "scan": (m["n_layers"] // 2, 10.0 * B * S, 0.0)},
    decode_cache=lambda m, B, pos: (m["n_layers"] // 2 * 7.0 * B * (pos + 1),
                                    m["n_layers"] // 2 * 3.0 * B * (pos + 1)))
#: two periods of the stand-in: 8 experts, 2 of them a token's
MIXED_M = dict(n_layers=4, d_model=8, d_ff=16, n_experts=8, top_k=2, vocab_size=32)


def test_a_mixed_period_with_experts_counts_by_hand():
    """Per period: attention 4 * 64 = 256, its SwiGLU 3 * 8 * 16 = 384,
    the recurrent mixer 3 * 64 = 192, the router 8 * 8 = 64, and experts of
    384 each: all 8 (3,072) in the weights, 2 (768) in a token's products.
    Two periods: 2 * 3,968 = 7,936 weights, 2 * 1,664 = 3,328 met."""
    B, S, pos = 3, 5, 9
    assert MIXED.matrix_params(MIXED_M) == 7936
    assert MIXED.active_matrix_params(MIXED_M) == 3328
    head = 2 * 8 * 32
    assert lm.prefill_call(MIXED, MIXED_M, B, S) == (
        2 * 3328 * B * S + head * B + 2 * 1000 * B * S + 2 * 10 * B * S)
    assert lm.decode_step(MIXED, MIXED_M, B, pos) == 2 * 3328 * B + head * B + 2 * 7 * B * 10
    assert lm.decode_step_bytes(MIXED, MIXED_M, B, pos) == (
        2 * (7936 + 8 * 32) + 4 * (4 * 2 * 8 + 8) + 2 * B * 8 + 2 * 3 * B * 10)
    assert lm.param_count(MIXED, MIXED_M) == 7936 + 64 + 2 * 32 * 8 + 8


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
