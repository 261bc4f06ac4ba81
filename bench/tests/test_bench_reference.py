"""The frozen float32 references against the port's plain CPU paths at
each configuration's smoke widths (its file's ``smoke``): prefill logits,
and decode steps over a seeded cache; the chunked wkv against a
token-by-token recurrence."""

from __future__ import annotations

import importlib

import pytest
import torch

from conftest import ROOT, smoke_widths

from bench import run as R
from bench.harness import traffic
from bench.harness.weights import make_weights
from bench.reference import dense_gqa, rwkv6

CPU = torch.device("cpu")
SEED = 2**31 + 12345
SPEC = R.load_json(ROOT / "BENCHMARK.json")
#: each configuration's name and its family's reference module
FAMILIES = [(c["name"], importlib.import_module(
    f"bench.reference.{R.load_json(ROOT / c['file'])['reference']}")) for c in SPEC["configs"]]


def port(widths: dict, weights: dict):
    from repro_torch.models import transformer as T
    from repro_torch.models.common import ModelConfig

    m = dict(widths, name="smoke")
    cfg = ModelConfig(**m)
    return m, T, cfg, T.DecoderLM(cfg, weights)


def widths(name: str) -> dict:
    """The configuration's smoke widths, from its file."""
    return smoke_widths(R.load_json(ROOT / "bench" / "configs" / f"{name}.json"))


@pytest.mark.parametrize("name,ref", FAMILIES)
@pytest.mark.parametrize("S", [40, 97])
def test_prefill_logits(name, ref, S):
    w = widths(name)
    weights = make_weights(ref, w, SEED, CPU, torch.float32)
    m, T, cfg, model = port(w, weights)
    tokens = traffic.prompts(SEED, 1, 3, S, m["vocab_size"], CPU)[0]
    with torch.inference_mode():
        got = T.prefill(model, cfg, {"tokens": tokens})
    want = ref.logits(weights, ref.hidden(weights, m, tokens, last_only=True))
    assert got.shape == want.shape == (3, m["vocab_size"])
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    full = ref.logits(weights, ref.hidden(weights, m, tokens))
    torch.testing.assert_close(full[:, -1], want, rtol=0, atol=1e-5)


def test_decode_steps_over_a_seeded_cache():
    w = widths("yi-9b")
    weights = make_weights(dense_gqa, w, SEED, CPU, torch.float32)
    m, T, cfg, model = port(w, weights)
    B, ctx, P0, steps = 3, 48, 24, 6
    shape = (B, m["n_kv_heads"], P0, m["head_dim"])
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, ctx, CPU)
        for layer in range(m["n_layers"]):
            for which in ("k", "v"):
                cache["pos0"][which][layer, :, :, :P0] = traffic.prefix_kv(
                    SEED, layer, which, shape, torch.float32, CPU)
        tok = traffic.start_tokens(SEED, 0, B, m["vocab_size"])
        fed, got = [], []
        for j in range(steps):
            fed.append(tok)
            logits, _ = T.decode_step(model, cfg, cache, {"tokens": tok}, P0 + j)
            got.append(logits)
            tok = torch.argmax(logits, -1)[:, None]

    def prefix(layer):
        return tuple(traffic.prefix_kv(SEED, layer, x, shape, torch.float32, CPU)
                     for x in ("k", "v"))

    h = dense_gqa.hidden(weights, m, torch.cat(fed, 1), pos0=P0, prefix=prefix)
    want = dense_gqa.logits(weights, h)
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("S", [1, 31, 32, 77])
def test_chunked_wkv_against_the_recurrence(S):
    gen = torch.Generator().manual_seed(S)
    n, H, N = 2, 3, 8
    r, k, v = (torch.randn((n, S, H, N), generator=gen) for _ in range(3))
    logw = -torch.exp(2.0 * torch.randn((n, S, H, N), generator=gen, dtype=torch.float64))
    u = 0.5 * torch.randn((H, N), generator=gen)
    state = torch.zeros((n, H, N, N), dtype=torch.float64)
    want = []
    for t in range(S):
        kv = k[:, t, :, :, None].double() * v[:, t, :, None, :].double()
        want.append(torch.einsum("nhi,nhij->nhj", r[:, t].double(),
                                 state + u[None, :, :, None].double() * kv))
        state = torch.exp(logw[:, t])[..., None] * state + kv
    got = rwkv6.wkv(r, k, v, logw, u)
    torch.testing.assert_close(got.double(), torch.stack(want, 1), rtol=1e-4, atol=1e-4)
