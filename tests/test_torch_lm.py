"""The torch port's attention-only language models against the reference's.

The reference package's own parameters (``repro.models.common.init_params``)
cross to the port through ``repro_torch.models.convert``; inputs are made
with numpy from a seed and fed to both.  Both run on the CPU, where both
take the reference's XLA attention path (``_dense_attention``, mask -1e30).

Bars: float32 logits at rtol/atol 1e-4; the bf16 case at relative L2 2e-2;
the port's decode against its own forward at max abs 2e-2, as
``tests/test_arch_smoke.py`` holds the reference.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.models.common import init_params as jax_init_params
from repro.runtime.monitor import ProgressMonitor as JaxMonitor
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.common import (cross_entropy, init_params,
                                       param_specs)
from repro_torch.models.convert import params_from_arrays
from repro_torch.runtime.monitor import ProgressMonitor

ATTN_ONLY = ["deepseek-7b", "yi-9b", "h2o-danube-3-4b", "starcoder2-15b",
             "qwen2-vl-72b", "musicgen-medium"]
#: ported since the MoE/Mamba slice
NOT_PORTED = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]
RTOL = ATOL = 1e-4
B = 2


def _pair(arch, **over):
    """(reference cfg, reference params, port cfg, port model)."""
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                             device="cpu")


def _batch(cfg, S, seed=1):
    """The same numpy batch for both packages: (reference, port)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        emb = (0.1 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
        return {"embeddings": jnp.asarray(emb)}, {"embeddings": torch.from_numpy(emb)}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _step_batch(jb, tb, t):
    key = next(iter(jb))
    return {key: jb[key][:, t:t + 1]}, {key: tb[key][:, t:t + 1]}


# ------------------------------------------------------- configurations ----

@pytest.mark.parametrize("arch", configs.list_archs())
def test_configs_match_reference(arch):
    for get, jget in ((configs.get_config, jax_get_config),
                      (configs.get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert configs.get_config(arch).n_params() == jax_get_config(arch).n_params()
    assert configs.get_config(arch).active_params() == jax_get_config(arch).active_params()


def test_config_tables():
    from repro import configs as jcfgs

    assert configs.list_archs() == jcfgs.list_archs()
    assert configs.SHAPES.keys() == jcfgs.SHAPES.keys()
    assert configs.VARIANTS == jcfgs.VARIANTS
    for arch in configs.list_archs():
        assert (configs.applicable_shapes(configs.get_config(arch))
                == jcfgs.applicable_shapes(jcfgs.get_config(arch)))
    v = configs.apply_variants(configs.get_config("yi-9b"), ["no_remat", ""])
    assert v.remat is False
    with pytest.raises(KeyError):
        configs.apply_variants(v, ["nope"])


def test_attn_bf16_variant_is_rejected():
    """The variant was refused while the port's attention computed in f32
    only; now ``apply_variants`` takes it, as the reference's does, and the
    plain path's scores follow ``attn_f32``: the forward matches the
    reference's with the same variant (bf16 scores, relative L2 2e-2)."""
    cfg = configs.apply_variants(configs.get_config("yi-9b"), ["attn_bf16"])
    assert cfg.attn_f32 is False
    jcfg, jp, cfg, model = _pair("yi-9b", dtype="bfloat16", attn_f32=False)
    jb, tb = _batch(cfg, 24)
    want = np.asarray(JT.forward(jp, jcfg, jb).astype(jnp.float32))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_init_params_follows_the_specs():
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    tree = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    for path, spec in param_specs(cfg).items():
        leaf, twin = tree, again
        for part in path.split("."):
            leaf, twin = leaf[part], twin[part]
        assert tuple(leaf.shape) == spec.shape, path
        assert leaf.dtype == (torch.float32 if spec.dtype else cfg.torch_dtype), path
        assert torch.equal(leaf, twin), path
        if spec.init == "ones":
            assert bool((leaf == 1).all()), path
    wq = tree["blocks"]["pos0"]["attn"]["wq"]
    assert abs(float(wq.std()) - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    bf = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=3, device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.float32


# ---------------------------------------------------- forward / prefill ----

@pytest.mark.parametrize("arch", ATTN_ONLY)
def test_forward_and_prefill_match_reference(arch):
    jcfg, jp, cfg, model = _pair(arch)
    jb, tb = _batch(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
        last = T.prefill(model, cfg, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(JT.prefill(jp, jcfg, jb)),
                               rtol=RTOL, atol=ATOL)


def test_bf16_forward_matches_reference():
    jcfg, jp, cfg, model = _pair("yi-9b", dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    jb, tb = _batch(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb).astype(jnp.float32))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def test_loss_matches_reference():
    jcfg, jp, cfg, model = _pair("deepseek-7b")
    jb, tb = _batch(cfg, S=21)
    labels = np.random.default_rng(2).integers(-1, cfg.vocab_size, (B, 21)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    with torch.inference_mode():
        got = float(T.loss_fn(model, cfg, tb))
    np.testing.assert_allclose(got, float(JT.loss_fn(jp, jcfg, jb)), rtol=1e-5)
    logits = np.random.default_rng(3).standard_normal((3, 5, 7)).astype(np.float32)
    lab = np.array([[0, 6, -1, 2, 3]] * 3, np.int32)
    np.testing.assert_allclose(
        float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))),
        float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab))), rtol=1e-6)


# ------------------------------------------------------------------ decode ----

def test_decode_matches_reference_through_the_ring():
    """40 steps on h2o-danube smoke: window 32, so the ring buffer wraps."""
    jcfg, jp, cfg, model = _pair("h2o-danube-3-4b")
    steps = 40
    assert cfg.window < steps
    jb, tb = _batch(cfg, S=steps)
    jcache = JT.init_cache(jcfg, B, steps)
    cache = T.init_cache(cfg, B, steps, device="cpu")
    assert cache["pos0"]["k"].shape == jcache["pos0"]["k"].shape
    assert cache["pos0"]["k"].shape[3] == cfg.window
    step = jax.jit(lambda c, b, i: JT.decode_step(jp, jcfg, c, b, i))
    with torch.inference_mode():
        for t in range(steps):
            jb1, tb1 = _step_batch(jb, tb, t)
            want, jcache = step(jcache, jb1, jnp.int32(t))
            got, cache = T.decode_step(model, cfg, cache, tb1, t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {t}")
    np.testing.assert_allclose(cache["pos0"]["k"].numpy(), np.asarray(jcache["pos0"]["k"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ATTN_ONLY)
def test_decode_matches_forward(arch):
    """Token-by-token cached decode reproduces full-sequence logits; 40 steps,
    past the window of h2o-danube smoke."""
    cfg = configs.get_smoke_config(arch)
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    steps = 40
    _, tb = _batch(cfg, S=steps, seed=42)
    with torch.inference_mode():
        full = T.forward(model, cfg, tb)
        cache = T.init_cache(cfg, B, steps, device="cpu")
        worst = 0.0
        for t in range(steps):
            tb1 = {k: v[:, t:t + 1] for k, v in tb.items()}
            logits, cache = T.decode_step(model, cfg, cache, tb1, t)
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst < 2e-2, worst


def test_decode_past_the_cache_raises():
    cfg = configs.get_smoke_config("yi-9b")
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    cache = T.init_cache(cfg, 1, 4, device="cpu")
    with torch.inference_mode(), pytest.raises(IndexError, match="outside the cache"):
        T.decode_step(model, cfg, cache, {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 4)


# ------------------------------------------------------------------- serve ----

def test_serve_matches_reference(capsys):
    jax_serve.main(["--arch", "yi-9b"])
    printed = capsys.readouterr().out
    want = [int(x) for x in re.search(r"sample continuation: \[([^\]]*)\]",
                                      printed).group(1).split(",")]
    jcfg = jax_smoke("yi-9b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config("yi-9b")
    model = params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    out = serve.main(["--device", "cpu", "--arch", "yi-9b"], params=model)
    assert out["sample"] == want
    assert out["continuations"].shape == (8, 16)
    assert out["requests"] == 8 and out["prompt_len"] == 32 and out["generated"] == 16
    assert out["tok_s"] > 0 and out["median_step_ms"] > 0
    assert "sample continuation" in capsys.readouterr().out
    # the greedy continuation of every request, against the reference's step
    cache = JT.init_cache(jcfg, 8, 48)
    step = jax.jit(lambda c, b, i: JT.decode_step(jp, jcfg, c, b, i))
    for t in range(32):
        logits, cache = step(cache, {"tokens": jnp.asarray(out["prompts"][:, t:t + 1])},
                             jnp.int32(t))
    np.testing.assert_allclose(out["prompt_logits"].numpy(), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    for t in range(32, 48):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(np.asarray(tok)[:, 0], out["continuations"][:, t - 32])
        logits, cache = step(cache, {"tokens": tok}, jnp.int32(t))


def test_serve_prefill_crosscheck_on_cpu():
    """The check the chip smoke run makes at full width, here at smoke size:
    prefill of the prompts against the decode path's logits."""
    cfg = configs.get_smoke_config("yi-9b")
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    out = serve.main(["--device", "cpu", "--arch", "yi-9b"], params=model)
    with torch.inference_mode():
        last = T.prefill(model, cfg, {"tokens": torch.as_tensor(out["prompts"])})
    torch.testing.assert_close(last, out["prompt_logits"], rtol=1e-4, atol=1e-4)


def test_serve_default_arch_is_served():
    """With no ``--arch`` the launcher serves the reference's default,
    rwkv6-1.6b (its smoke config)."""
    out = serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "3",
                      "--gen-len", "2"])
    assert out["arch"] == "rwkv6-smoke"
    assert out["continuations"].shape == (2, 2)


def test_serve_refuses_audio():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "musicgen-medium"])


# --------------------------------------------------------- not yet ported ----

@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_families_raise(arch):
    """The MoE and Mamba families build; since the bf16 variants slice
    nothing raises any more, ``rwkv_bf16`` included (it changes only the
    RWKV-6 mixer)."""
    cfg = configs.get_smoke_config(arch)
    T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    T.init_cache(cfg, 1, 8, device="cpu")
    cfg = dataclasses.replace(cfg, rwkv_bf16=True)
    T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    T.init_cache(cfg, 1, 8, device="cpu")


# ----------------------------------------------------------------- monitor ----

def test_monitor_matches_reference():
    from repro.core import PPoly as RefPPoly
    from repro_torch.core import PPoly

    durations = [0.5, 0.4, 0.6, 0.5, 0.45, 0.5, 2.5, 0.5]
    ours, ref = ProgressMonitor(), JaxMonitor()
    ours.durations, ref.durations = list(durations), list(durations)
    for t in (0.0, 1.3, 2.9, 7.0):
        assert ours.measured_progress()(t) == pytest.approx(ref.measured_progress()(t))
    pred = ([0.0, 10.0], [[0.0, 2.0], [20.0]])
    assert ours.progress_gap(PPoly(*pred), 3.0) == pytest.approx(
        ref.progress_gap(RefPPoly(*pred), 3.0))
    assert ours.baseline() == ref.baseline()
