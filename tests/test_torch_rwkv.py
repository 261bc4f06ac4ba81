"""The torch port's RWKV-6 model against the reference's.

The reference package's own parameters (``repro.models.common.init_params``)
cross to the port through ``repro_torch.models.convert``; inputs are made
with numpy from a seed and fed to both.  Both run on the CPU, where the
port's wkv6 op takes its plain chunked version, the float32 function the
reference's ``rwkv_time_mix`` computes with ``wkv_chunked``.

Bars: float32 logits at rtol/atol 1e-4, as ``tests/test_torch_lm.py``
holds the attention families; the bf16 model at relative L2 2e-2; the
port's decode against its own forward at max abs 2e-2, as
``tests/test_arch_smoke.py`` holds the reference; decode states at
rtol/atol 1e-4.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro.models.common import init_params as jax_init_params
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_arrays

ARCH = "rwkv6-1.6b"
RTOL = ATOL = 1e-4
B = 2


def _pair(**over):
    """(reference cfg, reference params, port cfg, port model)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                             device="cpu")


def _tokens(cfg, S, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


# -------------------------------------------------------- parameters ----

def test_params_carry_across():
    """``params_from_arrays`` keeps every RWKV leaf's bits and dtype: float32
    norms, decay bias and bonus; the matrices in the model dtype."""
    jcfg, jp, cfg, model = _pair(dtype="bfloat16")
    assert cfg.layer_kind(0) == {"mixer": "rwkv6", "ffn": "rwkv_cmix"}
    for g in range(cfg.n_groups):
        blk = model.blocks[g]
        for name, tm in (("rwkv", blk.rwkv), ("cmix", blk.cmix)):
            for leaf, arr in jp["blocks"]["pos0"][name].items():
                got = getattr(tm, leaf)
                want = np.asarray(arr[g])
                assert str(got.dtype).split(".")[-1] == want.dtype.name, (name, leaf)
                np.testing.assert_array_equal(got.float().numpy(),
                                              want.astype(np.float32), err_msg=leaf)
        assert blk.norm_mixer.dtype == torch.float32
    assert model.blocks[0].rwkv.w_bias.dtype == torch.float32
    assert model.blocks[0].rwkv.wr.dtype == torch.bfloat16


# ---------------------------------------------------- layer functions ----

def test_time_mix_and_channel_mix_match_reference():
    """One layer's mixers with a carried state, against the reference's."""
    jcfg, jp, cfg, model = _pair()
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"])
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((B, 19, cfg.d_model))).astype(np.float32)
    st = {"shift": (0.5 * rng.standard_normal((B, cfg.d_model))).astype(np.float32),
          "wkv": (0.2 * rng.standard_normal((B, 4, 16, 16))).astype(np.float32)}
    blk = model.blocks[0]
    for state in (None, st):
        jst = None if state is None else jax.tree.map(jnp.asarray, state)
        tst = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
        want, wst = JR.rwkv_time_mix(p["rwkv"], jnp.asarray(x), jcfg, jst)
        got, gst = R.rwkv_time_mix(blk.rwkv, torch.from_numpy(x), cfg, tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for key in ("shift", "wkv"):
            np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        jst = None if state is None else {"shift": jnp.asarray(state["shift"])}
        tst = None if state is None else {"shift": torch.from_numpy(state["shift"])}
        want, wst = JR.rwkv_channel_mix(p["cmix"], jnp.asarray(x), jcfg, jst)
        got, gst = R.rwkv_channel_mix(blk.cmix, torch.from_numpy(x), cfg, tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gst["shift"].numpy(), np.asarray(wst["shift"]))


# ---------------------------------------------------- forward / prefill ----

@pytest.mark.parametrize("variant", ["", "rwkv_chunk16", "rwkv_chunk64"])
def test_forward_and_prefill_match_reference(variant):
    over = configs.VARIANTS[variant] if variant else {}
    jcfg, jp, cfg, model = _pair(**over)
    jb, tb = _tokens(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
        last = T.prefill(model, cfg, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(JT.prefill(jp, jcfg, jb)),
                               rtol=RTOL, atol=ATOL)


def test_bf16_forward_matches_reference():
    jcfg, jp, cfg, model = _pair(dtype="bfloat16")
    jb, tb = _tokens(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb).astype(jnp.float32))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def test_rwkv_bf16_variant_is_rejected():
    """The variant was refused while the port's wkv6 was float32 only; now
    the config table and the model take it, and the bf16 model's forward and
    a decode step match the reference's with the same variant (relative L2
    2e-2, the bar of the bf16 forward above)."""
    cfg = configs.get_config(ARCH)
    assert configs.apply_variants(cfg, ["rwkv_bf16"]).rwkv_bf16 is True
    for chunk in ("rwkv_chunk16", "rwkv_chunk64"):
        assert configs.apply_variants(cfg, [chunk]).rwkv_chunk == int(chunk[-2:])
    jcfg, jp, cfg, model = _pair(dtype="bfloat16", rwkv_bf16=True)
    jb, tb = _tokens(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb).astype(jnp.float32))
    jcache = JT.init_cache(jcfg, B, 40)
    jstep, _ = JT.decode_step(jp, jcfg, jcache, {"tokens": jb["tokens"][:, :1]}, 0)
    cache = T.init_cache(cfg, B, 40, device="cpu")
    with torch.inference_mode():
        got = T.forward(model, cfg, tb).float().numpy()
        step, _ = T.decode_step(model, cfg, cache, {"tokens": tb["tokens"][:, :1]}, 0)
    for g, w in ((got, want), (step.float().numpy(),
                               np.asarray(jstep.astype(jnp.float32)))):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2


# ------------------------------------------------------------------ decode ----

def test_init_cache_matches_reference():
    jcfg, _, cfg, _ = _pair(dtype="bfloat16")
    want = JT.init_cache(jcfg, 3, 16)
    got = T.init_cache(cfg, 3, 16, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda a: 0, got, is_leaf=lambda a: isinstance(a, torch.Tensor)))
    for path in (("att", "shift"), ("att", "wkv"), ("cmix", "shift")):
        w, g = want["pos0"][path[0]][path[1]], got["pos0"][path[0]][path[1]]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        assert not bool(g.any()), path


def test_decode_matches_reference():
    """40 cached decode steps against the reference's, logits and states."""
    jcfg, jp, cfg, model = _pair()
    steps = 40
    jb, tb = _tokens(cfg, S=steps)
    jcache = JT.init_cache(jcfg, B, steps)
    cache = T.init_cache(cfg, B, steps, device="cpu")
    step = jax.jit(lambda c, b, i: JT.decode_step(jp, jcfg, c, b, i))
    with torch.inference_mode():
        for t in range(steps):
            want, jcache = step(jcache, {"tokens": jb["tokens"][:, t:t + 1]}, jnp.int32(t))
            got, cache = T.decode_step(model, cfg, cache, {"tokens": tb["tokens"][:, t:t + 1]}, t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {t}")
    for path in (("att", "shift"), ("att", "wkv"), ("cmix", "shift")):
        np.testing.assert_allclose(cache["pos0"][path[0]][path[1]].numpy(),
                                   np.asarray(jcache["pos0"][path[0]][path[1]]),
                                   rtol=RTOL, atol=ATOL, err_msg=str(path))


def test_decode_matches_forward():
    """Token-by-token cached decode reproduces full-sequence logits."""
    cfg = configs.get_smoke_config(ARCH)
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    steps = 40
    _, tb = _tokens(cfg, S=steps, seed=42)
    with torch.inference_mode():
        full = T.forward(model, cfg, tb)
        cache = T.init_cache(cfg, B, steps, device="cpu")
        worst = 0.0
        for t in range(steps):
            logits, cache = T.decode_step(model, cfg, cache,
                                          {"tokens": tb["tokens"][:, t:t + 1]}, t)
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst < 2e-2, worst


# ------------------------------------------------------------------- serve ----

def test_serve_default_matches_reference(capsys):
    """With no ``--arch`` both launchers serve rwkv6-smoke: the same greedy
    continuation, and the same logits after the last prompt token."""
    jax_serve.main([])
    printed = capsys.readouterr().out
    want = [int(x) for x in re.search(r"sample continuation: \[([^\]]*)\]",
                                      printed).group(1).split(",")]
    jcfg, jp, cfg, model = _pair()
    out = serve.main(["--device", "cpu"], params=model)
    assert out["arch"] == "rwkv6-smoke"
    assert out["sample"] == want
    assert out["continuations"].shape == (8, 16)
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
    cfg = configs.get_smoke_config(ARCH)
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    out = serve.main(["--device", "cpu", "--arch", ARCH], params=model)
    with torch.inference_mode():
        last = T.prefill(model, cfg, {"tokens": torch.as_tensor(out["prompts"])})
    torch.testing.assert_close(last, out["prompt_logits"], rtol=1e-4, atol=1e-4)
