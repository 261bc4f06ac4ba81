"""The port's MoE FFN and Mamba mixer, and the MoE and Jamba language models
built from them, against the reference's on the same inputs.

Parameters are the reference's own (``_init_leaf`` over its specs, or
``init_params``), carried across bit for bit; inputs are made with numpy
from a seed. Bars: MoE variants at max abs 1e-5 against the reference's
same variant (float32) with and without capacity drops, and at the
reference's 1e-4 against the port's global form (``tests/test_moe_variants.py``);
Mamba forward and decode chain at the reference's 1e-4
(``tests/test_models.py``); whole models at rtol/atol 1e-4, the port's
``tests/test_torch_lm.py`` bars.
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
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.models.common import ModelConfig as JConfig
from repro.models.common import _init_leaf, _mamba_specs, _moe_specs
from repro.models.common import init_params as jax_init_params
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, param_specs
from repro_torch.models.convert import params_from_arrays, tensor_from_array

CPU = torch.device("cpu")
MOE_ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]
RTOL = ATOL = 1e-4


def _leaves(spec_fn, jcfg, seed):
    specs = spec_fn(jcfg, 0)
    ks = jax.random.split(jax.random.PRNGKey(seed), len(specs))
    jp = {k: _init_leaf(kk, s, jcfg) for (k, s), kk in zip(specs.items(), ks)}
    return jp, {k: tensor_from_array(v, CPU) for k, v in jp.items()}


def _x(shape, seed=1, scale=0.5):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _maxabs(got, want):
    return float(np.max(np.abs(got.detach().numpy() - np.asarray(want))))


# --------------------------------------------------------------------- MoE --

def _moe_cfgs(cf, impl="global"):
    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8, n_experts=4,
              top_k=2, capacity_factor=cf, dtype="float32", moe_impl=impl)
    return JConfig(**kw), ModelConfig(**kw)


_MOE = {"global": (JMoE.moe_forward_global, MoE.moe_forward_global),
        "local": (JMoE.moe_forward_local, MoE.moe_forward_local),
        "shmap": (JMoE.moe_forward_shmap, MoE.moe_forward_shmap)}


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no_drops", "drops"])
@pytest.mark.parametrize("impl", sorted(_MOE))
def test_moe_matches_reference(impl, cf):
    jcfg, cfg = _moe_cfgs(cf, impl)
    jp, tp = _leaves(_moe_specs, jcfg, seed=0)
    p = MoE.MoE(**tp)
    jx, tx = _x((2, 12, 16))
    jfn, fn = _MOE[impl]
    want = jfn(jp, jx, jcfg)
    with torch.inference_mode():
        got = fn(p, tx, cfg)
        assert torch.equal(MoE.moe_forward(p, tx, cfg), got)  # the dispatch
    assert _maxabs(got, want) < 1e-5, impl
    if cf < 1:   # drops really happen at this capacity
        wide = fn(p, tx, dataclasses.replace(cfg, capacity_factor=8.0))
        assert _maxabs(got, wide.numpy()) > 1e-3


@pytest.mark.parametrize("impl", ["local", "shmap"])
def test_moe_variants_match_global_no_drops(impl):
    _, cfg = _moe_cfgs(8.0)
    jcfg, _ = _moe_cfgs(8.0)
    _, tp = _leaves(_moe_specs, jcfg, seed=0)
    p = MoE.MoE(**tp)
    _, tx = _x((2, 12, 16))
    with torch.inference_mode():
        ref = MoE.moe_forward_global(p, tx, cfg)
        out = _MOE[impl][1](p, tx, cfg)
    assert float((out - ref).abs().max()) < 1e-4


def test_positions_by_sort_matches_cumsum():
    rng = np.random.default_rng(0)
    fe = rng.integers(0, 7, (3, 40))
    t = torch.from_numpy(fe)
    oh = torch.nn.functional.one_hot(t, 7)
    cumsum = torch.gather(torch.cumsum(oh, 1) - oh, 2, t[..., None])[..., 0]
    got = MoE._positions_by_sort(t)
    assert torch.equal(got, cumsum)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JMoE._positions_by_sort(jnp.asarray(fe))))


# ------------------------------------------------------------------- Mamba --

def _mamba_cfgs():
    kw = dict(name="m", family="ssm", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab_size=64, head_dim=8, ssm="mamba",
              d_state=8, d_conv=4, ssm_expand=2, dtype="float32")
    return JConfig(**kw), ModelConfig(**kw)


def test_mamba_forward_and_decode_chain_match_reference():
    jcfg, cfg = _mamba_cfgs()
    jp, tp = _leaves(_mamba_specs, jcfg, seed=0)
    p = M.Mamba(**tp)
    B, L = 2, M.CHUNK + 17                     # cross a chunk boundary
    assert M.CHUNK == JM.CHUNK == 64
    jx, tx = _x((B, L, cfg.d_model), scale=0.3)
    want = JM.mamba_forward(jp, jx, jcfg)
    jst = JM.mamba_init_state(jcfg, B, jx.dtype)
    with torch.inference_mode():
        got = M.mamba_forward(p, tx, cfg)
        assert _maxabs(got, want) < 1e-4
        st = M.mamba_init_state(cfg, B, tx.dtype, CPU)
        assert {k: tuple(v.shape) for k, v in st.items()} == {
            k: tuple(v.shape) for k, v in jst.items()}
        outs = []
        for t in range(L):
            y, st = M.mamba_decode(p, tx[:, t:t + 1], cfg, st)
            jy, jst = JM.mamba_decode(jp, jx[:, t:t + 1], jcfg, jst)
            assert _maxabs(y, jy) < 1e-4, t
            outs.append(y)
        step = torch.cat(outs, 1)
    assert float((step - got).abs().max()) < 1e-4
    assert _maxabs(st["ssm"], jst["ssm"]) < 1e-4
    assert _maxabs(st["conv"], jst["conv"]) < 1e-6


def test_mamba_scan_is_the_recurrence():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, 64, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 64, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(64):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(M._scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- whole model --

def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                             device="cpu")


def _tokens(cfg, S, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (2, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_arrays_carries_moe_and_mamba_leaves(arch):
    jcfg, jp, cfg, model = _pair(arch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(param_specs(cfg))
    for path, leaf in flat:
        keys = [k.key for k in path]
        node = model
        if keys[0] == "blocks":               # blocks.pos{i}.<mixer|ffn>.<w>
            i = int(keys[1][3:])
            for g in range(cfg.n_groups):
                blk = model.blocks[g * cfg.period + i]
                sub = blk if len(keys) == 3 else getattr(blk, keys[2])
                np.testing.assert_array_equal(
                    getattr(sub, keys[-1]).float().numpy(),
                    np.asarray(leaf[g], np.float32))
        else:
            np.testing.assert_array_equal(getattr(node, keys[0]).float().numpy(),
                                          np.asarray(leaf, np.float32))
    kinds = {k for blk in model.blocks for k in blk.kind.values()}
    assert "moe" in kinds
    assert ("mamba" in kinds) == (cfg.ssm == "mamba")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jcfg, jp, cfg, model = _pair(arch)
    jb, tb = _tokens(cfg, S=37)
    want = np.asarray(JT.forward(jp, jcfg, jb))
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
        last = T.prefill(model, cfg, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), want[:, -1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_reference(arch):
    jcfg, jp, cfg, model = _pair(arch)
    steps = 12
    jb, tb = _tokens(cfg, S=steps, seed=5)
    jcache = JT.init_cache(jcfg, 2, steps)
    cache = T.init_cache(cfg, 2, steps, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jcache) == {
        k: {kk: tuple(vv.shape) for kk, vv in v.items()}
        for k, v in cache.items()}
    step = jax.jit(lambda c, b, i: JT.decode_step(jp, jcfg, c, b, i))
    with torch.inference_mode():
        for t in range(steps):
            want, jcache = step(jcache, {"tokens": jb["tokens"][:, t:t + 1]},
                                jnp.int32(t))
            got, cache = T.decode_step(model, cfg, cache,
                                       {"tokens": tb["tokens"][:, t:t + 1]}, t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{t}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """Cached decode reproduces the full forward with capacity drops off
    (``capacity_factor = n_experts``), the reference's own rule
    (``tests/test_arch_smoke.py``)."""
    cfg = configs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    from repro_torch.models.common import init_params

    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    steps = M.CHUNK + 6                          # Mamba crosses a chunk
    _, tb = _tokens(cfg, S=steps, seed=42)
    with torch.inference_mode():
        full = T.forward(model, cfg, tb)
        cache = T.init_cache(cfg, 2, steps, device="cpu")
        worst = 0.0
        for t in range(steps):
            logits, cache = T.decode_step(model, cfg, cache,
                                          {"tokens": tb["tokens"][:, t:t + 1]}, t)
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst < 2e-2, worst


def test_jamba_layer_kinds_follow_the_period():
    cfg = configs.get_config("jamba-v0.1-52b")
    kinds = [cfg.layer_kind(i) for i in range(cfg.period)]
    assert [k["mixer"] for k in kinds].index("attn") == cfg.attn_every // 2 == 4
    assert sum(k["mixer"] == "mamba" for k in kinds) == 7
    assert [k["ffn"] for k in kinds] == ["dense", "moe"] * 4


@pytest.mark.parametrize("variant", ["moe_local", "moe_shmap"])
def test_moe_variants_run_through_the_model(variant):
    base = configs.get_smoke_config("qwen3-moe-235b-a22b")
    cfg = configs.apply_variants(base, [variant])
    jcfg = dataclasses.replace(jax_smoke("qwen3-moe-235b-a22b"),
                               moe_impl=cfg.moe_impl)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jb, tb = _tokens(cfg, S=21)
    with torch.inference_mode():
        got = T.forward(model, cfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(JT.forward(jp, jcfg, jb)),
                               rtol=RTOL, atol=ATOL)


def test_serve_moe_matches_reference(capsys):
    jax_serve.main(["--arch", "qwen3-moe-235b-a22b"])
    printed = capsys.readouterr().out
    want = [int(x) for x in re.search(r"sample continuation: \[([^\]]*)\]",
                                      printed).group(1).split(",")]
    jcfg = jax_smoke("qwen3-moe-235b-a22b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config("qwen3-moe-235b-a22b")
    model = params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    out = serve.main(["--device", "cpu", "--arch", "qwen3-moe-235b-a22b"],
                     params=model)
    assert out["sample"] == want
    assert out["continuations"].shape == (8, 16)


def test_serve_takes_a_depth_cut_model():
    cfg = dataclasses.replace(configs.get_smoke_config("jamba-v0.1-52b"),
                              n_layers=8)
    from repro_torch.models.common import init_params

    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    out = serve.main(["--device", "cpu", "--arch", "jamba-v0.1-52b",
                      "--requests", "2", "--gen-len", "4"], params=model)
    assert out["continuations"].shape == (2, 4)
    other = T.DecoderLM(configs.get_smoke_config("yi-9b"),
                        init_params(configs.get_smoke_config("yi-9b"), seed=0,
                                    device="cpu"))
    with pytest.raises(ValueError, match="not jamba"):
        serve.main(["--device", "cpu", "--arch", "jamba-v0.1-52b"],
                   params=other)
