"""Gradients of the torch port against the reference's on the CPU.

``loss_fn`` and every gradient leaf of the port against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` from the same
parameters (the reference's, carried across with ``params_from_arrays``)
and the same numpy batch: the six light architectures' smoke configs (those
``tests/test_arch_smoke.py`` does not mark slow), qwen3-moe cut to its
period of one layer and jamba's smoke config, whose one period is 8 layers.
Bars: the loss at rtol 1e-5, each leaf within relative L2 1e-4.

Then the autograd wrappers of the two LM kernels, with the CUDA launch
replaced by the plain version so that they run here: their gradients are
the plain version's autograd gradients, bit for bit, for the inputs that
need one and for no other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JT
from repro.models.common import init_params as jax_init_params
from repro_torch import configs
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import wkv_chunked_ref
from repro_torch.kernels.wkv6.ops import Wkv6Fn
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_arrays, to_reference_tree
from repro_torch.runtime.trainer import data_config_for

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
LIGHT = ["deepseek-7b", "yi-9b", "h2o-danube-3-4b", "musicgen-medium",
         "qwen2-vl-72b", "rwkv6-1.6b"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out["/".join((*prefix, k))] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("arch,over", [*((a, {}) for a in LIGHT),
                                       ("qwen3-moe-235b-a22b", {"n_layers": 1}),
                                       ("jamba-v0.1-52b", {})])
def test_loss_and_gradients_match_reference(arch, over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    assert cfg.n_layers % cfg.period == 0
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    model.requires_grad_(True)
    # S = 40: more than one wkv chunk of 32, and past h2o-danube's window
    batch = SyntheticTokenPipeline(data_config_for(cfg, 40, 2)).batch_at(0)
    loss = T.loss_fn(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b)))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    got = _flat(to_reference_tree(model, [p.grad for p in model.parameters()]))
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert rel <= GRAD_REL_L2, (k, rel)


# ------------------------------------------------- the kernel wrappers ----
@pytest.mark.parametrize("need", ["qkv", "q", "kv"])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_wrapper_backward_is_the_plain_gradient(monkeypatch, need, window):
    """FlashAttentionFn's forward is what the kernel returns, and its
    backward recomputes the plain version with the call's causal and window
    arguments: the same gradients as autograd of ``attention_ref``, bit for
    bit, and none for an input that needs none (GQA group 2, S = 37)."""
    calls = []

    def fake_kernel(q, k, v, *, causal, window):
        calls.append((causal, window))
        return attention_ref(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fa, "flash_attention_cuda", fake_kernel)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((2, 4, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16)))
    cot = torch.randn((2, 4, 37, 16), generator=gen)
    grads = []
    for fn in (lambda a, b, c: FlashAttentionFn.apply(a, b, c, True, window),
               lambda a, b, c: attention_ref(a, b, c, causal=True, window=window)):
        ins = [x.clone().requires_grad_(n in need) for x, n in zip((q, k, v), "qkv")]
        (fn(*ins) * cot).sum().backward()
        grads.append([x.grad for x in ins])
    assert calls == [(True, window)]
    for n, got, want in zip("qkv", *grads):
        assert (got is None) == (n not in need)
        assert got is None or torch.equal(got, want)


@pytest.mark.parametrize("need", ["rkvwu", "rkvwus", "w"])
def test_wkv6_wrapper_backward_is_the_plain_gradient(monkeypatch, need):
    """Wkv6Fn's backward recomputes the plain chunked version at the call's
    chunk: the gradients of y and of the final state are autograd's of
    ``wkv_chunked_ref``, bit for bit (L = 45, chunk 16)."""
    monkeypatch.setattr(wk, "wkv6_cuda", wkv_chunked_ref)
    gen = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn((2, 45, 2, 8), generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((2, 45, 2, 8), generator=gen)))
    u, s0 = 0.1 * torch.randn((2, 8), generator=gen), torch.randn((2, 2, 8, 8), generator=gen)
    cy, cs = torch.randn((2, 45, 2, 8), generator=gen), torch.randn((2, 2, 8, 8), generator=gen)
    grads = []
    for fn in (lambda *a: Wkv6Fn.apply(*a, 16), lambda *a: wkv_chunked_ref(*a, chunk=16)):
        ins = [x.clone().requires_grad_(n in need) for x, n in zip((r, k, v, w, u, s0), "rkvwus")]
        y, s = fn(*ins)
        ((y * cy).sum() + (s * cs).sum()).backward()
        grads.append([x.grad for x in ins])
    for n, got, want in zip("rkvwus", *grads):
        assert (got is None) == (n not in need)
        assert got is None or torch.equal(got, want)
