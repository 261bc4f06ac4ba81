"""M-RoPE with distinct (t, h, w) position streams against the reference.

``tests/test_models.py`` checks M-RoPE only where the three streams are the
same, and ``tests/test_torch_lm.py`` feeds qwen2-vl the default positions,
where M-RoPE equals RoPE.  Here the positions are those of an image prompt,
made by ``chip_smoke.py``'s builder (its copy for the tests is
``tests/mrope_image_positions.py``): text, then a patch grid
whose h and w streams differ, then text.  ``apply_mrope`` and qwen2-vl
smoke's forward are held against ``repro`` on the same numpy-seeded inputs
at rtol/atol 1e-4, the bar of the other logits in ``test_torch_lm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JT
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.common import init_params as jax_init_params
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.convert import params_from_arrays

from mrope_image_positions import mrope_positions

RTOL = ATOL = 1e-4
ARCH = "qwen2-vl-72b"


def test_positions_builder_gives_distinct_streams():
    pos = mrope_positions(2, 48, 8, (4, 6))
    assert tuple(pos.shape) == (3, 2, 48)
    t, h, w = pos[:, 0]
    assert torch.equal(t[:8], h[:8]) and torch.equal(h[:8], w[:8])
    assert not torch.equal(h[8:32], w[8:32]) and not torch.equal(t[8:32], h[8:32])
    assert torch.equal(t[32:], h[32:]) and int(t[32]) == 8 + 6


@pytest.mark.parametrize("cfg", [configs.get_smoke_config(ARCH), configs.get_config(ARCH)],
                         ids=["smoke", "full"])
def test_apply_mrope_matches_reference_on_image_positions(cfg):
    B, S, H, Dh = 2, 48, 3, cfg.head_dim
    x = np.random.default_rng(0).standard_normal((B, S, H, Dh)).astype(np.float32)
    pos = mrope_positions(B, S, 8, (4, 6))
    want = np.asarray(jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos.numpy()),
                                      cfg.rope_theta, cfg.mrope_sections))
    got = apply_mrope(torch.from_numpy(x), pos, cfg.rope_theta, cfg.mrope_sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the streams matter: the rotation differs from RoPE on the t stream alone
    rope = apply_rope(torch.from_numpy(x), pos[0], cfg.rope_theta)
    assert float((rope - got).abs().max()) > 1e-2


def test_qwen2_vl_forward_matches_reference_on_image_positions():
    jcfg = jax_smoke(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_arrays(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    B, S = 2, 48
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = mrope_positions(B, S, 8, (4, 6))
    want = np.asarray(JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "positions": jnp.asarray(pos.numpy())}))
    with torch.inference_mode():
        got = T.forward(model, cfg, {"tokens": torch.from_numpy(toks), "positions": pos})
        default = T.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the image positions move the logits from the default (text) positions
    assert float((got - default).abs().max()) > 1e-3
