"""The dry-run's per-device counts on a sharded mesh against the reference's.

Rank 0's FLOPs (``count_cell`` on a fake (2, 4) data x model mesh) over the
reference's per-device HLO dot count on the same mesh shape (eight fake CPU
devices, its cells lowered on an ``Auto``-axis ``jax.sharding.Mesh``, all
21 in one child process), for every family's train, prefill and decode
step: the smoke configs at S = 64, B = 4.  Bars: at most 1.20x (train and
decode) and 1.143x (prefill) the reference's count, and at least its
inverse.  Measured with torch 2.13 and JAX 0.9:

    arch, form            train    prefill  decode
    yi-9b                 0.9412   0.9286   1.0000
    rwkv6-1.6b            0.9928   1.0000   1.0000
    qwen3-moe, global     0.9616   0.9487   1.0117
    qwen3-moe, moe_local  0.9616   0.9487   1.0075
    qwen3-moe, moe_shmap  0.9600   0.9487   1.0000
    kimi-k2               0.9547   0.9375   1.0286
    jamba                 0.9987   0.9931   1.0058

(before the repair of the decode step, the kv projections, the Mamba mixer
and the MoE forms: up to 3.82x).  The kv projections, whose weights the
rules replicate over "model", run a column slice a rank (GSPMD gives each
rank the kv head its query heads use: half of them here, a quarter in a
decode step), so train and prefill count a little under the reference.
Also here: the expert-parallel layout of ``moe_local`` and ``moe_shmap`` on
the mesh (E / M experts a "model" rank, one all-reduce of the layer
output), its partial outputs summed against the meshless forms, and both
forms on the card against the CPU.  This file imports no JAX: the card's
machine has none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import axis_rules
from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh, release_process_group
from repro_torch.launch.specs import count_cell, make_cell
from repro_torch.models import moe as MoE
from repro_torch.perfmodel.opcount import OpCounter

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
S, B = 64, 4
#: rank 0's FLOPs over the reference's per-device FLOPs, at most (and at
#: least the inverse): yi-9b's train and prefill bars
BAR = {"train": 1.20, "prefill": 1.143, "decode": 1.20}
FORMS = [("yi-9b", None), ("rwkv6-1.6b", None), ("qwen3-moe-235b-a22b", None),
         ("qwen3-moe-235b-a22b", "moe_local"), ("qwen3-moe-235b-a22b", "moe_shmap"),
         ("kimi-k2-1t-a32b", None), ("jamba-v0.1-52b", None)]
KINDS = ("train", "prefill", "decode")

_REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import ShapeSpec, apply_variants, get_smoke_config
from repro.distributed.sharding import axis_rules
from repro.launch.specs import lower_cell, make_cell
from repro.perfmodel.hlo import analyze_hlo
forms, kinds, (S, B) = json.loads(sys.argv[1])
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {}
for arch, form in forms:
    cfg = get_smoke_config(arch)
    if form:
        cfg = apply_variants(cfg, [form])
    for kind in kinds:
        with mesh, axis_rules(mesh):
            rep = analyze_hlo(lower_cell(make_cell(cfg, ShapeSpec("s", S, B, kind)))
                              .compile().as_text())
        out[f"{arch}|{form}|{kind}"] = [rep.flops, rep.collective_bytes]
print("COUNTS", json.dumps(out))
"""


@pytest.fixture(autouse=True)
def no_process_group_left():
    """Every test leaves ``torch.distributed`` as it found it: uninitialised."""
    assert not dist.is_initialized()
    yield
    release_process_group()


@pytest.fixture(scope="module")
def reference_counts():
    """The reference's per-device (FLOPs, collective bytes) of every cell on
    the (2, 4) mesh, from one child process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps([FORMS, KINDS, [S, B]])],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("COUNTS", 1)[1])


def _config(arch, form):
    cfg = configs.get_smoke_config(arch)
    return configs.apply_variants(cfg, [form]) if form else cfg


def _rank0(cfg, kind):
    mesh = make_fake_mesh(MESH, ("data", "model"))
    try:
        with axis_rules(mesh):
            return count_cell(make_cell(cfg, configs.ShapeSpec("s", S, B, kind)), mesh)
    finally:
        release_process_group()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch,form", FORMS, ids=[f"{a}-{f or 'global'}" for a, f in FORMS])
def test_rank0_flops_match_reference_on_a_2x4_mesh(reference_counts, arch, form, kind):
    flops, coll = reference_counts[f"{arch}|{form}|{kind}"]
    rep = _rank0(_config(arch, form), kind)
    ratio = rep.flops / flops
    print(f"{arch} {form or 'global'} {kind}: port {rep.flops:.6e} reference {flops:.6e} "
          f"ratio {ratio:.4f}; collective bytes {rep.collective_bytes:.6e} "
          f"against {coll:.6e} ({rep.collective_bytes / coll:.3f}x)")
    assert 1.0 / BAR[kind] <= ratio <= BAR[kind], ratio


def _layer(form, mesh, counter):
    """One qwen3-moe smoke MoE layer in ``form`` on ``mesh``: x batch-split,
    the router whole, the expert stacks split over "experts"; every local
    shard a counted meta tensor."""
    from repro_torch.launch.specs import _dtensor

    cfg = _config("qwen3-moe-235b-a22b", form)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def leaf(shape, axes):
        return _dtensor(torch.empty(shape, device="meta"), axes, mesh, counter)

    experts = ("experts", None, None)
    p = MoE.MoE(leaf((D, E), (None, None)), leaf((E, D, F), experts),
                leaf((E, D, F), experts), leaf((E, F, D), experts))
    return cfg, p, leaf((B, S, D), ("batch", None, None))


@pytest.mark.parametrize("form", ["moe_local", "moe_shmap"])
def test_expert_parallel_forms_on_a_2x4_mesh(monkeypatch, form):
    """On the (2, 4) mesh each "model" rank runs E / M experts on its batch
    rows (rank 0 the first E / M), and the layer records one all-reduce, of
    its (B / 2, S, D) output."""
    seen = []
    inner = MoE._double_scatter_rows

    def spy(x, gates, slot, w_gate, w_up, w_down, *, n_slots):
        seen.append((tuple(x.shape), tuple(w_gate.shape), n_slots))
        return inner(x, gates, slot, w_gate, w_up, w_down, n_slots=n_slots)

    monkeypatch.setattr(MoE, "_double_scatter_rows", spy)
    mesh = make_fake_mesh(MESH, ("data", "model"))
    counter = OpCounter()
    try:
        with axis_rules(mesh):
            cfg, p, x = _layer(form, mesh, counter)
            out = MoE.moe_forward(p, x, cfg)
    finally:
        release_process_group()
    D, F = cfg.d_model, cfg.d_ff
    B_loc, E_loc = B // MESH[0], cfg.n_experts // MESH[1]
    cap = MoE._capacity(S, cfg)
    assert seen == [((B_loc, S, D), (E_loc, D, F), E_loc * cap)]
    assert tuple(out.shape) == (B, S, D)
    rep = counter.report()
    assert rep.collective_counts == {"all-reduce": 1}
    assert rep.collective_by_op == {"all-reduce": 4.0 * B_loc * S * D}
    # the router on rank 0's rows, the expert products on its experts' slots
    assert rep.flops == 2.0 * B_loc * S * D * cfg.n_experts + 3 * 2.0 * B_loc * E_loc * cap * D * F


@pytest.mark.parametrize("form", ["moe_local", "moe_shmap"])
def test_expert_parallel_partials_sum_to_the_meshless_form(form):
    """The M partial outputs (each rank's expert range, the local body the
    mesh runs) sum to the form's output over every expert."""
    cfg = _config("qwen3-moe-235b-a22b", form)
    gen = torch.Generator().manual_seed(0)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = [torch.randn(s, generator=gen) / np.sqrt(s[-2])
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    x = torch.randn((B, S, D), generator=gen)
    positions = (MoE._positions_by_sort if form == "moe_shmap"
                 else lambda fe: MoE._positions_by_cumsum(fe, E))
    want = MoE.moe_forward(MoE.MoE(*w), x, cfg)
    M = MESH[1]
    E_loc = E // M
    parts = [MoE._bucketed_expert_math(x, w[0], *(t[r * E_loc:(r + 1) * E_loc] for t in w[1:]),
                                       cfg=cfg, e_lo=r * E_loc, E_loc=E_loc, positions=positions)
             for r in range(M)]
    assert all(float(part.abs().max()) > 0 for part in parts)
    torch.testing.assert_close(sum(parts), want, rtol=1e-5, atol=1e-6)


def test_host_mesh_counts_the_meshless_forms():
    """On a 1x1 mesh the forms count as on one card: no collective at all
    (the reference keeps a ``psum`` over its model axis of size 1)."""
    cfg = _config("qwen3-moe-235b-a22b", "moe_shmap")
    host = make_host_mesh()
    with axis_rules(host):
        rep = count_cell(make_cell(cfg, configs.ShapeSpec("s", S, B, "prefill")), host)
    assert rep.collective_bytes == 0.0 and rep.flops > 0
    assert not dist.is_initialized()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("form", ["moe_local", "moe_shmap"])
def test_moe_forms_on_the_card_match_cpu(cuda, form):
    """qwen3-moe's smoke model in ``form``: the forward's logits on the card
    against the CPU's at 1e-4."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg = _config("qwen3-moe-235b-a22b", form)
    tree = init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = T.forward(T.DecoderLM(cfg, tree), cfg, {"tokens": toks})
            card = T.DecoderLM(cfg, {k: _to(v, cuda) for k, v in tree.items()})
            got = T.forward(card, cfg, {"tokens": toks.to(cuda)})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)
