"""The dry-run's per-device counts on a sharded mesh against the reference's.

Rank 0's FLOPs and collective bytes (``count_cell`` on a fake (2, 4) data x
model mesh) over the reference's per-device HLO dot count and collective
operand bytes on the same mesh shape (eight fake CPU devices, its cells
lowered on an ``Auto``-axis ``jax.sharding.Mesh``, all 36 in one child
process), for every family's train, prefill and decode step: the smoke
configs at S = 64, B = 4.  Bars: FLOPs at most 1.20x (train and decode)
and 1.143x (prefill) the reference's count, collective bytes at most 1.5x,
and at least their inverses.  Measured with torch 2.13 and JAX 0.9 (FLOPs,
collective bytes):

    arch, form            train           prefill         decode
    yi-9b                 1.0196  1.361   1.0000  0.900   1.0769  0.804
    rwkv6-1.6b            0.9928  1.308   1.0000  0.897   1.0000  1.142
    qwen3-moe, global     1.0150  1.168   1.0000  0.856   1.0739  0.745
    qwen3-moe, moe_local  1.0150  0.641*  1.0000  0.430*  1.0474  0.821
    qwen3-moe, moe_shmap  1.0133  1.186   1.0000  0.916   1.0396  0.876
    kimi-k2               1.0206  1.138   1.0000  0.824   1.1048  0.748
    jamba                 1.0057  1.083   1.0000  0.882   1.0134  0.961
    deepseek-7b           1.0000  1.400   1.0000  0.897   1.0000  1.145
    h2o-danube-3-4b       1.0196  1.361   1.0000  0.900   1.0833  0.993
    starcoder2-15b        0.8874  1.311   0.8833  0.912   0.9298  0.933
    musicgen-medium       1.0000  1.139   1.0000  1.000   1.0000  1.000
    qwen2-vl-72b          1.0196  1.361   1.0000  0.900   1.0769  0.804

(FLOPs up to 3.82x before the repair of the decode step, the kv
projections, the Mamba mixer and the MoE forms; collective bytes 0.455x to
2.153x before the all-to-all dispatch and combine of the global MoE form,
the kv heads per query head and the partial-sum gradients of
``local_apply``; deepseek-7b up to 1.610x and starcoder2's FLOPs up to
1.2365x before the kv heads' column split and the column-split attention
of an uneven head split).  * held at the port's own bytes: see
``OWN_BYTES``.
Each "model" rank projects the kv head(s) its query heads read, as GSPMD
gives each rank of the reference's program, so a decode step counts a
little over the reference, which splits those products' D over two ranks.
Also here: an exchange booked as an all-to-all, the mesh forms computed on
a real (2, 4) gloo mesh against the plain forms, the expert-parallel layout
of ``moe_local`` and ``moe_shmap`` on the mesh (E / M experts a "model"
rank, one all-reduce of the layer output), its partial outputs summed
against the meshless forms, and the three forms on the card against the
CPU.  This file imports no JAX: the card's machine has none.
"""

from __future__ import annotations

import functools
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
from repro_torch.distributed import axis_rules, exchange
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
#: rank 0's collective bytes over the reference's, at most (and at least
#: the inverse)
COLLECTIVE_BAR = 1.5
#: cells held at the port's own collective bytes (within 5 %) instead: the
#: reference's ``moe_local`` form (GSPMD over its row-local scatters) moves
#: more than its plan, one all-reduce of the (B, S, D) output over "model"
#: (its docstring, ``src/repro/models/moe.py:80-92``).  Its partitioner
#: replicates the scatters' batch, which operand, updates and indices all
#: split over "data": a layer's prefill gathers the dispatch's updates
#: ``f32[2,128,64]`` (65,536 B) and indices ``s32[2,128,2]`` (2 x 2,048 B)
#: and the gates ``f32[2,64,4]`` (2,048 B) over "data", all-reduces the
#: whole batch's combine buffer ``f32[4,65,64]`` over "data" (66,560 B) and
#: over "model" (66,560 B, where the plan's is ``f32[2,64,64]``, 32,768 B)
#: and the slot weights ``f32[4,40]`` (640 B); training adds their
#: transposes (``f32[2,65,64]`` gathered, ``f32[4,128,64]`` all-reduced over
#: both axes).  Without them the reference counts its ``moe_shmap`` form's
#: bytes, the same plan written with ``shard_map``, and the port's
#: ``moe_local`` counts within 1.19x of those (ROADMAP queue 3 item 9).
OWN_BYTES = {("qwen3-moe-235b-a22b", "moe_local", "train"): 1_332_972.0,
             ("qwen3-moe-235b-a22b", "moe_local", "prefill"): 280_192.0}
FORMS = [("yi-9b", None), ("rwkv6-1.6b", None), ("qwen3-moe-235b-a22b", None),
         ("qwen3-moe-235b-a22b", "moe_local"), ("qwen3-moe-235b-a22b", "moe_shmap"),
         ("kimi-k2-1t-a32b", None), ("jamba-v0.1-52b", None), ("deepseek-7b", None),
         ("h2o-danube-3-4b", None), ("starcoder2-15b", None), ("musicgen-medium", None),
         ("qwen2-vl-72b", None)]
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


@functools.lru_cache(maxsize=None)
def _rank0(arch, form, kind):
    """Rank 0's counts of one cell (each cell counted once a process)."""
    mesh = make_fake_mesh(MESH, ("data", "model"))
    try:
        with axis_rules(mesh):
            return count_cell(make_cell(_config(arch, form),
                                        configs.ShapeSpec("s", S, B, kind)), mesh)
    finally:
        release_process_group()


CELLS = pytest.mark.parametrize("arch,form", FORMS,
                                ids=[f"{a}-{f or 'global'}" for a, f in FORMS])


@pytest.mark.parametrize("kind", KINDS)
@CELLS
def test_rank0_flops_match_reference_on_a_2x4_mesh(reference_counts, arch, form, kind):
    flops, _ = reference_counts[f"{arch}|{form}|{kind}"]
    rep = _rank0(arch, form, kind)
    ratio = rep.flops / flops
    print(f"{arch} {form or 'global'} {kind}: port {rep.flops:.6e} reference {flops:.6e} "
          f"ratio {ratio:.4f}")
    assert 1.0 / BAR[kind] <= ratio <= BAR[kind], ratio


@pytest.mark.parametrize("kind", KINDS)
@CELLS
def test_rank0_collective_bytes_match_reference_on_a_2x4_mesh(reference_counts, arch, form,
                                                              kind):
    _, coll = reference_counts[f"{arch}|{form}|{kind}"]
    rep = _rank0(arch, form, kind)
    ratio = rep.collective_bytes / coll
    print(f"{arch} {form or 'global'} {kind}: port {rep.collective_bytes:.0f} B "
          f"{rep.collective_by_op} reference {coll:.0f} B ratio {ratio:.3f}")
    own = OWN_BYTES.get((arch, form, kind))
    if own is not None:
        assert abs(rep.collective_bytes / own - 1.0) <= 0.05, rep.collective_bytes
    else:
        assert 1.0 / COLLECTIVE_BAR <= ratio <= COLLECTIVE_BAR, ratio
    if form is None and _config(arch, form).n_experts:
        # the global MoE form's dispatch and combine exchange by all-to-all
        assert rep.collective_by_op.get("all-to-all", 0.0) > 0, rep.collective_by_op


def test_exchange_is_counted_as_all_to_all():
    """An exchange written as the port writes it (``exchange`` in a
    ``local_apply`` body) reaches the counter as ``_c10d_functional``'s
    ``all_to_all_single``: booked as "all-to-all" with its operand's bytes,
    once forward and once for its transpose."""
    mesh = make_fake_mesh(MESH, ("data", "model"))
    counter = OpCounter()
    try:
        with axis_rules(mesh):
            send = counter.wrap(torch.empty((2, 8, 16), device="meta", requires_grad=True))
            got = exchange(send, ("data",))
            assert tuple(got.shape) == (2, 8, 16) and isinstance(got, type(send))
            assert counter.report().collective_by_op == {"all-to-all": 2 * 8 * 16 * 4.0}
            got.sum().backward()
    finally:
        release_process_group()
    rep = counter.report()
    assert rep.collective_counts == {"all-to-all": 2}
    assert rep.collective_by_op == {"all-to-all": 2 * 2 * 8 * 16 * 4.0}


_GLOO = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs
from repro_torch.distributed import axis_rules, placements_for
from repro_torch.models import attention as A
from repro_torch.models import moe as MoE

rank, path, shape = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
world = int(np.prod(shape))
dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=world)
errs = {}
try:
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=("pod", "data", "model")[-len(shape):])
    rng = np.random.default_rng(0)

    def arr(*shape):
        scale = np.sqrt(shape[-2]) if len(shape) > 1 else 1.0
        return torch.tensor(rng.standard_normal(shape) / scale, dtype=torch.float32)

    def sharded(tensors, axes):
        return [distribute_tensor(t.clone(), mesh, placements_for(a, tuple(t.shape)))
                for t, a in zip(tensors, axes)]

    def run(make, fwd, tensors, axes, probe):
        # outputs and the gradients of sum(out * probe) with respect to the
        # input and every parameter, plain and on the mesh
        x = tensors[0].clone().requires_grad_(True)
        mod = make(*[t.clone() for t in tensors[1:]]).requires_grad_(True)
        out = fwd(mod, x)
        (out * probe).sum().backward()
        want = [out, x.grad] + [p.grad for p in mod.parameters()]
        with axis_rules(mesh), implicit_replication():
            d = sharded(tensors, axes)
            xs = d[0].requires_grad_(True)
            mods = make(*d[1:]).requires_grad_(True)
            got = fwd(mods, xs)
            (got.full_tensor() * probe).sum().backward()
            got = [got, xs.grad] + [p.grad for p in mods.parameters()]
        return [float((g.full_tensor() - w).abs().max()) for g, w in zip(got, want)]

    B, S = 4, 16
    for form in (None, "moe_local", "moe_shmap"):
        cfg = configs.get_smoke_config("qwen3-moe-235b-a22b")
        cfg = configs.apply_variants(cfg, [form]) if form else cfg
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        ts = [arr(B, S, D), arr(D, E), arr(E, D, F), arr(E, D, F), arr(E, F, D)]
        ts[1][:, 0] += 0.5              # expert 0 overflows its capacity
        ax = [("batch", None, None), ("embed", None), ("experts", "embed", "ffn"),
              ("experts", "embed", "ffn"), ("experts", "ffn", "embed")]
        errs[f"moe_{form or 'global'}"] = run(
            MoE.MoE, lambda m, x: MoE.moe_forward(m, x, cfg), ts, ax, arr(B, S, D))

    cfg = configs.get_smoke_config("yi-9b")
    D, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(S)[None].expand(B, S)
    ts = [arr(B, S, D), arr(D, H * Dh), arr(D, Hk * Dh), arr(D, Hk * Dh), arr(H * Dh, D)]
    ax = [("batch", None, None), ("embed", "heads"), ("embed", "kv"), ("embed", "kv"),
          ("heads", "embed")]
    errs["attn"] = run(A.Attention, lambda m, x: A.attn_forward(m, x, cfg, pos)[0],
                       ts, ax, arr(B, S, D))

    # one decode step: its output and both caches written in place
    x1, caches = arr(B, 1, D), [arr(B, Hk, 24, Dh), arr(B, Hk, 24, Dh)]
    want = A.attn_decode(A.Attention(*ts[1:]), x1, cfg, *[c.clone() for c in caches], 17)
    cax = ("cache_batch", "cache_heads", "kv_seq", None)
    with axis_rules(mesh), implicit_replication(), torch.no_grad():
        d = sharded([x1] + ts[1:] + caches, [ax[0]] + ax[1:] + [cax, cax])
        got = A.attn_decode(A.Attention(*d[1:5]), d[0], cfg, d[5], d[6], 17)
    errs["decode"] = [float((g.full_tensor() - w).abs().max()) for g, w in zip(got, want)]
finally:
    dist.destroy_process_group()
print("ERRS", json.dumps(errs))
"""


@pytest.mark.parametrize("shape", [MESH, (2, 2), (2, 2, 2)], ids=["2x4", "2x2", "2x2x2"])
def test_mesh_forms_match_the_plain_forms_on_a_gloo_mesh(tmp_path, shape):
    """The dry-run's mesh paths computed for real: one CPU process a rank of
    a gloo mesh ((2, 4) and (2, 2) data x model, (2, 2, 2) pod x data x
    model) runs the three MoE forms (the global one with an expert over its
    capacity), the attention forward and one decode step on DTensors, and
    each rank holds the outputs and the gradients of the input and every
    parameter (the caches, in a decode step) against the plain forms' at
    1e-5: the all-to-all exchanges (over two axes on the three-axis mesh),
    the per-query-head kv heads, both forms of the decode attention (the
    kv heads divide "model" on (2, 2) and (2, 2, 2)) and the partial-sum
    gradients of ``local_apply``."""
    n = int(np.prod(shape))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), str(tmp_path / "pg"),
                               json.dumps(list(shape))], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        errs = json.loads(out.split("ERRS", 1)[1])
        assert set(errs) == {"moe_global", "moe_moe_local", "moe_moe_shmap", "attn", "decode"}
        for name, e in errs.items():
            assert max(e) <= 1e-5, (name, e)


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
@pytest.mark.parametrize("form", [None, "moe_local", "moe_shmap"])
def test_moe_forms_on_the_card_match_cpu(cuda, form):
    """qwen3-moe's smoke model in ``form`` (``None``: the global form): the
    forward's logits on the card against the CPU's at 1e-4."""
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
