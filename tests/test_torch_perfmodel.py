"""The port's perf model against the reference's: sharding rules, roofline,
BottleMod step model and per-device op counts.

Inputs are the ten architectures' own configurations and the reference's
own test cases.  Bars: the sharding specs equal, leaf for leaf; the
roofline terms and step-model predictions at rtol 1e-9 under the
reference's TPU v5e constants (the same float arithmetic, so only the
last bits may differ); per-device FLOPs on a 1×1 mesh within 2 % of the
reference's HLO dot count on its host mesh (measured: equal for every
yi-9b, qwen3-moe and kimi-k2 cell, rwkv6's and jamba's prefill and decode,
0.9928 for rwkv6's train step, whose reference einsum counts a batch-only
contraction as a dot, and 1.0031 for jamba's).  On a (2, 4) mesh rank 0 of
yi-9b counts at most 1.20x (train) and 1.143x (prefill) the reference's
per-device FLOPs.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed.sharding import AxisRules as JaxAxisRules
from repro.launch.specs import lower_cell as jax_lower_cell
from repro.launch.specs import make_cell as jax_make_cell
from repro.models.common import param_axes as jax_param_axes
from repro.models.common import param_shapes_concrete as jax_param_shapes
from repro.models.transformer import cache_axes as jax_cache_axes
from repro.models.transformer import init_cache as jax_init_cache
from repro.perfmodel import roofline as jroof
from repro.perfmodel import stepmodel as jstep
from repro.perfmodel.hlo import analyze_hlo
from repro_torch import configs
from repro_torch.distributed import DEFAULT_RULES, AxisRules, axis_rules, constrain
from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh, release_process_group
from repro_torch.launch.specs import (cache_specs, count_cell, make_cell,
                                      opt_specs_tree, param_specs_tree)
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig
from repro_torch.perfmodel import roofline, stepmodel
from repro_torch.perfmodel.opcount import OpCounter

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 0.02
V5E = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "LINK_BW": 50e9, "HBM_BYTES": 16 * 2 ** 30}


@pytest.fixture(autouse=True)
def no_process_group_left():
    """Every test leaves ``torch.distributed`` as it found it: uninitialised."""
    assert not dist.is_initialized()
    yield
    release_process_group()


class _MeshShape:
    """The reference's ``AxisRules.spec_for`` reads only ``mesh.shape``; the
    port's also reads the axis names.  A stand-in with no devices."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _leaves(axes, shapes, prefix=""):
    """(path, axes, shape) of a dict tree of axes beside one of shapes."""
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(axes[k], shapes[k], f"{prefix}.{k}")
    else:
        yield prefix, tuple(axes), tuple(shapes.shape)


# ----------------------------------------------------------------- sharding --

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.list_archs())
def test_spec_for_matches_reference(arch, mesh):
    """Every parameter, cache and optimizer-state leaf of the full-size
    configuration resolves to the reference's spec on the 256- and
    512-card mesh shapes."""
    shape = MESHES[mesh]
    ours, ref = AxisRules(_MeshShape(shape)), JaxAxisRules(_MeshShape(shape))
    cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
    n = 0
    pshape, paxes = param_specs_tree(cfg)
    jp = jax_param_shapes(jcfg)
    assert paxes == jax_param_axes(jcfg)
    for path, ax, shp in _leaves(paxes, pshape):
        want = tuple(ref.spec_for(ax, shp))
        assert ours.spec_for(ax, shp) == want, (path, ax, shp)
        assert tuple(_find(jp, path).shape) == shp, path
        n += 1
    cshape, caxes = cache_specs(cfg, configs.SHAPES["decode_32k"])
    assert caxes == jax_cache_axes(jcfg)
    jc = jax.eval_shape(lambda: jax_init_cache(jcfg, 128, 32_768))
    for path, ax, shp in _leaves(caxes, cshape):
        assert tuple(_find(jc, path).shape) == shp, path
        assert ours.spec_for(ax, shp) == tuple(ref.spec_for(ax, shp)), (path, ax, shp)
        n += 1
    # the port keeps one moment per layer (its stacked leaf's slice, the axes
    # less "layers"): each resolves as the reference resolves those axes
    oshape, oaxes = opt_specs_tree(cfg, OptConfig())
    for key in ("m", "v"):
        for t, ax in zip(oshape[key], oaxes[key], strict=True):
            shp = tuple(t.shape)
            assert ours.spec_for(ax, shp) == tuple(ref.spec_for(ax, shp)), (key, ax, shp)
            n += 1
    assert oaxes["step"] == () and ours.spec_for((), ()) == tuple(ref.spec_for((), ()))
    assert n > 0


def _find(tree, path):
    for k in path.strip(".").split("."):
        tree = tree[k]
    return tree


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    rules = AxisRules(_MeshShape(MESHES["multi"]))
    # batch over (pod, data), heads over model
    assert rules.spec_for(("batch", "seq", "heads"), (64, 8, 32)) == (("pod", "data"), None, "model")
    assert rules.placements_for(("batch", "seq", "heads"), (64, 8, 32)) == (
        Shard(0), Shard(0), Shard(2))
    # 24 heads do not split 16 ways: dropped; 2 rows do not split over pod x data
    assert rules.placements_for(("batch", "heads"), (2, 24)) == (
        Shard(0), Replicate(), Replicate())
    assert rules.spec_for(("nonexistent",), (8,)) == ()


def test_tree_shardings_and_collective_stats():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import tree_shardings
    from repro_torch.perfmodel.opcount import OpReport, collective_stats

    axes = {"w": ("embed", "ffn"), "b": [("ffn",), ()]}
    shapes = {"w": torch.empty((32, 64), device="meta"),
              "b": [torch.empty((64,), device="meta"), torch.empty((), device="meta")]}
    with axis_rules(_MeshShape({"data": 4, "model": 8})):
        got = tree_shardings(axes, shapes)
    assert got == {"w": (Shard(0), Shard(1)), "b": [(Replicate(), Shard(0)),
                                                     (Replicate(), Replicate())]}
    with pytest.raises(RuntimeError, match="axis_rules"):
        tree_shardings(axes, shapes)
    rep = OpReport(collective_bytes=12.0, collective_by_op={"all-gather": 12.0},
                   collective_counts={"all-gather": 1})
    assert collective_stats(rep).as_dict() == {"total_bytes": 12.0,
                                               "by_op": {"all-gather": 12.0},
                                               "counts": {"all-gather": 1}}


def test_default_rules_cover_all_logical_axes():
    from repro_torch.models.common import param_specs
    for arch in configs.list_archs():
        for spec in param_specs(configs.get_config(arch)).values():
            for ax in spec.axes:
                assert ax is None or ax in DEFAULT_RULES, (arch, ax)


def test_constrain_is_a_noop_on_plain_tensors():
    x = torch.ones((4, 4))
    assert constrain(x, ("batch", None)) is x
    with axis_rules(make_host_mesh()):
        assert constrain(x, ("batch", None)) is x


def test_constrain_redistributes_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_fake_mesh((2, 4), ("data", "model"))
    x = DTensor.from_local(torch.empty((8, 16), device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with axis_rules(mesh):
        y = constrain(x, ("batch", "heads"))
    assert y.placements == (Shard(0), Shard(1)) and y.shape == x.shape


# ----------------------------------------------------------------- roofline --

def _v5e(monkeypatch):
    for k, v in V5E.items():
        monkeypatch.setattr(roofline, k, v)
    return dict(peak_flops=V5E["PEAK_FLOPS"], hbm_bw=V5E["HBM_BW"], ici_bw=V5E["LINK_BW"])


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=1e-9, abs=0.0)


@pytest.mark.parametrize("arch,shape", [("yi-9b", "train_4k"), ("kimi-k2-1t-a32b", "prefill_32k"),
                                        ("rwkv6-1.6b", "decode_32k")])
def test_roofline_matches_reference_under_its_constants(monkeypatch, arch, shape):
    _v5e(monkeypatch)
    kw = dict(n_chips=256, flops_per_device=1e14, bytes_per_device=1e12,
              collective_bytes_per_device=1e11)
    got = roofline.roofline_terms(cfg=configs.get_config(arch), shape=configs.SHAPES[shape], **kw)
    want = jroof.roofline_terms(cfg=jax_get_config(arch), shape=JSHAPES[shape], **kw)
    _close(got, want)


def test_h100_constants():
    """One H100 SXM5 80GB: bf16 dense, HBM3, InfiniBand NDR a card."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_BYTES) == (989.4e12, 3.35e12, 50e9, 80e9)
    assert stepmodel.StepModelInputs(1, 1, 1).peak_flops == 989.4e12


STEP_CASES = {
    "roofline_equivalence": dict(flops_per_step=1.97e13, hbm_bytes_per_step=8.19e10,
                                 coll_bytes_per_step=5e11, n_steps=50,
                                 data_rate_steps_per_s=1e6),
    "data_starvation": dict(flops_per_step=1.97e12, hbm_bytes_per_step=8.19e9,
                            coll_bytes_per_step=5e9, n_steps=50,
                            data_rate_steps_per_s=0.5),
    "checkpoint_stall": dict(flops_per_step=1.97e12, hbm_bytes_per_step=8.19e9,
                             coll_bytes_per_step=5e9, n_steps=40,
                             data_rate_steps_per_s=1e6, ckpt_every=10,
                             ckpt_bytes=100e9, ckpt_bw=1e9),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_stepmodel_matches_reference(monkeypatch, case):
    """The reference's three step-model cases (``tests/test_perfmodel.py``):
    prediction, bottleneck shares and what-if gains equal the reference's."""
    hw = _v5e(monkeypatch)
    got = stepmodel.predict(stepmodel.StepModelInputs(**STEP_CASES[case], **hw))
    want = jstep.predict(jstep.StepModelInputs(**STEP_CASES[case]))
    _close({"makespan": got.makespan_s, "step": got.step_time_s},
           {"makespan": want.makespan_s, "step": want.step_time_s})
    assert got.dominant() == want.dominant()
    assert len(got.bottleneck_shares) == len(want.bottleneck_shares)
    for a, b in zip(got.bottleneck_shares, want.bottleneck_shares):
        assert (a.process, a.kind, a.name) == (b.process, b.kind, b.name)
        _close({"s": a.seconds, "f": a.fraction}, {"s": b.seconds, "f": b.fraction})
    assert [g[:2] for g in got.gains] == [g[:2] for g in want.gains]
    for a, b in zip(got.gains, want.gains):
        _close({"new": a[2], "gain": a[3]}, {"new": b[2], "gain": b[3]})
    if case == "roofline_equivalence":
        assert got.dominant() == "ici_bytes" and got.step_time_s == pytest.approx(10.0, rel=0.01)
    if case == "checkpoint_stall":
        res = got.workflow.analyze()
        assert res.finish("checkpoint") > res.finish("train_step")


# ---------------------------------------------------------------- op counts --

def test_counter_counts_products_and_skips_views():
    counter = OpCounter()
    a = counter.wrap(torch.empty((64, 32), device="meta"))
    b = counter.wrap(torch.empty((32, 48), device="meta"))
    c = (a @ b).t().reshape(-1)
    assert c.shape == (48 * 64,)
    rep = counter.report()
    assert rep.flops == 2 * 64 * 32 * 48
    # the product reads both operands and writes its result; the transpose
    # is a view, free; reshaping it copies
    assert rep.bytes_by_op["mm"] == 4 * (64 * 32 + 32 * 48 + 64 * 48)
    assert "t" not in rep.bytes_by_op and rep.collective_bytes == 0.0


def test_counter_sees_the_per_device_program():
    """A sharded product on a (2, 4) mesh: rank 0 all-gathers its shard of b
    and multiplies its local blocks; the collective's operand is counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_fake_mesh((2, 4), ("data", "model"))
    counter = OpCounter()

    def dt(shape, pl):
        local = list(shape)
        for size, p in zip(mesh.shape, pl):
            if isinstance(p, Shard):
                local[p.dim] //= size
        return DTensor.from_local(counter.wrap(torch.empty(local, device="meta")), mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    a = dt((64, 128), [Shard(0), Replicate()])
    b = dt((128, 256), [Shard(0), Shard(1)])
    c = a @ b
    rep = counter.report()
    assert c.shape == (64, 256)
    assert rep.flops == 2 * 32 * 128 * 64            # (32, 128) @ (128, 64) on rank 0
    assert rep.collective_by_op == {"all-gather": 4 * 64 * 64}
    assert rep.collective_counts == {"all-gather": 1}


def _jax_smoke_flops(arch, S, B, kind, mesh_shape=(1, 1)):
    """The reference's per-device dot FLOPs of a smoke cell on an Auto-axis
    host mesh (``jax.make_mesh`` gives Explicit axes on this JAX, which its
    ``with_sharding_constraint`` refuses)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(mesh_shape), ("data", "model"))
    from repro.distributed.sharding import axis_rules as jax_axis_rules
    with mesh, jax_axis_rules(mesh):
        cell = jax_make_cell(jax_smoke(arch), JShapeSpec("s", S, B, kind))
        return analyze_hlo(jax_lower_cell(cell).compile().as_text()).flops


def _port_flops(arch, S, B, kind, mesh=None):
    mesh = mesh or make_host_mesh()
    with axis_rules(mesh):
        return count_cell(make_cell(configs.get_smoke_config(arch),
                                    configs.ShapeSpec("s", S, B, kind)), mesh).flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-1.6b", "qwen3-moe-235b-a22b",
                                  "kimi-k2-1t-a32b", "jamba-v0.1-52b"])
def test_per_device_flops_match_reference(arch, kind):
    got, want = _port_flops(arch, 64, 4, kind), _jax_smoke_flops(arch, 64, 4, kind)
    ratio = got / want
    print(f"{arch} {kind}: port {got:.6e} reference {want:.6e} ratio {ratio:.6f}")
    assert abs(ratio - 1.0) <= FLOPS_RTOL, ratio


_JAX_2X4 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import ShapeSpec, get_smoke_config
from repro.distributed.sharding import axis_rules
from repro.launch.specs import lower_cell, make_cell
from repro.perfmodel.hlo import analyze_hlo
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {}
for kind in ("train", "prefill"):
    with mesh, axis_rules(mesh):
        out[kind] = analyze_hlo(lower_cell(make_cell(get_smoke_config("yi-9b"),
                                ShapeSpec("s", 64, 4, kind))).compile().as_text()).flops
print("FLOPS", __import__("json").dumps(out))
"""


#: rank 0's FLOPs over the reference's per-device FLOPs on the (2, 4) mesh,
#: at most (measured with torch 2.13: 0.9412 and 0.9286; 1.1765 and 1.1429
#: while the kv projections, whose weights the rules replicate over "model",
#: ran whole on every rank: GSPMD splits them by kv head, the port by column).
MAX_2X4_RATIO = {"train": 1.20, "prefill": 1.143}


def test_2x4_mesh_flops_lie_between_global_over_8_and_global():
    """yi-9b smoke on a (2, 4) data x model mesh: rank 0's FLOPs lie between
    the 1x1 count / 8 and the 1x1 count, and within MAX_2X4_RATIO of the
    reference's per-device count on the same mesh shape (eight fake CPU
    devices, in a child process).  The train bar holds ``constrain``'s
    gradient pin: without it the backward's products ran replicated over
    the model axis (1.529x)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_2X4], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.split("FLOPS", 1)[1])
    for kind in ("train", "prefill"):
        whole = _port_flops("yi-9b", 64, 4, kind)
        mesh = make_fake_mesh((2, 4), ("data", "model"))
        try:
            dev = _port_flops("yi-9b", 64, 4, kind, mesh)
        finally:
            release_process_group()
        print(f"yi-9b {kind} (2, 4): port {dev:.6e} of {whole:.6e} "
              f"({dev / whole:.4f} of the whole); reference {ref[kind]:.6e}; "
              f"port / reference {dev / ref[kind]:.4f}")
        assert whole / 8 <= dev <= whole
        assert dev / ref[kind] <= MAX_2X4_RATIO[kind], (kind, dev / ref[kind])


def test_grad_accumulation_counts_the_same_products():
    """Two microbatches of half the batch: the same product FLOPs as one
    step on the whole batch (every product is linear in the rows)."""
    from repro_torch.launch.specs import make_train_cell

    cfg, shape = configs.get_smoke_config("yi-9b"), configs.ShapeSpec("t", 64, 4, "train")
    mesh = make_host_mesh()
    with axis_rules(mesh):
        one = count_cell(make_train_cell(cfg, shape), mesh)
        two = count_cell(make_train_cell(cfg, shape, grad_accum=2), mesh)
    assert two.flops == one.flops and two.n_ops > one.n_ops


def test_meta_cells_leave_no_process_group():
    """Counting on the host mesh needs no process group at all."""
    _port_flops("rwkv6-1.6b", 64, 2, "decode")
    assert not dist.is_initialized()


def test_cache_axes_match_init_cache():
    for arch in configs.list_archs():
        cfg = configs.get_smoke_config(arch)
        cache, axes = T.init_cache(cfg, 2, 16, device="meta"), T.cache_axes(cfg)
        for path, ax, shp in _leaves(axes, cache):
            assert len(ax) == len(shp), (arch, path)


def test_model_flops_counts_active_params():
    cfg = configs.get_config("qwen3-moe-235b-a22b")
    shape = configs.SHAPES["train_4k"]
    assert roofline.model_flops(cfg, shape) == 6.0 * cfg.active_params() * 256 * 4096
    assert roofline.model_flops(cfg, configs.SHAPES["decode_32k"]) == 2.0 * cfg.active_params() * 128
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config("qwen3-moe-235b-a22b"))
