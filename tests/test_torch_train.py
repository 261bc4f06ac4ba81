"""The torch port's training path against the reference's on the CPU: the
data pipeline, AdamW, the train step, remat, checkpoints in both
directions, resume and the launcher.

Reference parameters cross to the port with ``params_from_arrays``; inputs
come from numpy seeds.  Bars: ``batch_at`` bit for bit; AdamW at rtol
1e-6; three train steps at rtol 1e-5 on the losses, 1e-4 on the gradient
norms and relative L2 1e-3 on every leaf's update; remat, checkpoints and
resume bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCkptConfig
from repro.checkpoint import CheckpointManager as JCkptManager
from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.models.common import init_params as jax_init_params
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_arrays, params_to_arrays
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.runtime.trainer import Trainer, TrainerConfig, data_config_for

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-3


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out["/".join((*prefix, k))] = v
    return out


def _bits(a):
    """A numpy view of an array's bits: bf16 (ml_dtypes) as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                             device="cpu")


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("arch", ["yi-9b", "musicgen-medium", "qwen2-vl-72b"])
def test_batch_at_matches_reference(arch):
    """Tokens, audio frames with per-codebook labels, M-RoPE positions: the
    same arrays, bit for bit, also on the second of two hosts."""
    cfg = configs.get_smoke_config(arch)
    dc = data_config_for(cfg, 48, 4)
    assert (dc.n_codebooks > 0) == (arch == "musicgen-medium")
    assert dc.mrope == (arch == "qwen2-vl-72b")
    for over in ({}, {"n_hosts": 2, "host_id": 1, "seed": 5}):
        mine = SyntheticTokenPipeline(dataclasses.replace(dc, **over))
        ref = JPipeline(JDataConfig(**dataclasses.asdict(dataclasses.replace(dc, **over))))
        for step in (0, 7):
            got, want = mine.batch_at(step), ref.batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pipeline_prefetch_resumes_midstream():
    p = SyntheticTokenPipeline(DataConfig(vocab_size=500, seq_len=16,
                                          global_batch=2)).start(step=5)
    try:
        step, batch = p.get(timeout=30)
    finally:
        p.stop()
    assert step == 5
    np.testing.assert_array_equal(batch["tokens"], p.batch_at(5)["tokens"])


# ----------------------------------------------------------------- adamw ----
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    """Three steps on a float32 and a bf16 parameter (global-norm clip
    engaged, warmup, weight decay): parameters, moments and metrics at
    rtol 1e-6, with an atol of 1e-6 times the leaf's largest magnitude.
    XLA and torch sum the squares of a leaf in another order, so the norm,
    and with it every clipped gradient, may differ in its last bit; a
    moment's element that is a difference of near-equal terms turns that
    bit into a larger relative error than its leaf's."""
    rng = np.random.default_rng(0)
    shapes = {"a": ((5, 7), np.float32), "b": ((3, 4), jnp.bfloat16), "c": ((11,), np.float32)}
    p0 = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(dt)
          for k, (s, dt) in shapes.items()}
    jcfg = JOptConfig(moment_dtype=moment_dtype, warmup_steps=2, grad_clip=0.5)
    cfg = OptConfig(**dataclasses.asdict(jcfg))
    keys = sorted(shapes)
    jp, jst = p0, jax_adamw_init(p0, jcfg)
    params = [torch.tensor(_bits(p0[k])).view(torch.bfloat16) if shapes[k][1] is jnp.bfloat16
              else torch.tensor(np.asarray(p0[k])) for k in keys]
    st = adamw_init(params, cfg)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    assert all(m.dtype == mdt for m in st["m"] + st["v"])
    for _step in range(3):
        g = {k: rng.standard_normal(shapes[k][0]).astype(np.float32) for k in keys}
        jp, jst, jm = jax_adamw_update({k: jnp.asarray(g[k]).astype(shapes[k][1]) for k in keys},
                                       jst, jp, jcfg)
        grads = [torch.from_numpy(g[k]).to(p.dtype) for k, p in zip(keys, params)]
        _, st, m = adamw_update(grads, st, params, cfg)
        assert int(st["step"]) == int(jst["step"])
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-6)
        for j, k in enumerate(keys):
            for got, want in ((params[j], jp[k]), (st["m"][j], jst["m"][k]),
                              (st["v"][j], jst["v"][k])):
                assert got.dtype == (torch.bfloat16 if np.asarray(want).dtype.name
                                     == "bfloat16" else torch.float32)
                want = np.asarray(want, np.float32)
                np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_adamw_converges_on_a_quadratic():
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    w = torch.tensor([5.0, -3.0])
    st = adamw_init([w], cfg)
    for _ in range(200):
        adamw_update([2 * w], st, [w], cfg)
    assert float(w.abs().max()) < 0.1 and int(st["step"]) == 200


# ------------------------------------------------------------ train step ----
@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-1.6b"])
def test_train_steps_match_reference(arch, tmp_path):
    """Three of the port's eager steps against three of the reference's
    jitted steps on the same batches, from the same parameters: each loss at
    rtol 1e-5, each gradient norm at rtol 1e-4 (the gradient bar of
    tests/test_torch_train_grads.py), and each leaf's update over the three
    steps at relative L2 1e-3: AdamW divides each element by the root of its
    second moment, so an element's update carries its own gradient's
    relative error, which for small elements exceeds its leaf's.  A warmup
    of one step makes every step move the parameters at the full rate."""
    jcfg, jp, cfg, model = _pair(arch)
    opt = OptConfig(warmup_steps=1)
    jtr = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "ref")),
                   opt_cfg=JOptConfig(**dataclasses.asdict(opt)))
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "port")), opt_cfg=opt,
                 device="cpu")
    model.requires_grad_(True)
    st = adamw_init(list(model.parameters()), opt)
    jst = jax_adamw_init(jp, jtr.opt_cfg)
    pipe = SyntheticTokenPipeline(data_config_for(cfg, 40, 2))
    before = _flat(params_to_arrays(model))
    for step in range(3):
        b = pipe.batch_at(step)
        jp, jst, jm = jtr._step_fn(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        m = tr.train_step(model, st, tr.device_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_REL_L2)
    got = _flat(params_to_arrays(model))
    want = _flat(jax.tree.map(np.asarray, jp))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel_l2(got[k] - before[k], want[k] - before[k]) <= UPDATE_REL_L2, k


@pytest.mark.parametrize("arch,over", [("yi-9b", {}), ("rwkv6-1.6b", {}),
                                       ("qwen3-moe-235b-a22b", {"moe_every": 2})])
def test_remat_changes_no_number(arch, over):
    """The loss and every gradient with ``cfg.remat`` on and off, bit for
    bit (qwen3-moe with MoE on every other layer: one group of 2 layers, a
    dense and an MoE one, under one checkpoint)."""
    _j, _jp, cfg, _m = _pair(arch, **over)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokenPipeline(data_config_for(cfg, 40, 2)).batch_at(0).items()}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = _pair(arch, **over)[3]
        model.cfg = c
        model.requires_grad_(True)
        loss = T.loss_fn(model, c, batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ----------------------------------------------------------- checkpoints ----
def _bf16_pair():
    """yi-9b smoke in bf16: the uint16 path of the checkpoint format."""
    return _pair("yi-9b", dtype="bfloat16")


def test_params_to_arrays_inverts_params_from_arrays():
    for arch, over in (("yi-9b", {"dtype": "bfloat16"}), ("jamba-v0.1-52b", {}),
                       ("musicgen-medium", {})):
        _j, jp, _c, model = _pair(arch, **over)
        got, want = _flat(params_to_arrays(model)), _flat(jax.tree.map(np.asarray, jp))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], _bits(want[k]), err_msg=k)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the reference's CheckpointManager wrote (bf16 params,
    float32 moments after one reference step) restored by the port's
    Trainer, bit for bit."""
    jcfg, jp, cfg, _m = _bf16_pair()
    jopt = JOptConfig()
    jst = jax_adamw_init(jp, jopt)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, p.dtype), jp)
    jp, jst, _ = jax_adamw_update(grads, jst, jp, jopt)
    mgr = JCkptManager(JCkptConfig(directory=str(tmp_path)))
    mgr.save(7, {"params": jp, "opt": jst})
    mgr.wait()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    assert tr.ckpt.latest_step() == 7
    model, st = tr.init_state()
    tr.restore(7, model, st)
    got = _flat(tr.state_tree(model, st))
    want = _flat(jax.tree.map(np.asarray, {"params": jp, "opt": jst}))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == _bits(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], _bits(want[k]), err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A checkpoint the port's Trainer wrote after one step, restored by the
    reference's ``CheckpointManager.restore(like=...)``, bit for bit."""
    jcfg, jp, cfg, _m = _bf16_pair()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    model, st = tr.init_state()
    batch = SyntheticTokenPipeline(data_config_for(cfg, 40, 2)).batch_at(0)
    tr.train_step(model, st, tr.device_batch(batch))
    tr.save(1, model, st)
    tr.ckpt.wait()
    like = {"params": jp, "opt": jax_adamw_init(jp, JOptConfig())}
    out = JCkptManager(JCkptConfig(directory=str(tmp_path))).restore(1, like)
    got = _flat(jax.tree.map(_bits, out))
    want = _flat(tr.state_tree(model, st))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(out["opt"]["step"]) == 1


def test_checkpoint_retention_and_tmp_ignored(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), keep=2,
                                             async_save=False))
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for s in (10, 20, 30):
        mgr.save(s, {"a": tree["a"] + s, "b": tree["b"]})
    (tmp_path / "step_40.tmp").mkdir()
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    out = mgr.restore(30, tree, device="cpu")
    assert torch.equal(out["a"], tree["a"] + 30)
    assert out["b"]["c"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(30, {"a": torch.zeros(3, 2), "b": tree["b"]}, device="cpu")


# ---------------------------------------------------------------- resume ----
def test_stopped_run_resumes_bit_for_bit(tmp_path):
    """A run stopped at step 2 and started again to step 4 ends in the state
    of an uninterrupted run to step 4, and steps 3 and 4 give the same
    losses, bit for bit."""
    cfg = configs.get_smoke_config("yi-9b")
    dc = data_config_for(cfg, 40, 2)

    def run(d, steps):
        tr = Trainer(cfg, TrainerConfig(steps=steps, ckpt_every=0, ckpt_dir=str(d)),
                     data_cfg=dc, device="cpu")
        return tr, tr.run()

    whole, s_whole = run(tmp_path / "whole", 4)
    _, s_first = run(tmp_path / "cut", 2)
    cut, s_rest = run(tmp_path / "cut", 4)
    assert s_first["final_step"] == 2 and s_rest["final_step"] == 4
    assert s_first["losses"] + s_rest["losses"] == s_whole["losses"]
    got = _flat(cut.state_tree(cut.model, cut.opt_state))
    want = _flat(whole.state_tree(whole.model, whole.opt_state))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_launcher_on_the_cpu(tmp_path):
    out = train.main(["--device", "cpu", "--arch", "yi-9b", "--smoke", "--steps", "3",
                      "--seq", "40", "--batch", "2", "--ckpt-every", "2",
                      "--ckpt-dir", str(tmp_path), "--moment-dtype", "bfloat16"])
    assert out["arch"] == "yi-9b-smoke" and out["device"] == "cpu"
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert {"loss_first", "loss_last", "stragglers", "wall_s"} <= out.keys()
    assert all(np.isfinite(out["losses"]))
    assert CheckpointManager(CheckpointConfig(str(tmp_path))).steps() == [2, 3]
    again = train.main(["--device", "cpu", "--arch", "yi-9b", "--smoke", "--steps", "3",
                        "--ckpt-dir", str(tmp_path)])
    assert again["final_step"] == 3 and again["losses"] == []
    assert train.preset_100m().n_params() == pytest.approx(1e8, rel=0.5)
