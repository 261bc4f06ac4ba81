"""The attention of deepseek-7b, h2o-danube-3-4b, starcoder2-15b,
musicgen-medium and qwen2-vl-72b computed on a real (2, 4) gloo mesh
against the plain forms.

Their smoke configs take the dry-run's mesh paths that no other family
takes: deepseek-7b's and musicgen-medium's 4 kv heads divide the "model"
axis of 4, so each rank projects only its own kv heads' columns;
starcoder2's 6 query heads do not divide it, so q, k and v stay split by
column and each rank gathers the halo of the heads its columns overlap
(``gather_columns``, an all-to-all) and keeps its own columns of their
output; h2o-danube adds a window that bites (32 of S = 40) and qwen2-vl
M-RoPE over distinct (t, h, w) streams.  Each rank holds the forward's
output and the gradients of the input and every projection, and one decode
step's output and both caches, against the plain forms at 1e-5.  One CPU
process a rank; this file imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["deepseek-7b", "h2o-danube-3-4b", "starcoder2-15b", "musicgen-medium",
            "qwen2-vl-72b"]
TOL = 1e-5

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
from mrope_image_positions import mrope_positions

rank, path, archs = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=8)
errs = {}
try:
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    B, S = 4, 40
    for arch in archs:
        cfg = configs.get_smoke_config(arch)
        D, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        rng = np.random.default_rng(0)

        def arr(*shape):
            scale = np.sqrt(shape[-2]) if len(shape) > 1 else 1.0
            return torch.tensor(rng.standard_normal(shape) / scale, dtype=torch.float32)

        pos = torch.arange(S)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            # text, a 4 x 6 patch grid whose h and w streams differ, text
            pos = mrope_positions(B, S, 8, (4, 6))
        ts = [arr(B, S, D), arr(D, H * Dh), arr(D, Hk * Dh), arr(D, Hk * Dh), arr(H * Dh, D)]
        ax = [("batch", None, None), ("embed", "heads"), ("embed", "kv"), ("embed", "kv"),
              ("heads", "embed")]
        probe = arr(B, S, D)

        def sharded(tensors, axes):
            return [distribute_tensor(t.clone(), mesh, placements_for(a, tuple(t.shape)))
                    for t, a in zip(tensors, axes)]

        x = ts[0].clone().requires_grad_(True)
        mod = A.Attention(*[t.clone() for t in ts[1:]]).requires_grad_(True)
        out = A.attn_forward(mod, x, cfg, pos)[0]
        (out * probe).sum().backward()
        want = [out, x.grad] + [p.grad for p in mod.parameters()]
        with axis_rules(mesh), implicit_replication():
            d = sharded(ts, ax)
            xs = d[0].requires_grad_(True)
            mods = A.Attention(*d[1:]).requires_grad_(True)
            got = A.attn_forward(mods, xs, cfg, pos)[0]
            (got.full_tensor() * probe).sum().backward()
            got = [got, xs.grad] + [p.grad for p in mods.parameters()]
        errs[f"{arch}|forward"] = [float((g.full_tensor() - w).abs().max())
                                   for g, w in zip(got, want)]

        # one decode step on a ring of 24 past h2o-danube's first wrap
        x1, caches = arr(B, 1, D), [arr(B, Hk, 24, Dh), arr(B, Hk, 24, Dh)]
        at = 29 if cfg.window else 17
        with torch.no_grad():
            want = A.attn_decode(A.Attention(*ts[1:]), x1, cfg, *[c.clone() for c in caches], at)
            cax = ("cache_batch", "cache_heads", "kv_seq", None)
            with axis_rules(mesh), implicit_replication():
                d = sharded([x1] + ts[1:] + caches, [ax[0]] + ax[1:] + [cax, cax])
                got = A.attn_decode(A.Attention(*d[1:5]), d[0], cfg, d[5], d[6], at)
        errs[f"{arch}|decode"] = [float((g.full_tensor() - w).abs().max())
                                  for g, w in zip(got, want)]
finally:
    dist.destroy_process_group()
print("ERRS", json.dumps(errs))
"""


@pytest.fixture(scope="module")
def mesh_errors(tmp_path_factory):
    """Every rank's errors of the five families, from one gloo run of 8
    processes."""
    path = tmp_path_factory.mktemp("pg") / "pg"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), str(path),
                               json.dumps(FAMILIES)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(8)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    errs = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        errs.append(json.loads(out.split("ERRS", 1)[1]))
    return errs


@pytest.mark.parametrize("step", ["forward", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_attention_on_a_2x4_gloo_mesh_matches_the_plain_form(mesh_errors, arch, step):
    assert not dist.is_initialized()
    for rank, errs in enumerate(mesh_errors):
        e = errs[f"{arch}|{step}"]
        assert max(e) <= TOL, (rank, e)
