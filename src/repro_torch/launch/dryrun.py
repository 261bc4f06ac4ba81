"""Dry-run: count every (arch × shape × mesh) cell's per-device step on a
fake mesh of 256 or 512 cards, and write one JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-1.6b \\
        --shape decode_32k --mesh single

The port's twin of the reference's ``launch/dryrun.py``.  The reference
lowers and compiles each cell for 512 fake CPU devices and walks the
compiled per-device HLO; here the step runs once, eagerly, on ``DTensor``s
over a ``DeviceMesh`` of a fake process group (set up in this process by
:func:`run_cell` through :func:`repro_torch.launch.mesh.make_production_mesh`,
and destroyed before it returns), their local shards ``meta`` tensors that
count what rank 0 executes (:mod:`repro_torch.perfmodel.opcount`).  No
tensor is made and no device is touched.

Each record has the reference's keys: ``per_device`` (flops, bytes,
collective bytes), ``roofline`` (H100 constants), ``flash_estimate`` (the
score chain's traffic replaced by the flash kernel's q/k/v/o streams, the
reference's formula), ``collectives`` and ``status``.  XLA's
``memory_analysis`` has no counterpart on meta tensors: ``memory`` gives
the per-device bytes of the parameters, the optimizer state, the batch and
the decode cache instead.  A cell that fails records ``status: "error"``
with its traceback and the run exits 1, the reference's contract.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from ..configs import SHAPES, applicable_shapes, apply_variants, get_config, list_archs
from ..distributed import axis_rules
from ..optim import OptConfig
from ..perfmodel.roofline import roofline_terms
from .mesh import make_production_mesh, release_process_group
from .specs import (batch_specs, cache_specs, count_cell, local_bytes, make_cell,
                    make_train_cell, opt_specs_tree, param_specs_tree)

__all__ = ["RESULTS", "flash_estimate", "main", "run_cell", "track_sizes"]

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def track_sizes(cfg, shape, mesh_shape: dict) -> frozenset:
    """Byte sizes of attention-score tensors on one device: the flash
    kernel keeps them out of device memory, so the estimate removes them."""
    track: set[int] = set()
    if cfg.ssm != "rwkv6" and shape.kind in ("train", "prefill"):
        dshards = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
        mshards = mesh_shape.get("model", 1)
        B_loc = (shape.global_batch // dshards if shape.global_batch % dshards == 0
                 else shape.global_batch)
        H_loc = cfg.n_heads // mshards if cfg.n_heads % mshards == 0 else cfg.n_heads
        for hh in {H_loc, cfg.n_heads}:
            for width in (2, 4):
                track.add(B_loc * hh * shape.seq_len * shape.seq_len * width)
    return frozenset(track)


def flash_estimate(cfg, shape, mesh_shape: dict, bytes_dev: float,
                   tracked: float) -> tuple[float, float]:
    """(the flash kernel's q/k/v/o streaming bytes, the per-device bytes
    with the score chain's traffic ``tracked`` replaced by them): the
    reference's estimate of a step whose attention runs in the kernel."""
    n_attn = cfg.n_layers // (cfg.attn_every or 1)
    dshards = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    mshards = mesh_shape.get("model", 1)
    B_loc = max(shape.global_batch // dshards, 1)
    H_loc = max(cfg.n_heads // mshards, 1)
    Hk_loc = max(cfg.n_kv_heads // mshards, 1)
    flash_io = n_attn * B_loc * shape.seq_len * cfg.head_dim * \
        (H_loc * 2 + Hk_loc * 2) * 2 * 3.0
    return flash_io, max(bytes_dev - tracked + flash_io, 0.0)


def _memory(cfg, shape, mesh) -> dict:
    """Per-device bytes of what the step holds as inputs."""
    out = {"params_bytes": local_bytes(*param_specs_tree(cfg), mesh),
           "batch_bytes": local_bytes(*batch_specs(cfg, shape), mesh)}
    if shape.kind == "train":
        out["opt_state_bytes"] = local_bytes(*opt_specs_tree(cfg, OptConfig()), mesh)
    if shape.kind == "decode":
        out["cache_bytes"] = local_bytes(*cache_specs(cfg, shape), mesh)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             rule_overrides: dict | None = None, tag: str = "",
             variants: list[str] | None = None, grad_accum: int = 1) -> dict:
    cfg = get_config(arch)
    if variants:
        cfg = apply_variants(cfg, variants)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": 512 if multi_pod else 256, "kind": shape.kind,
                 "status": "ok", "tag": tag, "torch": torch.__version__}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rec["chips"] = mesh.size()
        with axis_rules(mesh, rule_overrides):
            if shape.kind == "train" and grad_accum > 1:
                cell = make_train_cell(cfg, shape, grad_accum=grad_accum)
            else:
                cell = make_cell(cfg, shape)
            rep = count_cell(cell, mesh, track_sizes(cfg, shape, mesh_shape))
            rec["memory"] = _memory(cfg, shape, mesh)
        rec["count_s"] = round(time.time() - t0, 2)
        rec["collectives"] = rep.as_dict()
        rec["bytes_by_op"] = rep.bytes_by_op
        flops_dev, bytes_dev = rep.flops, rep.bytes
        rec["per_device"] = {"flops": flops_dev, "bytes": bytes_dev,
                             "collective_bytes": rep.collective_bytes}
        n_chips = rec["chips"]
        if rep.tracked_bytes > 0:
            flash_io, adj_bytes = flash_estimate(cfg, shape, mesh_shape, bytes_dev,
                                                 rep.tracked_bytes)
            rec["flash_estimate"] = {
                "score_bytes_detected": rep.tracked_bytes,
                "flash_io_bytes": flash_io,
                "bytes": adj_bytes,
                "roofline": roofline_terms(
                    cfg=cfg, shape=shape, n_chips=n_chips,
                    flops_per_device=flops_dev, bytes_per_device=adj_bytes,
                    collective_bytes_per_device=rep.collective_bytes),
            }
        rec["roofline"] = roofline_terms(
            cfg=cfg, shape=shape, n_chips=n_chips, flops_per_device=flops_dev,
            bytes_per_device=bytes_dev, collective_bytes_per_device=rep.collective_bytes)
        rr = rec["roofline"]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: counted in {rec['count_s']}s "
              f"({rep.n_ops} ops)")
        print(f"[dryrun]   per-device flops={flops_dev:.3e} bytes={bytes_dev:.3e} "
              f"coll={rep.collective_bytes:.3e}")
        print(f"[dryrun]   terms: compute={rr['compute_s']:.4f}s "
              f"memory={rr['memory_s']:.4f}s collective={rr['collective_s']:.4f}s "
              f"-> {rr['dominant']}-bound, useful-flops {rr['useful_flops_ratio']:.2f}")
        print(f"[dryrun]   memory: {rec['memory']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: FAILED — {rec['error']}")
    finally:
        release_process_group()
    rec["total_s"] = round(time.time() - t0, 2)

    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = out_dir / f"{arch}_{shape_name}_{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def _parse_rules(text: str) -> dict | None:
    """``heads=:embed=data`` -> {"heads": (), "embed": ("data",)}; axes of
    one name joined by ``+``."""
    if not text:
        return None
    overrides = {}
    for kv in text.split(":"):
        k, _, v = kv.partition("=")
        overrides[k] = tuple(a for a in v.split("+") if a)
    return overrides


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run: count every "
                                 "(arch × shape × mesh) cell's per-device step")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every applicable cell")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--tag", default="", help="suffix for perf-iteration variants")
    ap.add_argument("--variants", default="", help="comma-separated config variants")
    ap.add_argument("--rules", default="", help="sharding rule overrides, e.g. heads=:embed=data")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all, are required")

    out_dir = pathlib.Path(args.out)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in list_archs():
            for shape_name in applicable_shapes(get_config(arch)):
                cells.extend((arch, shape_name, mp) for mp in meshes)
    else:
        cells.extend((args.arch, args.shape, mp) for mp in meshes)

    overrides = _parse_rules(args.rules)
    variants = [v for v in args.variants.split(",") if v]
    n_fail = 0
    for arch, shape_name, mp in cells:
        mesh_name = "multi" if mp else "single"
        suffix = f"_{args.tag}" if args.tag else ""
        path = out_dir / f"{arch}_{shape_name}_{mesh_name}{suffix}.json"
        if args.skip_existing and path.exists():
            if json.loads(path.read_text()).get("status") == "ok":
                print(f"[dryrun] skip existing {path.name}")
                continue
        rec = run_cell(arch, shape_name, mp, out_dir, tag=args.tag,
                       rule_overrides=overrides, grad_accum=args.grad_accum,
                       variants=variants)
        n_fail += rec["status"] != "ok"
    print(f"[dryrun] done: {len(cells)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
