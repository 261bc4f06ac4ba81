"""The port's dry-run end to end, with the reference's integration checks
(``tests/test_dryrun_integration.py``), and its error contract.

The cell runs in a child process, as the reference's does (the dry-run sets
up a fake process group of 256 ranks there); it takes about 10 s here, so
it is not marked slow.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun
from repro_torch.perfmodel.stepmodel import from_dryrun_record, predict

ROOT = Path(__file__).resolve().parents[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


@pytest.fixture(scope="module")
def decode_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-1.6b",
           "--shape", "decode_32k", "--mesh", "single", "--out", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=_env(),
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return out, json.loads((out / "rwkv6-1.6b_decode_32k_single.json").read_text())


def test_dryrun_cell_end_to_end(decode_record):
    _, rec = decode_record
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    per = rec["per_device"]
    assert per["flops"] > 0 and per["bytes"] > 0
    rr = rec["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "useful_flops_ratio", "roofline_fraction"):
        assert k in rr
    assert rr["dominant"] in ("compute", "memory", "collective")
    # decode is memory-bound (weight/state streaming)
    assert rr["dominant"] == "memory"
    # the step model consumes the record directly
    p = predict(from_dryrun_record(rec, n_steps=10, data_rate_steps_per_s=1e6))
    assert p.step_time_s > 0


def test_record_keys(decode_record):
    _, rec = decode_record
    for k in ("arch", "shape", "mesh", "chips", "kind", "status", "tag", "per_device",
              "roofline", "collectives", "memory", "count_s", "total_s", "torch"):
        assert k in rec, k
    assert set(rec["collectives"]) >= {"flops", "bytes", "collective_bytes",
                                       "collective_by_op", "collective_counts", "n_while"}
    assert rec["collectives"]["collective_bytes"] == rec["per_device"]["collective_bytes"]
    mem = rec["memory"]
    assert mem["params_bytes"] > 0 and mem["cache_bytes"] > 0
    # an RWKV decode step has no attention scores: no flash estimate
    assert "flash_estimate" not in rec


def test_example_reads_the_record(decode_record):
    out, _ = decode_record
    res = subprocess.run([sys.executable, str(ROOT / "examples" / "step_prediction_torch.py"),
                          "--cell", "rwkv6-1.6b_decode_32k_single", "--dir", str(out)],
                         capture_output=True, text=True, timeout=300, env=_env())
    assert res.returncode == 0, res.stderr[-2000:]
    assert "predicted step" in res.stdout and "what-if" in res.stdout


def test_skip_existing(decode_record, capsys):
    out, _ = decode_record
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                        "--out", str(out), "--skip-existing"]) == 0
    assert "skip existing" in capsys.readouterr().out
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,variant", [
    ("qwen3-moe-235b-a22b", None), ("kimi-k2-1t-a32b", None),
    ("jamba-v0.1-52b", None), ("qwen3-moe-235b-a22b", "moe_local"),
    ("qwen3-moe-235b-a22b", "moe_shmap")])
def test_moe_and_hybrid_smoke_count_on_a_2x4_mesh(arch, variant):
    """The MoE dispatch (``index_add_`` and the double scatter, which
    DTensor has no strategy for) counts on a fake (2, 4) mesh: every kind
    of step, rank 0 below the whole step and above an eighth of it."""
    from repro_torch import configs
    from repro_torch.distributed import axis_rules
    from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh, release_process_group
    from repro_torch.launch.specs import count_cell, make_cell

    cfg = configs.get_smoke_config(arch)
    if variant:
        cfg = configs.apply_variants(cfg, [variant])
    for kind in ("train", "prefill", "decode"):
        shape = configs.ShapeSpec("s", 64, 4, kind)
        host = make_host_mesh()
        with axis_rules(host):
            whole = count_cell(make_cell(cfg, shape), host).flops
        mesh = make_fake_mesh((2, 4), ("data", "model"))
        try:
            with axis_rules(mesh):
                dev = count_cell(make_cell(cfg, shape), mesh).flops
        finally:
            release_process_group()
        assert whole / 8 <= dev < whole, (kind, dev, whole)
    assert not dist.is_initialized()


def test_uneven_head_split_trains_on_a_2x4_mesh():
    """starcoder2 smoke (6 heads on a model axis of 4, as musicgen's 24 on
    16): the gradient pinned at the attention output meets the head split
    on a placement it can view."""
    from repro_torch import configs
    from repro_torch.distributed import axis_rules
    from repro_torch.launch.mesh import make_fake_mesh, release_process_group
    from repro_torch.launch.specs import count_cell, make_cell

    cfg = configs.get_smoke_config("starcoder2-15b")
    assert cfg.n_heads % 4
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    try:
        with axis_rules(mesh):
            rep = count_cell(make_cell(cfg, configs.ShapeSpec("s", 64, 4, "train")), mesh)
    finally:
        release_process_group()
    assert rep.flops > 0


def test_failed_cell_is_recorded(monkeypatch, tmp_path):
    """A cell that raises records ``status: "error"`` with its traceback,
    the sweep goes on, the run exits 1, and the process group is gone."""
    def boom(*a, **k):
        raise RuntimeError("no sharding rule for this op")

    monkeypatch.setattr(dryrun, "count_cell", boom)
    assert dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--out",
                        str(tmp_path), "--tag", "t"]) == 1
    rec = json.loads((tmp_path / "yi-9b_decode_32k_single_t.json").read_text())
    assert rec["status"] == "error" and "no sharding rule" in rec["error"]
    assert "RuntimeError" in rec["traceback"]
    assert not dist.is_initialized()


def test_rule_overrides_parse():
    assert dryrun._parse_rules("heads=:embed=data") == {"heads": (), "embed": ("data",)}
    assert dryrun._parse_rules("batch=pod+data") == {"batch": ("pod", "data")}
    assert dryrun._parse_rules("") is None


def test_arguments_are_required():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi-9b"])
