"""The torch port stands alone: no JAX, nothing of ``repro``, the card by
default and the CPU only when asked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    hits = _IMPORT.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {sorted(set(hits))}"


_ML_DTYPES = re.compile(r"^\s*(?:import|from)\s+ml_dtypes(?:\.|\s|$)", re.M)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_ml_dtypes(path):
    """The card's machine has no ml_dtypes (the reference's checkpoint store
    imports it): bf16 crosses as its 16-bit pattern instead."""
    assert not _ML_DTYPES.findall(path.read_text()), str(path.relative_to(ROOT))


def test_cpu_sweep_loads_neither_jax_nor_repro():
    code = """
import sys
import numpy as np
from repro_torch.configs.paper_workflow import compile_paper_plan, sweep_scenarios
plan = compile_paper_plan(0.5, device="cpu")
rep = plan.sweep(plan.prepare(sweep_scenarios(np.linspace(0.1, 0.9, 9))),
                 backend="torch")
rep.sample_progress("dl1", np.linspace(0.0, 300.0, 16))
rep.data_ceiling("task3", np.linspace(0.0, 300.0, 16))
rep.kernel_finish_times("task3")
assert set(rep.backends) == {"torch"}
from repro_torch.kernels.ppoly_eval import kernel
assert kernel._lib is None, "a CPU run built the CUDA kernels"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cpu_optimize_and_mc_load_neither_jax_nor_repro():
    code = """
import sys
from repro_torch.analysis import cap_space
from repro_torch.configs.paper_workflow import compile_paper_plan, mc_spec
plan = compile_paper_plan(0.5, device="cpu")
opt = plan.optimize(space=cap_space(["task1.cpu"], lo=0.5, hi=2.0),
                    max_iters=2)
mc = plan.mc(mc_spec(), n=64, seed=0)
assert opt.evals > 0 and mc.n == 64 and set(mc.report.backends) == {"torch"}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_is_the_card(monkeypatch):
    from repro_torch.analysis import compile_workflow
    from repro_torch.configs.paper_workflow import build_workflow
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = build_workflow(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_workflow(wf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.compile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert compile_workflow(wf, device="cpu").device == torch.device("cpu")


def test_cpu_service_and_analyze_launcher_load_neither_jax_nor_repro(tmp_path):
    code = """
import sys
import numpy as np
from repro_torch.analysis import AnalysisService
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.launch import analyze
with AnalysisService(build_workflow(0.5), device="cpu", store="store") as svc:
    rep = svc.query(sweep_scenarios([0.3, 0.7]), timeout=120)
    assert rep.backends == ["torch", "torch"]
    live = svc.track(sweep_scenarios([0.5]), track_id="t")
    live.ingest({"dl1.link": np.float64(0.5)}, timeout=120)
    live.close()
out = analyze.main(["--device", "cpu", "--clients", "4", "--queries", "2",
                    "--mc-draws", "64"])
assert out["load"]["served"] == 8 and out["mc"]["draws"] == 64
from repro_torch.kernels.ppoly_eval import kernel
assert kernel._lib is None, "a CPU run built the CUDA kernels"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_service_default_device_is_the_card(monkeypatch):
    from repro_torch.analysis import AnalysisService
    from repro_torch.configs.paper_workflow import build_workflow
    from repro_torch.launch import analyze

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalysisService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalysisService(build_workflow(0.5), autostart=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze.main(["--clients", "1", "--queries", "1", "--no-mc"])
    with AnalysisService(autostart=False, device="cpu") as svc:
        assert svc.device == torch.device("cpu")
        assert svc.compile(build_workflow(0.5)).device == torch.device("cpu")


def test_kernel_sources_and_build_dir():
    from repro_torch.kernels.ppoly_eval import kernel

    assert kernel.SOURCES[0].is_file()
    assert kernel.build_dir() == ROOT / "build" / "repro_torch"


def test_cpu_lm_serving_loads_neither_jax_nor_repro():
    code = """
import sys
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
cfg = get_smoke_config("yi-9b")
model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
with torch.inference_mode():
    T.prefill(model, cfg, {"tokens": torch.zeros((2, 37), dtype=torch.long)})
serve.main(["--device", "cpu", "--arch", "h2o-danube-3-4b", "--gen-len", "4"])
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.ppoly_eval import kernel as pe
assert fa._lib is None and pe._lib is None, "a CPU run built a CUDA library"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_lm_default_device_is_the_card(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    from repro_torch.models.convert import params_from_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("yi-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-9b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_arrays({}, cfg)
    # the kernel is built only for a card: without one the build raises
    # before nvcc is looked for
    monkeypatch.setattr(fa, "_lib", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fa.library()
    assert fa._lib is None


def test_flash_kernel_source_and_build_dir():
    from repro_torch.kernels.flash_attention import kernel as fa

    assert fa.SOURCES == (PORT / "csrc" / "flash_attention.cu",)
    assert fa.SOURCES[0].is_file()
    assert fa.build_dir() == ROOT / "build" / "repro_torch"
    assert "arch=compute_90a,code=sm_90a" in fa.NVCC_FLAGS
    assert not any("fast_math" in f for f in fa.NVCC_FLAGS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (1, 2, 2, 64, 16, True, None),      # MHA
    (2, 4, 2, 37, 64, True, None),      # GQA group 2, ragged S
    (1, 8, 1, 300, 128, True, None),    # MQA
    (2, 4, 2, 130, 120, True, 32),      # window, head_dim 120
    (1, 4, 4, 100, 32, False, None),    # not causal, ragged S
    (1, 32, 4, 1024, 128, True, None),  # GQA 8 at yi-9b's head size
    (1, 32, 4, 4096, 128, True, None),  # GQA 8 at the train_4k length
    (2, 4, 2, 300, 120, True, 64),      # head_dim 120, window 64
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, Hkv, S, D, causal, window):
    """The CUDA kernel against its plain version's float32 result, with the
    bars of ``flash_failures``: max abs 2e-5 and relative L2 1e-5 in
    float32; in bf16 max abs 0.03 (the bar of
    tests/test_kernel_flash_attention.py), relative L2 4e-3 and every
    element within 2^-8 (|want| + P|V|) + 2e-5 (the output's and the
    probabilities' rounding to bf16).  bf16 takes the tensor-core kernel."""
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                      flash_error, flash_failures)
    from repro_torch.kernels.flash_attention import kernel as fa

    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn((B, H, S, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=cuda).to(dtype)
    before = dict(fa.launches)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before["flash_attention"] + 1
    tc = int(dtype == torch.bfloat16)
    assert fa.launches["flash_attention_tc"] == before["flash_attention_tc"] + tc
    # the plain version in float32, before its cast to bf16
    kw = {"causal": causal, "window": window}
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    pv = attention_ref(q.float(), k.float(), v.float().abs(), **kw) if tc else None
    assert got.dtype == dtype and got.shape == q.shape
    assert not flash_failures(flash_error(got, want, pv), dtype)


def test_cpu_rwkv_serving_loads_neither_jax_nor_repro():
    code = """
import sys
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
cfg = get_smoke_config("rwkv6-1.6b")
model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
with torch.inference_mode():
    T.prefill(model, cfg, {"tokens": torch.zeros((2, 37), dtype=torch.long)})
out = serve.main(["--device", "cpu", "--gen-len", "4"])
assert out["arch"] == "rwkv6-smoke", out["arch"]
from repro_torch.kernels.wkv6 import kernel as wk
assert wk._lib is None and wk.launches["wkv6"] == 0, "a CPU run used the CUDA kernel"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_wkv6_kernel_source_and_build_dir(monkeypatch):
    from repro_torch.kernels.wkv6 import kernel as wk

    assert wk.SOURCES == (PORT / "csrc" / "wkv6.cu",)
    assert wk.SOURCES[0].is_file()
    assert wk.build_dir() == ROOT / "build" / "repro_torch"
    assert "arch=compute_90a,code=sm_90a" in wk.NVCC_FLAGS
    assert not any("fast_math" in f for f in wk.NVCC_FLAGS)
    # built only for a card: without one the build raises before nvcc is
    # looked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(wk, "_lib", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wk.library()
    assert wk._lib is None


def test_wkv6_chunked_route_source():
    """The chunked route: a phase per (b, h, chunk), a state scan fed by
    cp.async copies under mbarriers, tensor-core products split for 3xTF32;
    ptxas reports registers and spills into the build log."""
    from repro_torch.kernels.wkv6 import kernel as wk

    src = wk.SOURCES[0].read_text()
    for needle in ("wkv6_intra_kernel", "wkv6_scan_kernel", "wkv6_intra_launch",
                   "wkv6_scan_launch", "wkv6_scratch_floats",
                   "mma.sync.aligned.m16n8k8.row.col.f32.tf32", "0xffffe000u",
                   "cp.async", "mbarrier"):
        assert needle in src, needle
    assert "-v" in wk.NVCC_FLAGS and "-Xptxas" in wk.NVCC_FLAGS


@pytest.mark.parametrize("name", ["wkv6_cuda", "launch_serial", "launch_chunked",
                                  "launch_intra", "launch_scan"])
def test_wkv6_launchers_take_cuda_tensors_only(monkeypatch, name):
    """Every launcher refuses CPU tensors before it builds or loads the
    library."""
    from repro_torch.kernels.wkv6 import kernel as wk

    monkeypatch.setattr(wk, "_lib", None)
    r, s0 = torch.zeros((1, 40, 1, 8)), torch.zeros((1, 1, 8, 8))
    args = [r, r, r, r, torch.zeros((1, 8)), s0]
    if name == "launch_scan":
        args = [s0, r, torch.zeros(1000)]
    before = dict(wk.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(wk, name)(*args, chunk=32)
    assert wk._lib is None and wk.launches == before


def test_ptxas_usage_parses_registers_and_spills():
    from repro_torch.kernels.build import ptxas_usage

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4kernA' for 'sm_90a'
ptxas info    : Function properties for _Z4kernA
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 64 bytes spill stores, 64 bytes spill loads
ptxas info    : Compiling entry function '_Z4kernB' for 'sm_90a'
ptxas info    : Function properties for _Z4kernB
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert ptxas_usage(log) == {
        "_Z4kernA": {"registers": 80, "spill_stores": 4, "spill_loads": 12},
        "_Z4kernB": {"registers": 40, "spill_stores": 0, "spill_loads": 0}}
    assert ptxas_usage("") == {}


def _wkv_inputs(gen, B, L, H, N, scale, dev):
    r, k, v = (torch.randn((B, L, H, N), generator=gen, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(scale * torch.randn((B, L, H, N), generator=gen, device=dev)))
    u = 0.1 * torch.randn((H, N), generator=gen, device=dev)
    s0 = 0.2 * torch.randn((B, H, N, N), generator=gen, device=dev)
    return r, k, v, w, u, s0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("B,L,H,N,scale", [
    (1, 1, 1, 8, 2.0),       # one token (a decode step)
    (2, 96, 2, 16, 2.0),     # several chunks, state carried
    (1, 50, 2, 8, 2.0),      # ragged last chunk
    (2, 64, 2, 64, 2.0),     # model-sized head
    (1, 70, 3, 24, 3.5),     # partial value slab, near-zero decays
    (1, 203, 2, 64, 3.5),    # ragged, near-zero decays, model-sized head
    (1, 4133, 2, 64, 2.0),   # 65 to 259 chunks, ragged
    (2, 333, 2, 22, 2.0),    # head size not a multiple of 4
])
def test_wkv6_kernel_matches_plain(cuda, chunk, B, L, H, N, scale):
    """The CUDA kernels against their plain version on the card: max abs
    2e-3 * max(1, max |plain|) (the bar of tests/test_kernel_wkv6.py) and
    relative L2 1e-4, on y and on the final state.  The op takes the route
    :func:`kernel.route` names; the other route is run too."""
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv6, wkv_chunked_ref

    gen = torch.Generator(device=cuda).manual_seed(L + N)
    args = _wkv_inputs(gen, B, L, H, N, scale, cuda)
    rt = wk.route(L, chunk)
    before = dict(wk.launches)
    y, s = wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.launches["wkv6"] == before["wkv6"] + 1
    assert wk.launches[f"wkv6_{rt}"] == before[f"wkv6_{rt}"] + 1
    other = wk.launch_serial if rt == "chunked" else wk.launch_chunked
    y2, s2 = other(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.launches == {**before, "wkv6": before["wkv6"] + 1,
                           f"wkv6_{rt}": before[f"wkv6_{rt}"] + 1}
    yr, sr = wkv_chunked_ref(*args, chunk=chunk)
    for got, want in ((y, yr), (s, sr), (y2, yr), (s2, sr)):
        assert got.shape == want.shape and got.dtype == torch.float32
        diff = (got - want).abs()
        assert float(diff.max()) <= 2e-3 * max(1.0, float(want.abs().max()))
        assert float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want)) <= 1e-4


@pytest.mark.parametrize("module", [
    "repro_torch.core.shared", "repro_torch.core.des",
    "repro_torch.models.moe", "repro_torch.models.mamba",
    "repro_torch.sweep.result", "repro_torch.analysis.journal"])
def test_new_modules_load_neither_jax_nor_repro(module):
    code = f"""
import sys
import {module}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cpu_des_shared_trace_and_moe_load_neither_jax_nor_repro():
    code = """
import sys, warnings
import numpy as np
import torch
from repro_torch import sweep
from repro_torch.configs import get_smoke_config
from repro_torch.configs.paper_workflow import (LINK_BPS, build_workflow,
                                                measure_makespan,
                                                sweep_scenarios)
from repro_torch.core import PPoly, sequential_allocation
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.sweep.torch_engine import trace_report
assert measure_makespan(0.5, video_bytes=1e8)[1] > 0
wf = build_workflow(0.5)
res = sequential_allocation(wf, [("dl1", "link", PPoly.constant(LINK_BPS))],
                            LINK_BPS)
assert res["dl1"].finish_time > 0
plan = wf.compile(device="cpu")
pack = plan.prepare(sweep_scenarios([0.3, 0.7]))
assert trace_report(plan, pack)["level_loops"] == 3
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    sweep.analyze(wf, sweep_scenarios([0.4]), device="cpu")
for arch in ("qwen3-moe-235b-a22b", "jamba-v0.1-52b"):
    cfg = get_smoke_config(arch)
    model = T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))
    with torch.inference_mode():
        T.prefill(model, cfg, {"tokens": torch.zeros((2, 9), dtype=torch.long)})
from repro_torch.kernels.flash_attention import kernel as fa
assert fa._lib is None, "a CPU run built a CUDA library"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _moe_mamba_cfg(ssm):
    from repro_torch.models.common import ModelConfig

    return ModelConfig(name="m", family="hybrid", n_layers=1, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=64,
                       head_dim=16, n_experts=8, top_k=2, capacity_factor=1.0,
                       ssm=ssm, d_state=16, d_conv=4, ssm_expand=2,
                       dtype="float32")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("impl", ["global", "local", "shmap"])
def test_moe_on_the_card_matches_cpu(cuda, impl):
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.common import _moe_specs, init_params

    cfg = dataclasses.replace(_moe_mamba_cfg(None), moe_impl=impl)
    tree = init_params(cfg, seed=0, device="cpu")
    p = tree["blocks"]["pos0"]["moe"]
    assert set(p) == set(_moe_specs(cfg, 0))
    x = 0.5 * torch.randn((2, 300, 64), generator=torch.Generator().manual_seed(1))
    want = moe.moe_forward(moe.MoE(**{k: v[0] for k, v in p.items()}), x, cfg)
    pc = moe.MoE(**{k: v[0].to(cuda) for k, v in p.items()})
    got = moe.moe_forward(pc, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_mamba_on_the_card_matches_cpu(cuda):
    from repro_torch.models import mamba
    from repro_torch.models.common import _mamba_specs, _init_leaf

    cfg = _moe_mamba_cfg("mamba")
    gen = torch.Generator().manual_seed(0)
    p = {k: _init_leaf(gen, s, cfg, torch.device("cpu"))
         for k, s in _mamba_specs(cfg, 0).items()}
    x = 0.3 * torch.randn((2, 2 * mamba.CHUNK + 5, 64),
                          generator=torch.Generator().manual_seed(1))
    want = mamba.mamba_forward(mamba.Mamba(**p), x, cfg)
    pc = mamba.Mamba(**{k: v.to(cuda) for k, v in p.items()})
    got = mamba.mamba_forward(pc, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    st = mamba.mamba_init_state(cfg, 2, torch.float32, cuda)
    y, st = mamba.mamba_decode(pc, x[:, :1].to(cuda), cfg, st)
    torch.testing.assert_close(y.cpu(), want[:, :1], rtol=1e-4, atol=1e-4)


def test_cpu_training_loads_neither_jax_nor_repro_nor_ml_dtypes(tmp_path):
    code = """
import sys
from repro_torch.launch import train
out = train.main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--smoke",
                  "--steps", "1", "--seq", "40", "--batch", "2",
                  "--ckpt-dir", "ckpt"])
assert out["final_step"] == 1
again = train.main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--smoke",
                    "--steps", "2", "--seq", "40", "--batch", "2",
                    "--ckpt-dir", "ckpt"])
assert again["final_step"] == 2 and len(again["losses"]) == 1
from repro_torch.kernels.wkv6 import kernel as wk
assert wk._lib is None and wk.launches["wkv6"] == 0, "a CPU run used the CUDA kernel"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_training_defaults_to_the_card(monkeypatch, tmp_path):
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("yi-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "t")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-9b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "l")])
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "c"), async_save=False))
    mgr.save(1, {"a": torch.ones(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"a": torch.ones(3)})
    assert torch.equal(mgr.restore(1, {"a": torch.ones(3)}, device="cpu")["a"],
                       torch.ones(3))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_inputs_needing_a_gradient_reach_the_autograd_wrappers(cuda, dtype):
    """On the card, flash attention and wkv6 inputs that need a gradient go
    through the autograd wrappers: the kernel launches once in the forward,
    every input gets its gradient from the plain version's recompute, and
    inputs that need none call the kernel directly."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.kernels.wkv6.ops import Wkv6Fn

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 4, 70, 64), generator=gen, device=cuda).to(dtype).requires_grad_()
    k = torch.randn((1, 2, 70, 64), generator=gen, device=cuda).to(dtype).requires_grad_()
    v = torch.randn((1, 2, 70, 64), generator=gen, device=cuda).to(dtype).requires_grad_()
    before = fa.launches["flash_attention"]
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == \
        f"{FlashAttentionFn.__name__}Backward"
    out.float().square().sum().backward()
    assert fa.launches["flash_attention"] == before + 1
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None

    r, kk, vv = (torch.randn((1, 70, 2, 64), generator=gen, device=cuda).requires_grad_()
                 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((1, 70, 2, 64), generator=gen, device=cuda)))
    u = (0.1 * torch.randn((2, 64), generator=gen, device=cuda)).requires_grad_()
    s0 = torch.zeros((1, 2, 64, 64), device=cuda)
    before = dict(wk.launches)
    y, s = wkv6(r, kk, vv, w, u, s0, chunk=32)
    assert type(y.grad_fn).__name__ == f"{Wkv6Fn.__name__}Backward"
    y.square().sum().backward()
    assert wk.launches["wkv6_chunked"] == before["wkv6_chunked"] + 1
    assert all(x.grad is not None for x in (r, kk, vv, u))
