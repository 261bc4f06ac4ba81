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
