#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc (one nvcc
per source, all started together), holds each against its plain PyTorch
version, drives the port's paths on the card — the analysis path
compile -> prepare -> fused sweep -> Report with the Report's curve queries,
the language-model serving path (prefill through the flash kernel, cached
decode through the serving launcher) at yi-9b's full width, and RWKV-6
serving (prefill and cached decode, every layer's wkv through the wkv6
kernel) at rwkv6-1.6b's full width, and the MoE and hybrid families
(qwen3-moe-235b-a22b and jamba-v0.1-52b at full width, cut in depth) —
checks the results, and times the kernels, and the analysis service (``repro_torch.analysis.serve``: the
launcher, coalescing at B = 10,000, the fault plan, the durable store and
the journal, Monte Carlo through the worker).  Every phase prints one JSON
line; any failure raises and ends the run with a non-zero exit.  The last line is ``{"ok": true, "device": {...}}``.

Phases: env, build, kernels (random ragged shapes, T = 1 to 4097 and a q
that is not 16-byte aligned; each kernel on every route that takes the
shape, each route held bitwise against "tile"),
flash_kernels (random
attention shapes, float32 and bf16, and one bf16 call at S = 32,768 held
against the plain version 2,048 query rows at a time), wkv6_kernels
(random wkv shapes, chunks 16, 32 and 64, one call at L = 32,768, each on
both routes: the chunked kernels and the serial kernel),
sweep_fig7 (B = 600, the paper's Fig. 7 sweep), sweep_b10k_ramped
(B = 10,000 with ramped link allocations), queries (T = 1024 curve queries
on the B = 10,000 Report, each call's host time and its kernel's share;
every evaluation and minimum on the "vec" route, every crossing on "row";
each result equal bit for bit to the op on inputs packed by hand, whose
steps are timed; the main path's results copied back again into pageable
and into pinned memory, in turns; on fresh Reports the first and second
call of each, and the steps the Report takes), optimize_fig7
(``plan.optimize`` over ``fig7_space()`` on the card: the grid's optimum,
the reference's value, the same search on the CPU; one value-and-gradient
sweep and one ladder sweep timed), optimize_grad (gradients against
central differences, linear and ramped, each the same bits twice),
mc_b10k (``plan.mc(mc_spec(), n=10_000, seed=0)`` against the reference's
quantiles and dominant factors and the numpy twin; its steps timed),
optimize_mc (the p95 search over 256 draws twice, bit for bit),
service_load (``repro_torch.launch.analyze.main([])`` on the card: 32
clients x 4 queries, 6 online steps, 2,048 draws; latency p50/p99,
requests/s, sweeps against requests, the plan cache's counters),
service_b10k (the b10k_ramped set through one service by 40 client
threads of 250 rows, max_batch 4096: every client's rows equal to
``plan.sweep``'s at B = 10,000 bit for bit; then sample_progress,
data_ceiling and kernel_finish_times at T = 1024 on a coalesced client's
Report, each equal bit for bit to the same rows of ``plan.sweep``'s Report,
each kernel call held against its plain version, the "vec"/"row" launches
counted around the queries), service_faults (NaN rows degraded to the
numpy twin's rows, a killed worker restarted, a failed sweep retried, a
malformed request failing alone, a 0.02 s deadline behind a 0.25 s delay),
service_durable (a store under build/service_store: a warm start bit for
bit the cold service, a corrupted artifact rejected with one
ArtifactWarning and a cold compile, 6 tracked deltas recovered to the live
digest), service_mc (``submit_mc(mc_spec(), n=10_000, seed=0)`` against
``plan.mc``: quantiles bit for bit), des_vs_model (the Fig. 7 sweep on
the card against the DES at every 20th fraction, both recipes' mean
relative error; the DES's exact makespans and event counts at 0.5 and
0.95; the refined recipe within 0.2 % of the DES at 0.5, 0.75, 0.95, the
paper recipe above it and within 15 % at 0.5; §6's runtimes: the model at
1.1 GB and 90x, the DES at 1.1 GB and 10x), shared_link
(``sequential_allocation`` of the paper's two downloads at three
fractions: dl2 done when the link moved both files, usage never above the
capacity, the allocated workflow swept on the card to the same finishes),
trace_report (``trace_report`` for the fig7 and b10k_ramped packs on the
card and on the CPU: one loop per level, the same counts twice; the device
events of one warm sweep under torch.profiler), sweep_shim (the deprecated
``repro_torch.sweep.analyze`` warns and equals ``plan.sweep`` bit for
bit), shard_sweep (the b10k_ramped pack through ``pack.shard()``, one
sub-batch per visible card, and ``pack.shard(1)``, each bit for bit the
unsharded sweep: rows, share seconds and the three curve queries at
T = 1024, every query kernel call held against its plain version and
counted from 0; a shard count above the cards refused; the Fig. 7 pack at
``shard(7)`` on the CPU bit for bit; ``plan.mc(shards=1)`` against
``shards=None``), lm_prefill (yi-9b, bf16, B = 2, S = 4096; every flash call on the
tensor-core kernel),
lm_serve (``repro_torch.launch.serve``
with yi-9b, 8 requests; prefill against decode beside the bf16 batch-split
floor), lm_prefill_rwkv (rwkv6-1.6b, bf16, B = 2, S = 4096; every wkv6
call on the chunked route), lm_serve_rwkv (the launcher with rwkv6-1.6b, 8
requests; every wkv6 call on the serial route), lm_prefill_moe and
lm_serve_moe (qwen3-moe-235b-a22b, 2 of 94 layers: two flash calls at GQA
group 16, each held against the plain version; the launcher's 8 requests;
then a float32 prefill against a token-by-token decode at B = 2, 32
tokens, capacity drops off, at the reference's max abs 2e-2),
lm_prefill_jamba and lm_serve_jamba (jamba-v0.1-52b, 8 of 32 layers: one
period, 7 Mamba layers, attention at position 4 with one flash call at
GQA group 4, 4 MoE layers; the same checks), then training:
train_grad_kernels (the flash and wkv6 autograd wrappers on seeded card
tensors: forward bit for bit the kernel's, every gradient against the
plain version's autograd gradient), train_100m
(``repro_torch.launch.train.main`` with its defaults, dense-100m in
float32, 30 steps; a run stopped at step 20 and restarted, its restored
state bit for bit and its losses against the uninterrupted run's; one step
on the card against the CPU), train_yi (yi-9b at full width, 16 of 48
layers, bf16, B = 4, S = 2048, every flash call on the tensor cores),
train_rwkv (rwkv6-1.6b at full width and depth, every wkv6 call chunked)
and train_rwkv_f32 (2 layers in float32, a step against the CPU); the bf16
variants: wkv6_bf16_kernels (after wkv6_kernels: wkv6's bf16 mode on both
routes against the bf16 plain version at the rwkv6-1.6b prefill shape, an L
off the chunk multiple with and without s0, and a decode step; timed beside
the float32 mode), attn_bf16_card (after lm_serve: yi-9b cut to 2 layers,
a prefill with and one without attn_bf16, bit for bit equal) and
lm_rwkv_bf16 (after lm_serve_rwkv: rwkv6-1.6b with rwkv_bf16, prefill and 8
cached decode steps against the default variant, every wkv6 call under
wkv6_bf16); then the perf model: perfmodel_steps (train_100m, train_yi,
train_rwkv and lm_prefill as measured above, each counted on a 1x1 mesh:
roofline terms, the BottleMod step model's prediction, every step at or
above its compute bound) and dryrun_cells (``python -m
repro_torch.launch.dryrun`` in a child process for rwkv6-1.6b decode_32k,
yi-9b train_4k and qwen3-moe-235b-a22b decode_32k on the 256-card fake
mesh), examples_torch (``examples/quickstart_torch.py`` and
``examples/sweep_allocations_torch.py`` on the card, each in its own
process, each exiting with 0); then the
per-kernel line with launches on each path, errors and times at each
path's shapes (also with the L2 flushed between launches, the "tile"
route on the same inputs, and ptxas registers and spills; for the crossing
the launch floor).  The launch counts are
set to 0 just before each path is driven and read just after it; the
ppoly and flash rows carry each path's counts in ``launches_by_path``;
the flash row also times the kernel at the MoE and Jamba prefill shapes
(``by_shape``).

Imports nothing of JAX or of the reference package.  Exits with code 2 and
prints no result when no CUDA device is present or when the port's sources
are not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: (non-tensor-core) FLOP/s, used for the bound of each kernel
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), the bound of
#: the flash kernel's bf16 work at the prefill shape
PEAK_BF16_FLOPS = 989e12

TOL = 1e-5          # kernel vs plain version: rtol/atol
GOLDEN = {0.50: 297.645317854579, 0.95: 209.23437781819948}
FIG7_BEST = ("frac=0.9800", 206.2272)
T_QUERIES = 1024
B_LARGE = 10_000

KERNELS = {
    "ppoly_eval": "src/repro/kernels/ppoly_eval/kernel.py:163",
    "ppoly_min_eval": "src/repro/kernels/ppoly_eval/kernel.py:68",
    "ppoly_first_crossing": "src/repro/kernels/ppoly_eval/kernel.py:128",
}
SOURCE = "src/repro_torch/csrc/ppoly_eval.cu"
FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:85"}
FLASH_LONG = (1, 32, 4, 32_768, 128)   # B, H, Hkv, S, D: prefill_32k at yi-9b's heads
FLASH_LONG_ROWS = 2_048             # query rows per block of its plain check
LM_ARCH = "yi-9b"
LM_BATCH, LM_SEQ = 2, 4096          # the train_4k length
SERVE_TOL = 5e-2                    # prefill vs decode logits, relative L2
WKV6 = {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:77"}
WKV_ABS = 2e-3      # x max(1, max |plain|): the bar of tests/test_kernel_wkv6.py
WKV_REL_L2 = 1e-4   # relative L2 vs the plain version, on y and on s_final
RWKV_ARCH = "rwkv6-1.6b"
#: rwkv6-1.6b, prefill vs decode logits: in bf16 at most twice the same
#: run's batch-split floor (the prompts prefilled one by one against the
#: batch) and never below 1e-3, in float32 (the same weights) at relative
#: L2 1e-3
RWKV_FLOOR_FACTOR = 2.0
RWKV_F32_TOL = 1e-3
WKV_LONG = (1, 32_768, 32, 64)      # B, L, H, N: the prefill_32k length
#: the reference package's results, from ``repro`` (JAX) on a CPU:
#: ``compile_paper_plan(0.5).optimize(space=fig7_space(), max_evals=50)``
#: and ``plan.mc(mc_spec(), n=10_000, seed=0)``
REF_FIG7_VALUE = 206.22720298703013
REF_MC_QUANTILES = {"p50": 299.07836469867306, "p95": 365.39776369551555,
                    "p99": 393.52668841248527}
REF_MC_DOMINANT = {"dl1.link": 0.5451, "dl2.link": 0.4516, "task1.cpu": 0.0033}
MC_N = 10_000
FIG7_SPACING = 0.96 / 599           # the Fig. 7 grid's step
#: gradient cases held against central differences (h = 1e-5) at the
#: reference's bar: targets, theta, ramped dl1 link
#: the DES (the "measured system") at every DES_EVERY-th Fig. 7 fraction;
#: its exact results at two fractions, from the reference package
#: (``repro.configs.paper_workflow.measure_makespan``) on a CPU: pure Python
#: on IEEE doubles, the same on any machine
DES_EVERY = 20
DES_EXACT = {0.5: (271.64631770623305, 89227), 0.95: (189.64551013362393, 89227)}
SHARED_FRACS = (0.5, 0.75, 0.93)
#: the MoE and hybrid families at full width, cut in depth: qwen3-moe's
#: smallest depth with two MoE layers, jamba's one period (7 Mamba layers,
#: attention at position 4, 4 MoE layers)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 2
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
#: float32 prefill vs decode: (B, S) and the reference's max abs bar
#: (tests/test_arch_smoke.py)
XCHECK_SHAPE = (2, 32)
XCHECK_TOL = 2e-2
GRAD_CASES = (("caps", ("task1.cpu", "dl1.link"), (1.31, 0.73), False),
              ("ramped", ("task1.cpu", "task2.cpu"), (1.37, 0.81), True))
#: training: the launcher's defaults (dense-100m, float32, B = 8, S = 256)
#: for TRAIN_STEPS steps, a second run stopped at TRAIN_STOP and restarted;
#: the card's step against the CPU's at these bars (loss rtol, relative L2
#: of each gradient leaf) and the restarted run's losses at TRAIN_RESUME_TOL
TRAIN_STEPS, TRAIN_STOP = 30, 20
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2, TRAIN_RESUME_TOL = 1e-4, 1e-3, 1e-3
#: yi-9b at full width cut to 16 of 48 layers (bf16 parameters and
#: gradients and float32 moments of all 48 need about 106 GB), rwkv6-1.6b at
#: full width and depth: bf16, B x S, TRAIN_TIMED steps after one warm-up
TRAIN_YI_LAYERS = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 2048, 5
#: rwkv6-1.6b cut to 2 layers in float32 for the card-against-CPU step
RWKV_CPU_LAYERS, RWKV_CPU_SHAPE = 2, (1, 256)
#: wkv6's bf16 mode against the bf16 plain version on the same card tensors
#: (relative L2, y and s_final): both round at the reference's points and
#: products of bf16 values are exact in float32, so only the order of the
#: float32 sums differs; the cases (B, L, H, N, s0): the rwkv6-1.6b prefill,
#: an L off the chunk multiple with and without s0, a decode step
WKV_BF16_REL_L2 = 2e-3
WKV_BF16_CASES = ((2, 4096, 32, 64, True), (2, 333, 32, 64, True),
                  (2, 333, 32, 64, False), (8, 1, 32, 64, True))
#: the rwkv_bf16 variant's logits against the default's, relative L2: twice
#: the recorded 5.2e-2 bf16 batch-split floor (ROADMAP queue 3)
RWKV_BF16_TOL = 1e-1
RWKV_BF16_DECODE = 8
#: yi-9b cut to 2 layers for the attn_bf16 check
ATTN_BF16_LAYERS = 2
#: the dry-run cells run on the card's host, each in its own process; the
#: MoE cell counts its expert dispatch shard by shard
DRYRUN_CELLS = (("rwkv6-1.6b", "decode_32k"), ("yi-9b", "train_4k"),
                ("qwen3-moe-235b-a22b", "decode_32k"))
#: the Fig. 7 pack's shard count on the CPU: not a divisor of B = 600
CPU_SHARDS = 7
#: the example twins run on the card, each in its own process
EXAMPLES_TORCH = ("quickstart_torch.py", "sweep_allocations_torch.py")


#: every phase's JSON line, by phase, for the phases that reuse what an
#: earlier one measured (perfmodel_steps)
EMITTED: dict[str, dict] = {}


def emit(phase: str, **kv) -> None:
    EMITTED[phase] = kv
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------- timing ----
def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_s(fn, runs: int = 5) -> float:
    """Median wall seconds of ``fn()`` over ``runs`` calls, each ending in a
    device synchronize, after one warm-up call."""
    import statistics

    host_s(fn)
    return statistics.median(host_s(fn)[0] for _ in range(runs))


def host_s(fn):
    """Wall seconds of ``fn()`` ending in a device synchronize; (s, result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


# ------------------------------------------------------- report checks ----
def assert_match(a, b, what: str) -> None:
    """Makespans and finish times rtol 1e-5, shares rtol 1e-4 (the
    reference test-suite's sweep tolerances)."""
    import numpy as np

    np.testing.assert_allclose(a.makespans, b.makespans, rtol=1e-5, atol=1e-9,
                               err_msg=f"{what}: makespans")
    for pn in a.order:
        fa, fb = a.finish[pn], b.finish[pn]
        np.testing.assert_array_equal(np.isfinite(fa), np.isfinite(fb))
        ok = np.isfinite(fa)
        np.testing.assert_allclose(fa[ok], fb[ok], rtol=1e-5, atol=1e-9,
                                   err_msg=f"{what}: finish {pn}")
    ia = {k: j for j, k in enumerate(a.factors)}
    ib = {k: j for j, k in enumerate(b.factors)}
    for k in set(ia) | set(ib):
        sa = a.share_seconds[:, ia[k]] if k in ia else np.zeros(a.B)
        sb = b.share_seconds[:, ib[k]] if k in ib else np.zeros(b.B)
        np.testing.assert_allclose(sa, sb, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: shares {k}")


def check_torch_report(rep, what: str) -> None:
    check(set(rep.backends) == {"torch"},
          f"{what}: backends {sorted(set(rep.backends))}, expected torch")
    check(rep.engine_fallback is None,
          f"{what}: engine fell back ({rep.engine_fallback})")


# ------------------------------------------------ recording the main path ----
def kernel_modules():
    """The binding module of each kernel library; each keeps its counts."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ppoly_eval import kernel as pe
    from repro_torch.kernels.wkv6 import kernel as wk

    return pe, fa, wk


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    return {k: n for mod in kernel_modules() for k, n in mod.launches.items()}


class Recorder:
    """Wraps kernel wrappers (``<name>_cuda`` of ``module``) while a path
    runs and keeps every call's inputs, options and outputs, so each can be
    held against the plain version afterwards.  The launch counts stay in
    the wrappers."""

    def __init__(self, module, names):
        self.module = module
        self.names = list(names)
        self.calls: list[tuple[str, tuple, object]] = []
        self.kwargs: list[dict] = []
        self._orig = {}

    def __enter__(self):
        for name in self.names:
            attr = f"{name}_cuda"
            orig = getattr(self.module, attr)
            self._orig[attr] = orig

            def shim(*args, _name=name, _orig=orig, **kw):
                out = _orig(*args, **kw)
                self.calls.append((_name, args, out))
                self.kwargs.append(kw)
                return out

            setattr(self.module, attr, shim)
        return self

    def __exit__(self, *exc):
        for attr, orig in self._orig.items():
            setattr(self.module, attr, orig)
        return False


def max_err(got, want):
    """Max |got - want| over entries the plain version reaches (< 1e29);
    both must agree on which entries are reached."""
    import torch

    reached = want < 1e29
    check(torch.equal(reached, got < 1e29), "reached levels differ")
    if not bool(reached.any()):
        return 0.0
    return float((got - want).abs()[reached].max())


def hold_against_plain(name: str, args, out) -> float:
    """Kernel output vs the plain version on the same inputs; returns the
    max abs error (values; argmin must match wherever the two lowest slot
    values differ by more than the tolerance)."""
    import torch
    from repro_torch.kernels.ppoly_eval import ref

    if name == "ppoly_eval":
        want = ref.ppoly_eval_ref(*args)
        torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
        return float((out - want).abs().max())
    if name == "ppoly_first_crossing":
        want = ref.ppoly_first_crossing_ref(*args)
        torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
        return max_err(out, want)
    starts, coeffs, q = args
    vals, arg = out
    v_r, a_r = ref.ppoly_min_eval_ref(starts, coeffs, q)
    torch.testing.assert_close(vals, v_r, rtol=TOL, atol=TOL)
    diff = arg != a_r
    if bool(diff.any()):
        # per-slot values at the two chosen slots: a mismatch is only allowed
        # where they tie within the tolerance
        per = torch.stack([ref.ppoly_eval_ref(starts[:, f].contiguous(),
                                              coeffs[:, f].contiguous(), q)
                           for f in range(starts.shape[1])], 1)
        vk = torch.gather(per, 1, arg.long()[:, None])[:, 0]
        vr = torch.gather(per, 1, a_r.long()[:, None])[:, 0]
        tied = (vk - vr).abs() <= TOL + TOL * vr.abs()
        check(bool(tied[diff].all()), f"{name}: argmin differs beyond ties")
    return float((vals - v_r).abs().max())


# ------------------------------------------------------ bounds per kernel ----
def bound(name: str, args) -> tuple[float, str, int]:
    """Least time for the work on these inputs: max(bytes moved / memory
    rate, float32 operations / peak rate), each input read once and each
    output written once; data-dependent work counted from these inputs.
    Returns (ms, side, bytes)."""
    starts, coeffs, q = args
    B, T = q.shape
    K = coeffs.shape[-1]
    nbytes = 4 * (starts.numel() + coeffs.numel() + q.numel())
    if name == "ppoly_eval":
        P = starts.shape[1]
        nbytes += 4 * B * T
        ops = B * T * (P + 1 + 2 * K)        # P compares, u, Horner
    elif name == "ppoly_min_eval":
        P = starts.shape[2]
        nbytes += 8 * B * T                  # values and argmin
        present = int((starts[:, :, 0] < 5e29).sum())   # slots per row, summed
        ops = present * T * (P + 1 + 2 * K + 1)
    else:
        nbytes += 4 * B * T
        pieces = int((starts < 5e29).sum())  # valid pieces, summed over rows
        ops = B * T * 3 + pieces * T * 24     # tol; per piece: both branches
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    side = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), side, nbytes


def kernel_ptxas(mod, prefix: str) -> dict:
    """Registers and spill bytes of each kernel of ``mod``'s library whose
    name starts with ``prefix``, from ``ptxas -v`` in the build log beside
    the library; a template instance as ``name<args>``."""
    import re

    from repro_torch.kernels.build import ptxas_usage

    log = Path(mod.library()._name).with_suffix(".log").read_text()
    pat = re.compile(r"\d(" + prefix + r"[a-z0-9_]*?kernel)((?:I(?:Li\d+E)+E)?)")
    out = {}
    for name, use in ptxas_usage(log).items():
        # the length prefix of the mangled name precedes the kernel's name
        m = pat.search(name)
        if not m:
            out[name] = use
            continue
        args = re.findall(r"Li(\d+)E", m.group(2))
        out[f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)] = use
    return out


# -------------------------------------------------------------- phases ----
def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(line, flush=True)
    emit("env", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])
    return line


def phase_build():
    """All kernel libraries at once: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    def one(mod):
        t0 = time.perf_counter()
        lib = mod.library()
        return {"seconds": time.perf_counter() - t0, "library": str(lib._name),
                "flags": list(mod.NVCC_FLAGS)}

    t0 = time.perf_counter()
    mods = kernel_modules()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {mod.SOURCES[0].stem: ex.submit(one, mod) for mod in mods}
        libs = {name: f.result() for name, f in futs.items()}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs)


#: (B, T, P, K, F) of phase_kernels: B and T off the block multiples, T from
#: 1 to 4097; P, K and F inside the "vec" kernels' range (P <= 16, K <= 3,
#: F <= 4) and outside it (P up to 64, F up to 6: the "tile" route only)
KERNEL_CASES = [(1, 1, 1, 1, 1), (7, 129, 3, 2, 3), (37, 1000, 64, 3, 5),
                (513, 77, 17, 1, 2), (2049, 300, 5, 3, 6), (10, 4097, 40, 2, 4),
                (3, 1, 9, 3, 2), (129, 3, 16, 3, 4), (1001, 77, 9, 3, 2),
                (33, 1025, 5, 2, 1), (17, 4097, 12, 1, 3), (64, 1024, 9, 3, 2),
                (250, 1024, 16, 1, 4)]


def kernel_case(rng, B: int, T: int, P: int, K: int, F: int):
    """Seeded ragged inputs: duplicate starts (jumps) in some rows, padding
    pieces, absent slots, monotone pieces (rising values, non-negative slopes
    and curvature), queries beyond both ends, levels never reached."""
    import numpy as np

    starts = np.sort(rng.uniform(0.0, 50.0, (B, F, P)), -1)
    starts[..., 0] = 0.0
    if P > 2:   # a duplicate start (a jump) in some rows
        starts[::3, :, 2] = starts[::3, :, 1]
    n_real = rng.integers(1, P + 1, (B, F))
    starts[np.arange(P)[None, None] >= n_real[..., None]] = 1e30
    absent = rng.random((B, F)) < 0.25
    absent[0, 0] = False
    starts[absent] = 1e30
    coeffs = np.zeros((B, F, P, K))
    coeffs[..., 0] = np.cumsum(rng.uniform(0.0, 20.0, (B, F, P)), -1)
    if K > 1:
        coeffs[..., 1] = rng.uniform(0.0, 3.0, (B, F, P))
    if K > 2:
        coeffs[..., 2] = np.where(rng.random((B, F, P)) < 0.5,
                                  rng.uniform(0.0, 0.3, (B, F, P)), 0.0)
    q = rng.uniform(-2.0, 60.0, (B, T))
    top = coeffs[..., 0].max(-1).max(-1)
    y = rng.uniform(-0.1, 1.5, (B, T)) * (top[:, None] + 1.0)
    return starts, coeffs, q, y


def misaligned(x):
    """A contiguous copy of ``x`` whose address is 4 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    import torch

    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    shift = (1 - flat.data_ptr() % 16 // 4) % 4
    out = flat[shift:shift + x.numel()].view(x.shape)
    out.copy_(x)
    return out


#: each kernel's uncounted launcher of one named route
LAUNCH = {"ppoly_eval": "launch_eval", "ppoly_min_eval": "launch_min_eval",
          "ppoly_first_crossing": "launch_crossing"}


def routes_of(name: str, args) -> tuple[str, ...]:
    """The routes that take the shape of ``args``: "tile" always; where
    P <= 16, K <= 3 and F <= 4 also "vec", for the crossing "row" (at any
    T, beyond the T its wrapper sends there too)."""
    from repro_torch.kernels.ppoly_eval import kernel

    starts, coeffs, _q = args
    F = starts.shape[1] if name == "ppoly_min_eval" else 1
    if kernel.route(starts.shape[-1], coeffs.shape[-1], F) == "tile":
        return ("tile",)
    return ("row", "tile") if name == "ppoly_first_crossing" else ("vec", "tile")


def hold_routes(name: str, args, counts: dict) -> float:
    """Every route that takes the shape, each against the plain version and
    each but "tile" against "tile" bit for bit.  Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.ppoly_eval import kernel

    launch = getattr(kernel, LAUNCH[name])
    outs, worst = {}, 0.0
    for rt in routes_of(name, args):
        outs[rt] = launch(rt, *args)
        torch.cuda.synchronize()
        worst = max(worst, hold_against_plain(name, args, outs[rt]))
        counts[name][rt] = counts[name].get(rt, 0) + 1
    for rt, out in outs.items():
        if rt == "tile":
            continue
        pairs = (zip(out, outs["tile"]) if name == "ppoly_min_eval"
                 else [(out, outs["tile"])])
        for a, b in pairs:
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"{name} {tuple(args[2].shape)}: the {rt} route differs from "
                  f"the tile route")
        counts["bitwise"] += 1
    return worst


def phase_kernels():
    """:data:`KERNEL_CASES`: each kernel through its wrapper (the route
    :func:`kernel.route` names) against the plain version, then on each
    route apart (:func:`hold_routes`), and once more with a q (or y) that
    is not 16-byte aligned."""
    import numpy as np
    import torch
    from repro_torch.kernels.ppoly_eval import kernel

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = {n: 0.0 for n in KERNELS}
    counts = {**{n: {} for n in KERNELS}, "bitwise": 0, "misaligned": 0}
    cases = 0
    for B, T, P, K, F in KERNEL_CASES:
        starts, coeffs, q, y = kernel_case(rng, B, T, P, K, F)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),  # noqa: E731
                                      device=dev)
        calls = [
            ("ppoly_eval", (t(starts[:, 0]), t(coeffs[:, 0]), t(q))),
            ("ppoly_min_eval", (t(starts), t(coeffs), t(q))),
            ("ppoly_first_crossing", (t(starts[:, 0]), t(coeffs[:, 0]), t(y))),
        ]
        for name, args in calls:
            out = getattr(kernel, f"{name}_cuda")(*args)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], hold_against_plain(name, args, out))
            worst[name] = max(worst[name], hold_routes(name, args, counts))
            if T > 1:
                shifted = (*args[:2], misaligned(args[2]))
                worst[name] = max(worst[name], hold_routes(name, shifted, counts))
                counts["misaligned"] += 1
            cases += 1
    emit("kernels", cases=cases, tol=TOL, max_abs_err=worst, route_calls=counts)


# ------------------------------------------------------ flash attention ----
def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, summed over the S rows."""
    total = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_bound(q, k, v, causal: bool, window) -> tuple[float, str]:
    """max(bytes / memory rate, 4 B H D pairs / bf16 tensor-core rate): q, k
    and v read once, the output written once."""
    B, H, S, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops = 4 * B * H * D * attended_pairs(S, causal, window)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_err(out, args, kw) -> dict:
    """One flash call against the plain version on the same inputs in
    float32, with the bars of ``flash_failures``: max abs and relative L2;
    for bf16 also every element within 2^-8 (|want| + P|V|) + 2e-5, the
    output's and the probabilities' rounding to bf16 (P|V| is the plain
    version with |v|)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref, flash_error,
                                                      flash_failures)

    q, k, v = (a.float() for a in args)
    want = attention_ref(q, k, v, **kw)
    pv = attention_ref(q, k, v.abs(), **kw) if out.dtype == torch.bfloat16 else None
    err = flash_error(out, want, pv)
    del q, k, v, want, pv
    bad = flash_failures(err, out.dtype)
    check(not bad, f"flash_attention {tuple(args[0].shape)} {out.dtype} {kw}: "
                   + "; ".join(bad))
    return {key: err[key] for key in ("max_abs_err", "rel_l2", "elem_ratio")}


def attention_rows(q, kr, vr, var, row0: int, *, causal: bool, window):
    """The plain version for the query rows row0 .. row0 + R - 1 that ``q``
    (B, H, R, D) holds, against float32 keys and values with their heads
    already repeated to H (``var`` is |vr|): ``attention_ref``'s arithmetic
    with the masks offset by row0, over the keys up to the last row when
    causal.  Returns (want, P|V|)."""
    import torch

    R, D = q.shape[2], q.shape[3]
    hi = min(kr.shape[2], row0 + R) if causal else kr.shape[2]
    s = torch.matmul(q, kr[:, :, :hi].transpose(-1, -2))
    s /= torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    qi = torch.arange(row0, row0 + R, device=q.device)[:, None]
    kj = torch.arange(hi, device=q.device)[None, :]
    mask = torch.ones((R, hi), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s.masked_fill_(~mask, float("-inf"))
    s -= s.amax(dim=-1, keepdim=True)
    s.exp_()
    s /= s.sum(dim=-1, keepdim=True)
    return torch.matmul(s, vr[:, :, :hi]), torch.matmul(s, var[:, :, :hi])


def flash_long() -> dict:
    """The tensor-core kernel once at the prefill_32k length, causal, held
    against the plain version FLASH_LONG_ROWS query rows at a time (scores
    under 9 GB a block); its time by CUDA events."""
    import math

    import torch
    from repro_torch.kernels.flash_attention import flash_error, flash_failures
    from repro_torch.kernels.flash_attention import kernel as fa

    B, H, Hkv, S, D = FLASH_LONG
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    check(fa.route(q.dtype, D) == "tc", "the S = 32,768 call is not on the tensor cores")
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), iters=3)
    kr = k.float().repeat_interleave(H // Hkv, 1)
    vr = v.float().repeat_interleave(H // Hkv, 1)
    var = vr.abs()
    errs = []
    for r0 in range(0, S, FLASH_LONG_ROWS):
        want, pv = attention_rows(q[:, :, r0:r0 + FLASH_LONG_ROWS].float(), kr, vr,
                                  var, r0, causal=True, window=None)
        errs.append(flash_error(out[:, :, r0:r0 + FLASH_LONG_ROWS], want, pv))
        del want, pv
    del kr, vr, var
    err = {"max_abs_err": max(e["max_abs_err"] for e in errs),
           "rel_l2": math.sqrt(sum(e["diff_sq"] for e in errs)
                               / sum(e["want_sq"] for e in errs)),
           "elem_ratio": max(e["elem_ratio"] for e in errs)}
    bad = flash_failures(err, torch.bfloat16)
    check(not bad, f"flash_attention at S = {S}: " + "; ".join(bad))
    b_ms, b_by = flash_bound(q, k, v, True, None)
    flops = 4 * B * H * D * attended_pairs(S, True, None)
    return {"shape": list(FLASH_LONG), "row_blocks": len(errs), **err, "ms": ms,
            "tflops": flops / ms / 1e9, "bound_ms": b_ms, "bound_by": b_by}


def worst_of(errs: list[dict]) -> dict:
    """Elementwise worst of several :func:`flash_err` (or :func:`wkv_err`)
    results."""
    out = {}
    for key in errs[0] if errs else ():
        vals = [e[key] for e in errs if e[key] == e[key]]
        out[key] = max(vals) if vals else None
    return out


def phase_flash_kernels():
    """Seeded random shapes: MHA, GQA groups 2 and 8, MQA; D in {16, 64,
    120, 128}; S in {1, 37, 128, 300}; window None or 32; causal=False
    twice; float32 (the float32 kernel) and bf16 (the tensor-core kernel);
    then one bf16 call at S = 32,768 (:func:`flash_long`)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    heads = {"mha": (4, 4), "gqa2": (4, 2), "gqa8": (16, 2), "mqa": (4, 1)}
    errs = {"float32": [], "bfloat16": []}
    shapes = [(hk, D, S, w, True) for hk in heads for D in (16, 64, 120, 128)
              for S in (1, 37, 128, 300) for w in (None, 32)]
    shapes += [("gqa2", 120, 300, None, False), ("mqa", 64, 37, 32, False)]
    routes = {"tc": 0, "f32": 0}
    for hk, D, S, w, causal in shapes:
        H, Hkv = heads[hk]
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((2, H, S, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((2, Hkv, S, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((2, Hkv, S, D), generator=gen, device="cuda").to(dtype)
            kw = {"causal": causal, "window": w}
            out = fa.flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            routes[fa.route(dtype, D)] += 1
            errs[str(dtype).split(".")[-1]].append(flash_err(out, (q, k, v), kw))
    worst = {name: worst_of(e) for name, e in errs.items()}
    long = flash_long()
    emit("flash_kernels", cases=sum(map(len, errs.values())), routes=routes,
         tol={"float32": 2e-5, "bfloat16": 0.03},
         rel_l2_tol={"float32": 1e-5, "bfloat16": 4e-3},
         elem_bar="2**-8 (|want| + P|V|) + 2e-05 (bf16)",
         max_abs_err={n: w["max_abs_err"] for n, w in worst.items()},
         rel_l2={n: w["rel_l2"] for n, w in worst.items()},
         elem_ratio=worst["bfloat16"]["elem_ratio"], long_case=long)
    return long


def phase_lm_prefill():
    """yi-9b at full width in bf16, weights from init_params(seed=0) on the
    card; prefill of B x S seeded tokens, every flash call recorded and held
    against the plain version.  Returns (cfg, model, launches, errors, the
    first call's inputs)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg = get_config(LM_ARCH)
    init_s, tree = host_s(lambda: init_params(cfg, seed=0))
    model = T.DecoderLM(cfg, tree)
    del tree
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                                     generator=gen, device="cuda")}
    with torch.inference_mode():
        with Recorder(fa, ["flash_attention"]) as rec:
            reset_launches()
            cold_s, last = host_s(lambda: T.prefill(model, cfg, batch))
            launches = read_launches()
        check(launches["flash_attention"] == cfg.n_layers,
              f"{launches['flash_attention']} flash launches, {cfg.n_layers} layers")
        check(launches["flash_attention_tc"] == cfg.n_layers,
              f"{launches['flash_attention_tc']} of {cfg.n_layers} flash launches "
              "on the tensor-core kernel")
        check(tuple(last.shape) == (LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(last).all()), "prefill logits")
        errs = [flash_err(out, args, kw)
                for (_n, args, out), kw in zip(rec.calls, rec.kwargs)]
        first = (rec.calls[0][1], rec.kwargs[0])
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        warm_s, last2 = host_s(lambda: T.prefill(model, cfg, batch))
        peak = torch.cuda.max_memory_allocated()
        drift = float((last2.float() - last.float()).abs().max())
    emit("lm_prefill", arch=cfg.name, dtype=cfg.dtype, batch=LM_BATCH,
         seq=LM_SEQ, n_params=cfg.n_params(), weight_bytes=weight_bytes,
         init_s=init_s, cold_s=cold_s, warm_s=warm_s,
         tok_s=LM_BATCH * LM_SEQ / warm_s, peak_memory_bytes=peak,
         launches=launches, flash_calls=len(errs), **worst_of(errs),
         tol=0.03, rel_l2_tol=4e-3, elem_bar="2**-8 (|want| + P|V|) + 2e-05",
         rerun_max_abs_diff=drift)
    return cfg, model, launches, worst_of(errs)["max_abs_err"], first


def phase_lm_serve(cfg, model):
    """The serving launcher as a user calls it, then prefill of the same
    prompts (S = 32, ragged for the kernel) against the decode path's
    logits after the last prompt token, beside the bf16 batch-split floor:
    the same prompts prefilled one by one against the batch."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    reset_launches()
    out = serve.main(["--arch", LM_ARCH, "--no-smoke"])
    launches = read_launches()
    gen = out["continuations"]
    check(gen.shape == (8, 16) and out["requests"] == 8, f"served {gen.shape}")
    prompts = torch.as_tensor(out["prompts"], device="cuda")
    with torch.inference_mode():
        with Recorder(fa, ["flash_attention"]) as rec:
            last = T.prefill(model, cfg, {"tokens": prompts})
            errs = [flash_err(o, args, kw) for (_n, args, o), kw in zip(rec.calls, rec.kwargs)]
        del rec
        alone = torch.cat([T.prefill(model, cfg, {"tokens": prompts[i:i + 1]})
                           for i in range(prompts.shape[0])])
    dec = out["prompt_logits"]
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    rel = rel_l2(dec, last)
    floor = rel_l2(alone, last)
    check(rel < SERVE_TOL, f"prefill vs decode logits: relative L2 {rel}")
    agree = float((last.float().cpu().argmax(-1) == dec.argmax(-1)).float().mean())
    trace = trace_decode(cfg, model, out["requests"],
                         out["prompt_len"] + out["generated"])
    emit("lm_serve", arch=out["arch"], requests=out["requests"],
         prompt_len=out["prompt_len"], generated=out["generated"],
         wall_s=out["wall_s"], tok_s=out["tok_s"],
         median_step_ms=out["median_step_ms"], sample=out["sample"],
         launches=launches, crosscheck_rel_l2=rel, crosscheck_tol=SERVE_TOL,
         crosscheck_floor=floor,
         crosscheck_argmax_agree=agree, crosscheck_flash_calls=len(errs),
         **{f"crosscheck_flash_{k}": v for k, v in worst_of(errs).items()},
         decode_trace=trace)


def trace_decode(cfg, model, batch: int, context: int, steps: int = 3) -> dict:
    """torch.profiler over a few eager decode steps: host time, device busy
    time (the sum of kernel times) and kernels per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        cache = T.init_cache(cfg, batch, context)
        tok = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
        T.decode_step(model, cfg, cache, {"tokens": tok}, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(1, steps + 1):
                T.decode_step(model, cfg, cache, {"tokens": tok}, t)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / steps
    # device-side events (kernels, copies, sets) of the one stream; none if
    # the profiler traced no device activity
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / steps / 1e3
    return {"steps": steps, "host_ms_per_step": host * 1e3,
            "device_busy_ms_per_step": busy if kernels else None,
            "idle_share": 1.0 - busy / (host * 1e3) if kernels else None,
            "kernels_per_step": len(kernels) / steps}


def flash_row(launches: dict, err: float, first, long: dict) -> dict:
    """Times at the lm_prefill shape: the kernel (CUDA events, the smaller
    of two runs around the plain version), the plain version, the float32
    kernel on the same inputs in float32, and scaled_dot_product_attention
    as the yardstick (its error against the plain version logged beside the
    kernel's, never held to a bar)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_error
    from repro_torch.kernels.flash_attention import kernel as fa

    (q, k, v), kw = first
    check(kw["window"] is None and kw["causal"], f"prefill call options {kw}")
    B, H, S, D = q.shape
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters=10)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=3)
    ms2 = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters=10)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = cuda_ms(lambda: fa.flash_attention_cuda(qf, kf, vf, **kw), iters=3)
    try:
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
        lib_fn()
    except TypeError:            # a torch without enable_gqa: repeat K and V
        g = H // k.shape[1]
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kr, vr, is_causal=True)
    library_ms = cuda_ms(lib_fn, iters=10)
    want = attention_ref(qf, kf, vf, **kw)
    pv = attention_ref(qf, kf, vf.abs(), **kw)
    lib_err = flash_error(lib_fn(), want, pv)
    del qf, kf, vf, want, pv
    b_ms, b_by = flash_bound(q, k, v, kw["causal"], kw["window"])
    flops = 4 * B * H * D * attended_pairs(S, kw["causal"], kw["window"])
    best = min(ms, ms2)
    return {**FLASH, "launches": launches["flash_attention"],
            "launches_tc": launches["flash_attention_tc"], "max_abs_err": err,
            "ms": best, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "tflops": flops / best / 1e9,
            "f32_kernel_ms": f32_ms,
            "library_err": {key: lib_err[key] for key in
                            ("max_abs_err", "rel_l2", "elem_ratio")},
            "shape": {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)},
            "long_shape": long}


# ------------------------------------------------------------------ wkv6 ----
def wkv_inputs(gen, B: int, L: int, H: int, N: int, scale: float = 2.0):
    """As tests/test_kernel_wkv6.py makes them: r, k, v normal, w =
    exp(-exp(scale * normal)), u = 0.1 normal, s0 = 0.2 normal."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = randn(B, L, H, N), randn(B, L, H, N), randn(B, L, H, N)
    w = torch.exp(-torch.exp(scale * randn(B, L, H, N)))
    return r, k, v, w, 0.1 * randn(H, N), 0.2 * randn(B, H, N, N)


def wkv_err(out, args, kw) -> dict:
    """One wkv6 call against the plain version on the same inputs (the
    same ``chunk`` and ``compute_dtype``), on y and on s_final: max abs
    error (and its ratio to the bar 2e-3 * max(1, max |plain|), held in
    float32) and relative L2 error (WKV_REL_L2 in float32,
    WKV_BF16_REL_L2 in the bf16 mode)."""
    import torch
    from repro_torch.kernels.wkv6 import wkv_chunked_ref

    bf16 = kw.get("compute_dtype") == torch.bfloat16
    res = {"max_abs_err": 0.0, "rel_l2": 0.0, "bar_ratio": 0.0}
    what = f"wkv6 {tuple(args[0].shape)} {kw}"
    for name, got, want in zip(("y", "s_final"), out, wkv_chunked_ref(*args, **kw)):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{what}: {name} shape {tuple(got.shape)} or not finite")
        diff = (got - want).abs()
        err = float(diff.max())
        bar = WKV_ABS * max(1.0, float(want.abs().max()))
        rel = float(torch.linalg.vector_norm(diff) /
                    torch.linalg.vector_norm(want).clamp(min=1e-30))
        check(bf16 or err <= bar, f"{what}: {name} max abs error {err} > {bar}")
        check(rel <= (WKV_BF16_REL_L2 if bf16 else WKV_REL_L2),
              f"{what}: {name} relative L2 error {rel}")
        res = {"max_abs_err": max(res["max_abs_err"], err),
               "rel_l2": max(res["rel_l2"], rel),
               "bar_ratio": max(res["bar_ratio"], err / bar)}
    return res


def wkv_bound(args, chunk: int) -> tuple[float, str]:
    """max(bytes / memory rate, float32 operations / float32 rate).  Bytes:
    r, k, v, w, u and s0 read once, y and s_final written once.  Operations
    per chunk of R tokens and head: the two state contractions (2 R N^2
    each), 7 per pairwise decay term over the R(R-1)/2 pairs (subtract, exp,
    two multiplies and an add for att; a multiply and an add for att . v),
    and 8 per token and channel (log, diag, the two decays)."""
    r, k, v, w, u, s0 = args
    B, L, H, N = r.shape
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())

    def per_chunk(R: int) -> int:
        return 4 * R * N * N + 7 * (R * (R - 1) // 2) * N + 8 * R * N

    full, rem = divmod(L, chunk)
    ops = B * H * (full * per_chunk(chunk) + (per_chunk(rem) if rem else 0))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_wkv6_kernels():
    """The cases of tests/test_kernel_wkv6.py (single chunk, state carried,
    chunk 16, head size 64, ragged L, near-zero decays) plus one token, the
    decode shape, a head size that is not a multiple of 4 and 65 chunks, at
    their chunk and again at chunk 64; then one call at the prefill_32k
    length, which carries the state over 1,024 chunks (and is timed on each
    route).  Every case runs on both routes (the chunked and the serial
    kernels each take any L)."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 1, 1, 8, 32, 2.0), (1, 32, 1, 8, 32, 2.0), (2, 96, 2, 16, 32, 2.0),
             (1, 80, 3, 8, 16, 2.0), (2, 64, 2, 64, 32, 2.0), (1, 50, 2, 8, 32, 2.0),
             (1, 64, 1, 8, 32, 3.5), (8, 1, 32, 64, 32, 2.0), (2, 333, 2, 22, 16, 3.5),
             (1, 4133, 2, 64, 64, 2.0)]
    cases += [(B, L, H, N, 64, sc) for B, L, H, N, _c, sc in cases]
    cases.append((*WKV_LONG, 32, 2.0))
    run = {"chunked": wk.launch_chunked, "serial": wk.launch_serial}
    errs = {rt: [] for rt in wk.ROUTES}
    long = {}
    for B, L, H, N, chunk, scale in cases:
        args = wkv_inputs(gen, B, L, H, N, scale)
        for rt in wk.ROUTES:
            out = run[rt](*args, chunk=chunk)
            torch.cuda.synchronize()
            errs[rt].append(wkv_err(out, args, {"chunk": chunk}))
            del out
        if (B, L, H, N) == WKV_LONG:
            long = {rt: {**errs[rt][-1], "ms": cuda_ms(
                lambda rt=rt: run[rt](*args, chunk=chunk), iters=3)}
                for rt in wk.ROUTES}
    emit("wkv6_kernels", cases=len(cases), routes=list(wk.ROUTES),
         long_case=list(WKV_LONG), long=long,
         tol=f"{WKV_ABS} max(1, max|plain|)", rel_l2_tol=WKV_REL_L2,
         **{rt: worst_of(e) for rt, e in errs.items()})


def phase_lm_prefill_rwkv():
    """rwkv6-1.6b at full width in bf16, weights from init_params(seed=0)
    on the card; prefill of B x S seeded tokens, every wkv6 call recorded
    and held against the plain version.  Returns (cfg, model, launches,
    worst error, the first call's inputs)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg = get_config(RWKV_ARCH)
    init_s, tree = host_s(lambda: init_params(cfg, seed=0))
    model = T.DecoderLM(cfg, tree)
    del tree
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                                     generator=gen, device="cuda")}
    with torch.inference_mode():
        with Recorder(wk, ["wkv6"]) as rec:
            reset_launches()
            cold_s, last = host_s(lambda: T.prefill(model, cfg, batch))
            launches = read_launches()
        check(launches["wkv6"] == launches["wkv6_chunked"] == cfg.n_layers,
              f"{launches['wkv6']} wkv6 calls, {launches['wkv6_chunked']} on the "
              f"chunked route, {cfg.n_layers} layers")
        check(tuple(last.shape) == (LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(last).all()), "prefill logits")
        errs = [wkv_err(out, args, kw)
                for (_n, args, out), kw in zip(rec.calls, rec.kwargs)]
        first = (rec.calls[0][1], rec.kwargs[0])
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        warm_s, last2 = host_s(lambda: T.prefill(model, cfg, batch))
        peak = torch.cuda.max_memory_allocated()
        drift = float((last2.float() - last.float()).abs().max())
    emit("lm_prefill_rwkv", arch=cfg.name, dtype=cfg.dtype, batch=LM_BATCH,
         seq=LM_SEQ, n_params=cfg.n_params(), weight_bytes=weight_bytes,
         init_s=init_s, cold_s=cold_s, warm_s=warm_s,
         tok_s=LM_BATCH * LM_SEQ / warm_s, peak_memory_bytes=peak,
         launches=launches, wkv6_calls=len(errs), **worst_of(errs),
         tol=f"{WKV_ABS} max(1, max|plain|)", rel_l2_tol=WKV_REL_L2,
         rerun_max_abs_diff=drift)
    return cfg, model, launches, worst_of(errs)["max_abs_err"], first


def rel_l2(got, want) -> float:
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def phase_lm_serve_rwkv(cfg, model) -> int:
    """The serving launcher with rwkv6-1.6b, then prefill of the same
    prompts against the decode path's logits after the last prompt token.

    In bf16 two prefills of the same prompts already differ by about 5e-2
    (relative L2) when only the batch split, and so the shapes of the bf16
    products, differ: the bf16 residual stream rounds the small differences
    into whole bf16 steps, layer after layer.  So the bf16 decode is held
    within ``RWKV_FLOOR_FACTOR`` times that floor, measured here, and the
    same weights in float32 are held to ``RWKV_F32_TOL``.  Returns the wkv6
    launches of the serving run."""
    import copy
    import dataclasses

    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    reset_launches()
    out = serve.main(["--arch", RWKV_ARCH, "--no-smoke"])
    launches = read_launches()
    gen = out["continuations"]
    steps = out["prompt_len"] + out["generated"]
    check(gen.shape == (8, 16) and out["requests"] == 8, f"served {gen.shape}")
    check(launches["wkv6"] == launches["wkv6_serial"] == cfg.n_layers * steps,
          f"{launches['wkv6']} wkv6 calls, {launches['wkv6_serial']} on the serial "
          f"route, {cfg.n_layers} layers x {steps} steps")
    prompts = torch.as_tensor(out["prompts"], device="cuda")
    with torch.inference_mode():
        with Recorder(wk, ["wkv6"]) as rec:
            last = T.prefill(model, cfg, {"tokens": prompts})
            errs = [wkv_err(o, args, kw) for (_n, args, o), kw in zip(rec.calls, rec.kwargs)]
        del rec
        alone = torch.cat([T.prefill(model, cfg, {"tokens": prompts[i:i + 1]})
                           for i in range(prompts.shape[0])])
    dec = out["prompt_logits"]
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    rel = rel_l2(dec, last)
    floor = rel_l2(alone, last)
    bar = max(RWKV_FLOOR_FACTOR * floor, RWKV_F32_TOL)
    check(rel <= bar, f"bf16 prefill vs decode logits: relative L2 {rel} > {bar} "
                      f"(batch-split floor {floor})")
    agree = float((last.float().cpu().argmax(-1) == dec.argmax(-1)).float().mean())
    # the same weights in float32: prefill against the cached decode
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = copy.deepcopy(model).float()
    with torch.inference_mode():
        last32 = T.prefill(m32, cfg32, {"tokens": prompts})
        cache = T.init_cache(cfg32, prompts.shape[0], prompts.shape[1])
        for t in range(prompts.shape[1]):
            dec32, cache = T.decode_step(m32, cfg32, cache,
                                         {"tokens": prompts[:, t:t + 1]}, t)
    rel32 = rel_l2(dec32, last32)
    check(rel32 < RWKV_F32_TOL, f"float32 prefill vs decode logits: relative L2 {rel32}")
    bf16_vs_f32 = rel_l2(last, last32)
    del m32, cache, last32, dec32
    torch.cuda.empty_cache()
    trace = trace_decode(cfg, model, out["requests"], steps)
    emit("lm_serve_rwkv", arch=out["arch"], requests=out["requests"],
         prompt_len=out["prompt_len"], generated=out["generated"],
         wall_s=out["wall_s"], tok_s=out["tok_s"],
         median_step_ms=out["median_step_ms"], sample=out["sample"],
         launches=launches, crosscheck_rel_l2=rel, crosscheck_floor=floor,
         crosscheck_tol=bar,
         crosscheck_argmax_agree=agree, crosscheck_f32_rel_l2=rel32,
         crosscheck_f32_tol=RWKV_F32_TOL, prefill_bf16_vs_f32_rel_l2=bf16_vs_f32,
         crosscheck_wkv6_calls=len(errs),
         **{f"crosscheck_wkv6_{k}": v for k, v in worst_of(errs).items()},
         decode_trace=trace)
    return launches


def wkv_row(launches: dict, err: float, first) -> dict:
    """Times at the lm_prefill_rwkv shape by CUDA events: the op (the
    chunked route; the smaller of two runs around the plain version), its
    two phases apart, the serial kernel on the same inputs, the plain
    version; and at the decode shape (B = 8, L = 1): the op (the serial
    route), the chunked route on the same inputs, the plain version.  The
    chunked route's scratch bytes.  No single PyTorch call computes this
    recurrence, so no library time."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv_chunked_ref

    args, kw = first
    chunk = kw["chunk"]
    r = args[0]
    B, L, H, N = r.shape
    check(wk.route(L, chunk) == "chunked", f"prefill call takes {wk.route(L, chunk)}")
    ms = cuda_ms(lambda: wk.wkv6_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: wkv_chunked_ref(*args, **kw), iters=3)
    ms2 = cuda_ms(lambda: wk.wkv6_cuda(*args, **kw))
    serial_ms = cuda_ms(lambda: wk.launch_serial(*args, **kw), iters=5)
    y, scratch = wk.launch_intra(*args, **kw)
    phase_ms = [cuda_ms(lambda: wk.launch_intra(*args, **kw)),
                cuda_ms(lambda: wk.launch_scan(args[5], y, scratch, chunk=chunk))]
    scratch_bytes = 4 * scratch.numel()
    del y, scratch
    b_ms, b_by = wkv_bound(args, chunk)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dec = wkv_inputs(gen, 8, 1, H, N)
    check(wk.route(1, chunk) == "serial", "decode call takes the chunked route")
    dec_ms = cuda_ms(lambda: wk.wkv6_cuda(*dec, **kw), iters=100)
    dec_chunked_ms = cuda_ms(lambda: wk.launch_chunked(*dec, **kw), iters=100)
    dec_plain_ms = cuda_ms(lambda: wkv_chunked_ref(*dec, **kw), iters=20)
    dec_bound, dec_by = wkv_bound(dec, chunk)
    return {**WKV6, "launches": launches["wkv6"],
            "launches_chunked": launches["wkv6_chunked"],
            "launches_serial": launches["wkv6_serial"],
            "launches_by_phase": launches["by_phase"],
            "max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes the wkv recurrence",
            "phase1_ms": phase_ms[0], "phase2_ms": phase_ms[1],
            "serial_kernel_ms": serial_ms, "scratch_bytes": scratch_bytes,
            "ptxas": kernel_ptxas(wk, "wkv6_"),
            "shape": {"r": list(r.shape), "chunk": chunk, "dtype": str(r.dtype)},
            "decode_shape": {"r": list(dec[0].shape), "ms": dec_ms,
                             "chunked_ms": dec_chunked_ms,
                             "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
                             "bound_by": dec_by}}


def phase_wkv6_bf16_kernels():
    """wkv6's bf16 mode (the rwkv_bf16 variant) on both routes against the
    bf16 plain version on the same card tensors, at WKV_BF16_CASES, chunk
    32; each also against the float32 kernel (what the rounding moves).  The
    bf16 and float32 chunked routes timed in turns at the prefill shape, the
    serial routes at the decode shape.  Returns the bf16 chunked call's
    inputs at the prefill shape."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv_chunked_ref

    t0 = time.perf_counter()
    bf = {"chunk": 32, "compute_dtype": torch.bfloat16}
    run = {"chunked": wk.launch_chunked, "serial": wk.launch_serial}
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases, times, prefill = [], {}, None
    for B, L, H, N, with_s0 in WKV_BF16_CASES:
        args = wkv_inputs(gen, B, L, H, N)
        if not with_s0:
            args = (*args[:5], torch.zeros_like(args[5]))
        f32 = wk.launch_chunked(*args, chunk=32)
        case = {"shape": [B, L, H, N], "s0": with_s0}
        for rt in wk.ROUTES:
            out = run[rt](*args, **bf)
            torch.cuda.synchronize()
            case[rt] = {**wkv_err(out, args, bf),
                        "rel_l2_vs_f32_kernel": max(rel_l2(o, w) for o, w in zip(out, f32))}
            del out
        cases.append(case)
        if (B, L) == (2, 4096):
            prefill = (args, bf)
            times["prefill"] = {"f32_ms": cuda_ms(lambda: run["chunked"](*args, chunk=32)),
                                "bf16_ms": cuda_ms(lambda: run["chunked"](*args, **bf))}
            times["prefill"]["bf16_ms_2"] = cuda_ms(lambda: run["chunked"](*args, **bf))
            times["prefill"]["f32_ms_2"] = cuda_ms(lambda: run["chunked"](*args, chunk=32))
            times["prefill"]["plain_bf16_ms"] = cuda_ms(
                lambda: wkv_chunked_ref(*args, **bf), iters=3)
        if L == 1:
            times["decode"] = {"f32_ms": cuda_ms(lambda: run["serial"](*args, chunk=32),
                                                 iters=100),
                               "bf16_ms": cuda_ms(lambda: run["serial"](*args, **bf),
                                                  iters=100)}
        del f32
    emit("wkv6_bf16_kernels", cases=cases, times=times, rel_l2_tol=WKV_BF16_REL_L2,
         seconds=time.perf_counter() - t0)
    return prefill


def phase_lm_rwkv_bf16(prefill_case) -> tuple[dict, dict]:
    """rwkv6-1.6b at full width and depth in bf16 with the rwkv_bf16
    variant, its weights those of the default model (init_params(seed=0)):
    the lm_prefill_rwkv prefill and RWKV_BF16_DECODE cached decode steps,
    every wkv6 call counted under wkv6_bf16 and held against the bf16 plain
    version; the logits against the default variant's at RWKV_BF16_TOL.
    Returns (launches, the wkv6_bf16 kernel row)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv_chunked_ref
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    t0 = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    var = dataclasses.replace(cfg, rwkv_bf16=True)
    tree = init_params(cfg, seed=0)
    base, model = T.DecoderLM(cfg, tree), T.DecoderLM(var, tree)
    del tree
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                                     generator=gen, device="cuda")}

    def decode(m, c):
        cache = T.init_cache(c, LM_BATCH, RWKV_BF16_DECODE)
        steps = []
        for t in range(RWKV_BF16_DECODE):
            logits, cache = T.decode_step(m, c, cache,
                                          {"tokens": batch["tokens"][:, t:t + 1]}, t)
            steps.append(logits)
        return steps

    with torch.inference_mode():
        want, want_steps = T.prefill(base, cfg, batch), decode(base, cfg)
        # the prefill's calls are held against the plain version afterwards;
        # a decode call's s0 is the cache's state, updated in place after it
        # (the serial route is held in wkv6_bf16_kernels)
        reset_launches()
        with Recorder(wk, ["wkv6"]) as rec:
            secs, got = host_s(lambda: T.prefill(model, var, batch))
        dsecs, got_steps = host_s(lambda: decode(model, var))
        launches = read_launches()
        errs = [wkv_err(out, args, kw) for (_n, args, out), kw in zip(rec.calls, rec.kwargs)]
        del rec
    n = cfg.n_layers
    check(launches["wkv6"] == 0 and launches["wkv6_bf16"] == n * (1 + RWKV_BF16_DECODE)
          and launches["wkv6_bf16_chunked"] == n
          and launches["wkv6_bf16_serial"] == n * RWKV_BF16_DECODE,
          f"rwkv_bf16: launches {launches}")
    check(all(bool(torch.isfinite(x).all()) for x in [got, *got_steps]), "logits not finite")
    rel = rel_l2(got, want)
    rel_steps = [rel_l2(g, w) for g, w in zip(got_steps, want_steps)]
    check(max(rel, *rel_steps) <= RWKV_BF16_TOL,
          f"rwkv_bf16 logits against the default: prefill {rel}, decode {rel_steps}")
    del base, model, want, got, want_steps, got_steps
    torch.cuda.empty_cache()
    worst = worst_of(errs)
    emit("lm_rwkv_bf16", arch=cfg.name, dtype=cfg.dtype, variant="rwkv_bf16",
         batch=LM_BATCH, seq=LM_SEQ, decode_steps=RWKV_BF16_DECODE, prefill_s=secs,
         decode_s=dsecs,
         launches=launches, wkv6_calls=len(errs), **worst,
         rel_l2_tol=WKV_BF16_REL_L2, prefill_rel_l2_vs_default=rel,
         decode_rel_l2_vs_default=rel_steps, tol_vs_default=RWKV_BF16_TOL,
         seconds=time.perf_counter() - t0)
    # the kernel row: the bf16 chunked route at the prefill shape
    args, kw = prefill_case
    ms = cuda_ms(lambda: wk.wkv6_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: wkv_chunked_ref(*args, **kw), iters=3)
    ms2 = cuda_ms(lambda: wk.wkv6_cuda(*args, **kw))
    b_ms, b_by = wkv_bound(args, kw["chunk"])
    row = {"name": "wkv6_bf16", "route": "cuda", "source": WKV6["source"],
           "replaces": WKV6["replaces"],
           "replaces_note": ("the same TPU kernel's work in the reference's bf16 form, "
                             "which is XLA there (src/repro/models/rwkv.py:45), not "
                             "Pallas: the wkv6 kernels' bf16 mode"),
           "launches": launches["wkv6_bf16"],
           "launches_chunked": launches["wkv6_bf16_chunked"],
           "launches_serial": launches["wkv6_bf16_serial"],
           "launches_by_phase": {"lm_rwkv_bf16": launches["wkv6_bf16"]},
           "max_abs_err": worst["max_abs_err"], "rel_l2": worst["rel_l2"],
           "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None,
           "library_note": "no single PyTorch call computes the wkv recurrence",
           "shape": {"r": list(args[0].shape), "chunk": kw["chunk"],
                     "compute_dtype": "bfloat16"}}
    return launches, row


def phase_attn_bf16_card():
    """yi-9b at full width cut to ATTN_BF16_LAYERS layers, bf16: one prefill
    without and one with attn_bf16, the same weights.  On the card
    attention goes through the flash kernel, which computes its softmax in
    float32 whatever the variant says (as the reference's TPU route does):
    the logits are equal bit for bit."""
    import dataclasses

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    t0 = time.perf_counter()
    cfg, reduced = cut_config(LM_ARCH, ATTN_BF16_LAYERS)
    var = dataclasses.replace(cfg, attn_f32=False)
    tree = init_params(cfg, seed=0)
    base, model = T.DecoderLM(cfg, tree), T.DecoderLM(var, tree)
    del tree
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                                     generator=gen, device="cuda")}
    with torch.inference_mode():
        reset_launches()
        want = T.prefill(base, cfg, batch)
        got = T.prefill(model, var, batch)
        torch.cuda.synchronize()
        launches = read_launches()
    check(launches["flash_attention_tc"] == 2 * ATTN_BF16_LAYERS,
          f"attn_bf16: launches {launches}")
    check(torch.equal(got, want), "attn_bf16 changed the kernel route's logits")
    del base, model
    torch.cuda.empty_cache()
    emit("attn_bf16_card", arch=cfg.name, reduced=reduced, dtype=cfg.dtype,
         batch=LM_BATCH, seq=LM_SEQ, variant="attn_bf16", bitwise_equal=True,
         launches=launches, seconds=time.perf_counter() - t0)
    return launches


def phase_sweep_fig7(paper):
    import numpy as np

    plan = paper.compile_paper_plan(0.5)
    check(plan.device.type == "cuda", f"plan on {plan.device}")
    pack = plan.prepare(paper.sweep_scenarios(np.linspace(0.02, 0.98, 600)))
    cold, rep = host_s(lambda: plan.sweep(pack, backend="torch"))
    warm, rep2 = host_s(lambda: plan.sweep(pack, backend="torch"))
    check_torch_report(rep, "sweep_fig7")
    np.testing.assert_array_equal(rep.makespans, rep2.makespans)
    i, label, ms = rep.top_k(1)[0]
    check(label == FIG7_BEST[0] and abs(ms - FIG7_BEST[1]) < 1e-4,
          f"best {label} {ms}, expected {FIG7_BEST}")
    numpy_s, rep_np = host_s(lambda: plan.sweep(pack, backend="numpy"))
    assert_match(rep, rep_np, "sweep_fig7 vs numpy")
    gold = plan.sweep(plan.prepare(paper.sweep_scenarios([0.50, 0.95])),
                      backend="torch")
    check_torch_report(gold, "goldens")
    for j, frac in enumerate((0.50, 0.95)):
        np.testing.assert_allclose(gold.makespans[j], GOLDEN[frac], rtol=1e-6)
    emit("sweep_fig7", B=rep.B, best=label, makespan=ms,
         golden=[float(m) for m in gold.makespans],
         cold_s=cold, warm_s=warm, numpy_s=numpy_s,
         iter_caps=plan._torch_engine.proven_caps_rows())
    return float(np.linspace(0.02, 0.98, 600)[i]), float(ms)


def ramped_scenarios(paper, scenarios, B: int, seed: int = 0):
    """Half Fig. 7 fractions, half seeded random ramped link allocations
    (continuous piecewise-linear rates through three knots)."""
    import numpy as np
    from repro_torch.core import PPoly

    rng = np.random.default_rng(seed)
    half = B // 2
    out = list(paper.sweep_scenarios(np.linspace(0.02, 0.98, half)))
    link = paper.LINK_BPS
    for i in range(B - half):
        t1, t2 = np.sort(rng.uniform(5.0, 200.0, 2))
        r1 = rng.uniform(0.05, 0.95, 3) * link
        r2 = rng.uniform(0.05, 1.0, 3) * link
        out.append(scenarios.override(label=f"ramp{i}", resources={
            ("dl1", "link"): PPoly.pwlinear([0.0, t1, t2], r1),
            ("dl2", "link"): PPoly.pwlinear([0.0, t1, t2], r2)}))
    return out


def phase_sweep_b10k(paper, scenarios):
    plan = paper.compile_paper_plan(0.5)
    prep_s, pack = host_s(
        lambda: plan.prepare(ramped_scenarios(paper, scenarios, B_LARGE)))
    check(pack.ramps and pack.B_batched == B_LARGE,
          f"ramps={pack.ramps}, batched {pack.B_batched}/{B_LARGE}")
    cold, rep = host_s(lambda: plan.sweep(pack, backend="torch"))
    warm = min(host_s(lambda: plan.sweep(pack, backend="torch"))[0]
               for _ in range(3))
    check_torch_report(rep, "sweep_b10k_ramped")
    numpy_s, rep_np = host_s(lambda: plan.sweep(pack, backend="numpy"))
    assert_match(rep, rep_np, "sweep_b10k_ramped vs numpy")
    emit("sweep_b10k_ramped", B=rep.B, ramps=pack.ramps, prepare_s=prep_s,
         cold_s=cold, warm_s=warm, numpy_s=numpy_s,
         best=rep.top_k(1)[0][1:], iter_caps=plan._torch_engine.proven_caps_rows())
    return rep, pack


# ------------------------------------------- optimize and Monte Carlo ----
def diff_objective(plan, space, scenarios, n: int = 1, q=None):
    """The differentiable objective ``plan.optimize`` builds, over a pack
    of ``scenarios`` (``n`` draws per candidate, quantile ``q``)."""
    from repro_torch.analysis.optimize import _DiffObjective
    from repro_torch.analysis.pack import ThetaMap

    return _DiffObjective(plan, ThetaMap(plan, space.axes),
                          plan.prepare(scenarios), n, q)


def phase_optimize_fig7(paper, scenarios, grid):
    """``plan.optimize`` over the Fig. 7 split on the card, held against
    this run's grid optimum, the reference's value and the same search on
    the CPU; then one value-and-gradient sweep and one ladder sweep timed.
    The peak device memory is counted above what was allocated when the
    phase began."""
    import numpy as np
    import torch

    best_frac, best_ms = grid
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plan = paper.compile_paper_plan(0.5)
    check(plan.device.type == "cuda", f"plan on {plan.device}")
    wall, opt = host_s(lambda: plan.optimize(space=paper.fig7_space(),
                                             max_evals=50))
    theta, value = float(opt.theta[0]), float(opt.value)
    check(opt.evals <= 50, f"{opt.evals} evaluations")
    check(abs(theta - best_frac) <= FIG7_SPACING + 1e-12,
          f"theta {theta}, grid best {best_frac}")
    check(value <= best_ms * (1.0 + 1e-6), f"value {value}, grid {best_ms}")
    check(abs(float(opt.report.makespan[0]) - value) <= 1e-9 * value,
          f"report {opt.report.makespan[0]} against value {value}")
    check(abs(value - REF_FIG7_VALUE) <= 1e-6 * REF_FIG7_VALUE,
          f"value {value}, reference {REF_FIG7_VALUE}")
    cpu_s, cpu = host_s(lambda: paper.compile_paper_plan(
        0.5, device="cpu").optimize(space=paper.fig7_space(), max_evals=50))
    check(abs(float(cpu.theta[0]) - theta) <= 1e-9 * theta
          and abs(float(cpu.value) - value) <= 1e-9 * value
          and (cpu.evals, cpu.iters) == (opt.evals, opt.iters),
          f"CPU search: {cpu.theta} {cpu.value} {cpu.evals} {cpu.iters}")
    f = diff_objective(plan, paper.fig7_space(),
                       [scenarios.override(label="base")])
    grad_s = median_s(lambda: f.value_grad(np.array([[0.5]])))
    values_s = median_s(lambda: f.values(np.linspace(0.3, 0.98, 8)[:, None]))
    emit("optimize_fig7", theta=theta, value=value, evals=opt.evals,
         sweeps=opt.sweeps, iters=opt.iters, converged=opt.converged,
         iter_cap=f.cap, wall_s=wall, value_grad_s=grad_s, values_s=values_s,
         values_rows=8, cpu={"theta": float(cpu.theta[0]),
                             "value": float(cpu.value), "evals": cpu.evals,
                             "iters": cpu.iters, "wall_s": cpu_s},
         peak_memory_bytes=torch.cuda.max_memory_allocated() - base)


def phase_optimize_grad(paper, scenarios):
    """Gradients on the card against central differences (h = 1e-5) at the
    reference's bar, on a linear and a ramped (quadratic) trace; each also
    taken twice, bit for bit the same."""
    import numpy as np
    from repro_torch.analysis import cap_space

    plan = paper.compile_paper_plan(0.5)
    out = []
    for name, targets, theta, ramped in GRAD_CASES:
        scs = ([scenarios.ramp_resource("dl1", "link", [0.0, 120.0],
                                        [1.6e6, 0.6e6], label="ramp")]
               if ramped else [scenarios.override(label="base")])
        f = diff_objective(plan, cap_space(list(targets), lo=0.25, hi=4.0),
                           scs)
        th = np.asarray(theta, np.float64)[None, :]
        v, g = f.value_grad(th)
        check(np.isfinite(v[0]) and np.all(np.isfinite(g)),
              f"{name}: value {v}, gradient {g}")
        K, h = th.shape[1], 1e-5
        eye = np.eye(K) * h
        vv = f.values(np.concatenate([th + eye, th - eye], axis=0))
        fd = (vv[:K] - vv[K:]) / (2.0 * h)
        np.testing.assert_allclose(g[0], fd, rtol=1e-4,
                                   atol=1e-6 * max(1.0, abs(float(v[0]))),
                                   err_msg=f"optimize_grad {name}")
        check(np.array_equal(g, f.value_grad(th)[1]),
              f"{name}: two gradients differ")
        out.append({"case": name, "ramps": f.pack.ramps, "theta": list(theta),
                    "value": float(v[0]), "grad": g[0].tolist(),
                    "fd": fd.tolist(), "iter_cap": f.cap})
    emit("optimize_grad", cases=out)


def phase_mc_b10k(paper):
    """``plan.mc(mc_spec(), n=10_000, seed=0)`` on the card against the
    reference's quantiles and dominant factors and against the numpy twin
    on the same draws; then its steps one by one, timed."""
    import numpy as np
    from repro_torch.analysis.uncertainty import mc_report_from_sweep, sample_spec

    plan = paper.compile_paper_plan(0.5)
    spec = paper.mc_spec()
    wall, mc = host_s(lambda: plan.mc(spec, n=MC_N, seed=0))
    check_torch_report(mc.report, "mc_b10k")
    quant = mc.quantiles()
    for k, want in REF_MC_QUANTILES.items():
        check(abs(quant[k] - want) <= 1e-5 * want,
              f"{k} {quant[k]}, reference {want}")
    dom = {a.label: a.p_dominant for a in mc.attribution()}
    for label, want in REF_MC_DOMINANT.items():
        check(abs(dom[label] - want) <= 2.5 / MC_N,
              f"{label} dominant {dom[label]}, reference {want}")
    sample_s, samples = host_s(lambda: sample_spec(plan, spec, MC_N, seed=0))
    prepare_s, pack = host_s(lambda: plan.prepare(samples.scenarios))
    sweep_s, rep = host_s(lambda: plan.sweep(pack))

    def report():
        out = mc_report_from_sweep(rep, samples)
        out.quantiles(), out.attribution()
        return out

    report_s, mc2 = host_s(report)
    check(np.array_equal(mc2.makespans, mc.makespans),
          "the split's makespans differ from plan.mc's")
    numpy_s, rep_np = host_s(lambda: plan.sweep(pack, backend="numpy"))
    np.testing.assert_allclose(mc.makespans, rep_np.makespans, rtol=1e-9,
                               err_msg="mc_b10k vs numpy twin")
    emit("mc_b10k", n=MC_N, quantiles=quant,
         p_dominant={k: dom[k] for k in REF_MC_DOMINANT},
         fallback=mc.fallback_count, wall_s=wall,
         split={"sample_spec_s": sample_s, "prepare_s": prepare_s,
                "sweep_s": sweep_s, "report_s": report_s},
         numpy_sweep_s=numpy_s, iter_caps=plan._torch_engine.proven_caps_rows())


def phase_optimize_mc(paper):
    """The risk-aware search (p95 over 256 draws) twice on the card: the
    same bits both times; then one ladder sweep (B = 8 x 256) and one
    value-and-gradient sweep (B = 256) timed."""
    import numpy as np
    from repro_torch.analysis import cap_space, mc_quantile
    from repro_torch.analysis.uncertainty import sample_spec

    plan = paper.compile_paper_plan(0.5)
    obj = mc_quantile(paper.mc_spec(), q=0.95, n=256, seed=0)
    space = cap_space(["task1.cpu"], lo=0.5, hi=2.0)
    (wall_a, a), (wall_b, b) = (host_s(lambda: plan.optimize(
        obj, space, max_iters=3)) for _ in range(2))
    check(np.array_equal(a.theta, b.theta) and a.value == b.value
          and a.evals == b.evals and np.array_equal(a.trajectory, b.trajectory),
          f"two runs differ: {a.theta} {b.theta} {a.value} {b.value}")
    f = diff_objective(plan, space,
                       sample_spec(plan, obj.spec, obj.n, seed=obj.seed).scenarios,
                       obj.n, obj.q)
    values_s = median_s(lambda: f.values(np.linspace(0.5, 2.0, 8)[:, None]))
    grad_s = median_s(lambda: f.value_grad(np.array([[1.25]])))
    emit("optimize_mc", theta=float(a.theta[0]), value=float(a.value),
         evals=a.evals, sweeps=a.sweeps, iters=a.iters,
         trajectory=a.trajectory.tolist(), wall_s=[wall_a, wall_b],
         iter_cap=f.cap, values_B=8 * obj.n, values_s=values_s,
         value_grad_B=obj.n, value_grad_s=grad_s)


# ------------------------------------------------- the analysis service ----
def same_rows(rep, want, rows, what: str) -> None:
    """``rep`` equals rows ``rows`` of ``want`` bit for bit: labels,
    makespans, finish times and shares."""
    import numpy as np

    check(rep.labels == [want.labels[i] for i in rows], f"{what}: labels")
    np.testing.assert_array_equal(rep.makespans, want.makespans[rows],
                                  err_msg=f"{what}: makespans")
    for pn in rep.order:
        np.testing.assert_array_equal(rep.finish[pn], want.finish[pn][rows],
                                      err_msg=f"{what}: finish {pn}")
    check(rep.factors == want.factors, f"{what}: factors")
    np.testing.assert_array_equal(rep.share_seconds, want.share_seconds[rows],
                                  err_msg=f"{what}: shares")


def phase_service_load():
    """``repro_torch.launch.analyze.main([])`` on the card: the launcher's
    defaults (32 clients x 4 queries, 6 online steps, --mc with 2,048
    draws)."""
    import numpy as np
    from repro_torch.launch import analyze

    wall, out = host_s(lambda: analyze.main([]))
    load, snap = out["load"], out["snapshot"]
    check(out["device"].startswith("cuda"), f"service on {out['device']}")
    check(load["served"] == load["clients"] * load["queries"] == 128,
          f"served {load['served']} of 128")
    check(out["online"]["updates"] == 7 and
          np.all(np.isfinite(out["online"]["makespans"])),
          f"online: {out['online']}")
    check(out["mc"]["fallbacks"] == 0 and
          all(np.isfinite(v) for v in out["mc"]["quantiles"].values()),
          f"mc: {out['mc']}")
    check(snap["restarts"] == snap["degraded"] == snap["shed"] == 0,
          f"faults without a fault plan: {snap}")
    emit("service_load", wall_s=wall, latency_p50_s=load["latency_p50_s"],
         latency_p99_s=load["latency_p99_s"],
         requests_per_s=load["requests_per_s"], load_wall_s=load["wall_s"],
         load_sweeps=load["sweeps"], load_requests=load["served"],
         coalesced_batches=load["coalesced_batches"],
         max_coalesced=load["max_coalesced"],
         sweeps=snap["sweeps"], requests=snap["requests"],
         plan_hits=snap["plan_hits"], plan_misses=snap["plan_misses"],
         trace_hits=snap["trace_hits"], cold_solves=snap["cold_traces"],
         online=out["online"], mc=out["mc"])


SVC_CLIENTS, SVC_ROWS, SVC_MAX_BATCH = 40, 250, 4096


def phase_service_b10k(paper, scenarios):
    """The B = 10,000 ramped set pushed through one service by 40 client
    threads of 250 rows each (max_batch 4096): every client's rows equal
    ``plan.sweep``'s at B = 10,000 bit for bit; then the three curve
    queries at T = 1024 on a coalesced client's Report, each equal bit for
    bit to the same call's rows on ``plan.sweep``'s Report and each kernel
    call held against its plain version.  Returns the launch counts of the
    coalesced Report's queries (the calls on ``plan.sweep``'s Report that
    they are compared with are not counted)."""
    import threading

    import numpy as np
    import torch
    from repro_torch.analysis import AnalysisService
    from repro_torch.kernels.ppoly_eval import kernel

    scs = ramped_scenarios(paper, scenarios, SVC_CLIENTS * SVC_ROWS)
    reps, lat, errors = {}, {}, []
    barrier = threading.Barrier(SVC_CLIENTS)
    with AnalysisService(max_batch=SVC_MAX_BATCH) as svc:
        plan = svc.compile(paper.build_workflow(0.5))
        check(plan.device.type == "cuda", f"plan on {plan.device}")

        def client(ci: int) -> None:
            try:
                barrier.wait(timeout=120)
                t0 = time.perf_counter()
                reps[ci] = svc.query(scs[ci * SVC_ROWS:(ci + 1) * SVC_ROWS],
                                     plan=plan, timeout=600)
                lat[ci] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SVC_CLIENTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = svc.snapshot()
    check(not errors and len(reps) == SVC_CLIENTS, f"clients failed: {errors[:3]}")
    full_s, full = host_s(lambda: plan.sweep(plan.prepare(scs), backend="torch"))
    check_torch_report(full, "service_b10k plan.sweep")
    for ci, rep in reps.items():
        check(set(rep.backends) == {"torch"}, f"client {ci}: {set(rep.backends)}")
        same_rows(rep, full, list(range(ci * SVC_ROWS, (ci + 1) * SVC_ROWS)),
                  f"service_b10k client {ci}")
    # the curve queries on a coalesced client's Report (the last client:
    # seeded ramps), counted and held against the plain versions
    ci = SVC_CLIENTS - 1
    rows = list(range(ci * SVC_ROWS, (ci + 1) * SVC_ROWS))
    rep = reps[ci]
    ts = np.linspace(0.0, float(np.max(full.makespans)) * 1.05, T_QUERIES)
    pn = rep.order[-1]
    want = {call: query_fn(full, call, pn, ts)() for call in QUERY_OPS}
    torch.cuda.synchronize()
    before = read_launches()
    with Recorder(kernel, KERNELS) as rec:
        q_s = {call: host_s(query_fn(rep, call, pn, ts))
               for call in QUERY_OPS}
        torch.cuda.synchronize()
        launches = {k: n - before[k] for k, n in read_launches().items()}
    check(same_result(q_s["sample_progress"][1],
                      want["sample_progress"][rows]), "sample_progress rows")
    vals, arg = q_s["data_ceiling"][1]
    check(same_result((vals, arg), (want["data_ceiling"][0][rows],
                                    want["data_ceiling"][1][rows])),
          "data_ceiling rows")
    check(same_result(q_s["kernel_finish_times"][1],
                      want["kernel_finish_times"][rows]),
          "kernel_finish_times rows")
    errs = {n: 0.0 for n in KERNELS}
    for name, args, out in rec.calls:
        errs[name] = max(errs[name], hold_against_plain(name, args, out))
    for key in ("ppoly_eval_vec", "ppoly_min_eval_vec", "ppoly_first_crossing_row"):
        check(launches[key] > 0, f"{key} never launched on the service path")
    lat_s = np.sort(list(lat.values()))
    emit("service_b10k", B=len(scs), clients=SVC_CLIENTS, rows=SVC_ROWS,
         max_batch=SVC_MAX_BATCH, wall_s=wall, plan_sweep_s=full_s,
         latency_p50_s=float(np.quantile(lat_s, 0.5)),
         latency_p99_s=float(np.quantile(lat_s, 0.99)),
         requests_per_s=SVC_CLIENTS / wall, sweeps=snap["sweeps"],
         coalesced_batches=snap["coalesced_batches"],
         max_coalesced=snap["max_coalesced"], max_batch_B=snap["max_batch_B"],
         bitwise_vs_plan_sweep=True, query_proc=pn, query_T=T_QUERIES,
         query_s={call: s for call, (s, _o) in q_s.items()},
         launches=launches, max_abs_err=errs,
         iter_caps=plan._torch_engine.proven_caps_rows(),
         worker_split=worker_split(plan, scs))
    return launches


def worker_split(plan, scs) -> dict:
    """The worker's steps for one coalesced chunk (16 requests of 250
    rows, padded to 4,096 as the service pads it), each timed apart on the
    host clock ending in a synchronize: ``prepare``; the whole
    ``plan.sweep`` of the pack (which proves the chunk's iteration cap when
    the service's drains cut other chunks); its parts at that cap: the
    levels' inputs to the device, the engine's level loops (driven from the
    host), the copy back and host assembly of the results (``_wrap``); the
    16 clients' row slices."""
    from repro_torch.analysis import serve

    rows = min(SVC_MAX_BATCH // SVC_ROWS * SVC_ROWS, len(scs))
    chunk = scs[:rows] + [scs[rows - 1]] * (
        min(serve._pow2_bucket(rows), SVC_MAX_BATCH) - rows)
    eng = plan._torch_engine
    prepare_s, pack = host_s(lambda: plan.prepare(chunk))
    B, ramps = pack.B_batched, pack.ramps
    sweep_s, rep = host_s(lambda: plan.sweep(pack, backend="torch"))
    to_device_s, dev = host_s(
        lambda: eng.device_args(eng.level_args(pack.host_args(), B, ramps)))
    cap = eng._proven_caps[(B, 1, ramps)]
    loops_s, out = host_s(lambda: eng._make_run(B, cap, ramps)(dev))
    check(out is not None, "the proven cap overflowed")
    copy_back_s, _res = host_s(lambda: eng._wrap([out], B, pack.bat_idx))
    slice_s, _sub = host_s(lambda: [serve._client_rows(rep, lo, lo + SVC_ROWS)
                                    for lo in range(0, rows, SVC_ROWS)])
    return {"B": B, "iter_cap": cap, "prepare_s": prepare_s,
            "to_device_s": to_device_s, "level_loops_s": loops_s,
            "copy_back_s": copy_back_s, "plan_sweep_s": sweep_s,
            "slice_s": slice_s}


def phase_service_faults(paper):
    """Each FaultPlan case on the card: NaN rows degraded to the numpy twin,
    a killed worker restarted, a failed sweep retried, a malformed request
    failing alone, a deadline behind a delayed drain."""
    import warnings

    import numpy as np
    from repro_torch.analysis import (AnalysisService, DeadlineExceeded,
                                      FaultInjected, FaultPlan, ServiceCrashed)

    plan = paper.compile_paper_plan(0.5)
    scs = paper.sweep_scenarios([0.3, 0.5, 0.7, 0.9])
    want = plan.sweep(plan.prepare(scs), backend="torch")
    out = {}

    def timed(name, fn):
        out[name] = {"s": host_s(fn)[0]}

    def nan_rows():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with AnalysisService(faults=FaultPlan(nan_rows=[1, 3])) as svc:
                rep = svc.query(scs, plan=plan, timeout=120)
                snap = svc.snapshot()
        check(rep.backends == ["torch", "degraded", "torch", "degraded"],
              f"nan_rows: backends {rep.backends}")
        twin = plan.sweep(plan.prepare([scs[1], scs[3]]), backend="numpy")
        same_rows(rep.subset([1, 3]), twin, [0, 1], "nan_rows degraded rows")
        same_rows(rep.subset([0, 2]), want, [0, 2], "nan_rows healthy rows")
        check(snap["degraded"] == 2 and sum(
            "degraded to the numpy" in str(w.message) for w in caught) == 1,
            f"nan_rows: {snap['degraded']} degraded")

    def kill_worker():
        with AnalysisService(autostart=False,
                             faults=FaultPlan(kill_worker_at=1)) as svc:
            doomed = svc.submit(scs, plan=plan)
            svc.start()
            try:
                doomed.result(timeout=120)
                check(False, "kill_worker: the doomed request was served")
            except ServiceCrashed as e:
                check(isinstance(e.cause, FaultInjected), f"cause {e.cause!r}")
            rep = svc.query(scs, plan=plan, timeout=120)
            check(svc.snapshot()["restarts"] == 1, "kill_worker: no restart")
        same_rows(rep, want, [0, 1, 2, 3], "kill_worker restarted")

    def fail_sweep():
        with AnalysisService(faults=FaultPlan(fail_sweep=1),
                             retry_backoff_s=1e-4) as svc:
            rep = svc.query(scs, plan=plan, timeout=120)
            check(svc.snapshot()["retries"] >= 1, "fail_sweep: no retry")
        same_rows(rep, want, [0, 1, 2, 3], "fail_sweep retried")

    def malformed():
        with AnalysisService(autostart=False, retry_backoff_s=1e-4,
                             faults=FaultPlan(malformed_request=1)) as svc:
            poisoned = svc.submit(scs, plan=plan)
            neighbor = svc.submit(scs, plan=plan)
            svc.start()
            try:
                poisoned.result(timeout=120)
                check(False, "malformed: the poisoned request was served")
            except ValueError:
                pass
            rep = neighbor.result(timeout=120)
        same_rows(rep, want, [0, 1, 2, 3], "malformed neighbor")

    def deadline():
        with AnalysisService(autostart=False,
                             faults=FaultPlan(delay_s=0.25)) as svc:
            doomed = svc.submit(scs, plan=plan, deadline_s=0.02)
            patient = svc.submit(scs, plan=plan)
            svc.start()
            try:
                doomed.result(timeout=120)
                check(False, "deadline: the expired request was served")
            except DeadlineExceeded:
                pass
            rep = patient.result(timeout=120)
            check(svc.snapshot()["deadline_expired"] == 1, "deadline: count")
        same_rows(rep, want, [0, 1, 2, 3], "deadline neighbor")

    for name, fn in (("nan_rows", nan_rows), ("kill_worker", kill_worker),
                     ("fail_sweep", fail_sweep), ("malformed", malformed),
                     ("deadline", deadline)):
        timed(name, fn)
    check(np.all(np.isfinite(want.makespans)), "service_faults reference")
    emit("service_faults", cases=out)


def phase_service_durable(paper):
    """A store in a fresh directory under build/: a swept plan persisted and
    a new service warm-started from it (the warm sweep bit for bit the cold
    one); a corrupted artifact rejected with one ArtifactWarning and a cold
    compile; a tracked session of 6 deltas recovered to its digest."""
    import shutil
    import warnings

    import numpy as np
    from repro_torch.analysis import (AnalysisService, ArtifactStore,
                                      ArtifactWarning, FaultPlan)

    root = ROOT / "build" / "service_store"
    shutil.rmtree(root, ignore_errors=True)
    wf = paper.build_workflow(0.5)
    scs = paper.sweep_scenarios(np.linspace(0.02, 0.98, 64))
    out = {}
    t0 = time.perf_counter()
    with AnalysisService(wf, store=root / "a") as cold:
        cold_s, rep_cold = host_s(lambda: cold.query(scs, timeout=120))
        snap_c = cold.snapshot()
    check(snap_c["artifacts_written"] >= 1 and snap_c["warm_plans"] == 0,
          f"cold service: {snap_c}")
    warm_start_s, warm = host_s(lambda: AnalysisService(wf, store=root / "a"))
    with warm:
        warm_s, rep_warm = host_s(lambda: warm.query(scs, timeout=120))
        snap_w = warm.snapshot()
    check(snap_w["warm_plans"] >= 1 and snap_w["warm_hits"] >= 1
          and snap_w["cold_traces"] == 0, f"warm service: {snap_w}")
    same_rows(rep_warm, rep_cold, list(range(len(scs))), "warm against cold")
    out.update(cold_query_s=cold_s, warm_start_s=warm_start_s,
               warm_query_s=warm_s, warm_plans=snap_w["warm_plans"],
               warm_hits=snap_w["warm_hits"], cold_solves=snap_w["cold_traces"],
               artifact_bytes=ArtifactStore(root / "a").scan()[0].stat().st_size)

    store = ArtifactStore(root / "b", faults=FaultPlan(corrupt_artifact=1))
    store.put(warm._default_plan)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with AnalysisService(wf, store=store) as bad:
            rep_bad = bad.query(scs, timeout=120)
            snap_b = bad.snapshot()
    art = [w for w in caught if issubclass(w.category, ArtifactWarning)]
    check(len(art) == 1 and snap_b["artifact_errors"] == 1
          and snap_b["warm_plans"] == 0 and snap_b["plan_misses"] == 1,
          f"corrupt artifact: {len(art)} warnings, {snap_b}")
    same_rows(rep_bad, rep_cold, list(range(len(scs))), "cold after corrupt")

    with AnalysisService(wf, store=root / "a") as svc:
        live = svc.track(paper.sweep_scenarios([0.5]), track_id="chip")
        for k in range(6):
            live.ingest({"dl1.link": np.float64(0.9 - 0.1 * k)}, timeout=120)
        digest = live.pack.state_digest()
        live.close()
    recover_s, rec = host_s(lambda: AnalysisService(store=root / "a"))
    with rec:
        rs, back = host_s(lambda: rec.recover("chip"))
        check(back.pack.state_digest() == digest and back.updates == 6,
              f"recover: {back.updates} deltas, digest equal "
              f"{back.pack.state_digest() == digest}")
        rep_back = back.refresh()
        back.close()
    check(rep_back.makespans.tobytes() == live.report.makespans.tobytes(),
          "recovered session sweeps to another makespan")
    out.update(recover_s=rs, tracked_deltas=6, digest_equal=True,
               wall_s=time.perf_counter() - t0)
    emit("service_durable", **out)
    shutil.rmtree(root, ignore_errors=True)


def phase_service_mc(paper):
    """``submit_mc(mc_spec(), n=10_000, seed=0)`` against ``plan.mc`` with
    the same arguments: quantiles bit for bit."""
    from repro_torch.analysis import AnalysisService

    with AnalysisService() as svc:
        plan = svc.compile(paper.build_workflow(0.5))
        svc_s, mc = host_s(lambda: svc.submit_mc(
            paper.mc_spec(), n=MC_N, seed=0, plan=plan).result(timeout=600))
        snap = svc.snapshot()
    plan_s, want = host_s(lambda: plan.mc(paper.mc_spec(), n=MC_N, seed=0))
    check(mc.quantiles() == want.quantiles(),
          f"quantiles {mc.quantiles()} against plan.mc {want.quantiles()}")
    check(mc.makespans.tobytes() == want.makespans.tobytes(),
          "makespans differ from plan.mc's")
    for k, ref in REF_MC_QUANTILES.items():
        check(abs(mc.quantiles()[k] - ref) <= 1e-5 * ref,
              f"{k} {mc.quantiles()[k]}, reference {ref}")
    emit("service_mc", n=MC_N, quantiles=mc.quantiles(), service_s=svc_s,
         plan_mc_s=plan_s, sweeps=snap["sweeps"],
         max_batch_B=snap["max_batch_B"], bitwise_vs_plan_mc=True)


# ------------------------------------- the rest of the analysis side ----
def phase_des_vs_model(paper):
    """The Fig. 7 sweep on the card against the DES (the "measured system")
    at every 20th fraction, both recipes, as ``benchmarks/run.py``
    ``bench_fig7_sweep`` computes the mean relative error; the DES's exact
    results and the model's bars of ``tests/test_paper_workflow.py``; then
    §6's runtime comparison (model at 1.1 GB and 90x, DES at 1.1 GB and
    10x)."""
    import numpy as np

    fracs = np.linspace(0.02, 0.98, 600)
    plan = paper.compile_paper_plan(0.5)
    refined = paper.compile_paper_plan(0.5, recipe="refined")
    rep = plan.sweep(plan.prepare(paper.sweep_scenarios(fracs)), backend="torch")
    check_torch_report(rep, "des_vs_model")
    sel = fracs[::DES_EVERY]
    des_s, des = host_s(lambda: [paper.measure_makespan(f) for f in sel])
    des_ms = np.array([m for m, _n in des])
    ref = refined.sweep(refined.prepare(paper.sweep_scenarios(sel)),
                        backend="torch")
    check_torch_report(ref, "des_vs_model refined")
    err_paper = float(np.mean(np.abs(rep.makespans[::DES_EVERY] - des_ms) / des_ms))
    err_refined = float(np.mean(np.abs(ref.makespans - des_ms) / des_ms))
    for frac, want in DES_EXACT.items():
        got = paper.measure_makespan(frac)
        check(got == want, f"DES at {frac}: {got}, expected {want}")
    gates = (0.5, 0.75, 0.95)
    g_des = [paper.measure_makespan(f)[0] for f in gates]
    g_ref = refined.sweep(refined.prepare(paper.sweep_scenarios(gates)),
                          backend="torch").makespans
    for f, d, m in zip(gates, g_des, g_ref):
        check(abs(m - d) <= 0.002 * d, f"refined at {f}: {m} against DES {d}")
    p50 = float(plan.sweep(plan.prepare(paper.sweep_scenarios([0.5])),
                           backend="torch").makespans[0])
    check(p50 >= g_des[0] and abs(p50 - g_des[0]) <= 0.15 * g_des[0],
          f"paper recipe at 0.5: {p50} against DES {g_des[0]}")
    # §6: the model's cost does not grow with the data, the DES's does
    big = paper.compile_paper_plan(0.5, video_bytes=paper.VIDEO_BYTES * 90)
    one, one_big = (p.prepare(paper.sweep_scenarios([0.5])) for p in (plan, big))
    model_s = median_s(lambda: plan.sweep(one, backend="torch"))
    model_big_s = median_s(lambda: big.sweep(one_big, backend="torch"))
    host_model_s = median_s(lambda: paper.predict_makespan(0.5))
    host_model_big_s = median_s(lambda: paper.predict_makespan(
        0.5, video_bytes=paper.VIDEO_BYTES * 90))
    des1_s, (_m, ev1) = host_s(lambda: paper.measure_makespan(0.5))
    des10_s, (_m, ev10) = host_s(lambda: paper.measure_makespan(
        0.5, video_bytes=paper.VIDEO_BYTES * 10))
    emit("des_vs_model", B=rep.B, des_points=len(sel), des_s=des_s,
         mean_rel_err_paper=err_paper, mean_rel_err_refined=err_refined,
         des_exact={str(f): list(v) for f, v in DES_EXACT.items()},
         refined_vs_des={str(f): [float(m), d] for f, d, m in zip(gates, g_des, g_ref)},
         paper_at_0_5=[p50, g_des[0]],
         runtime={"model_card_s": {"1.1GB": model_s, "90x": model_big_s},
                  "model_host_s": {"1.1GB": host_model_s, "90x": host_model_big_s},
                  "des_s": {"1.1GB": des1_s, "10x": des10_s},
                  "des_events": {"1.1GB": ev1, "10x": ev10}})


def phase_shared_link(paper):
    """``sequential_allocation`` on the paper's two downloads (§3.4/§5.2):
    dl2 finishes when the link has moved both files, the summed usage never
    exceeds the capacity; the allocated workflow then sweeps on the card to
    the same finishes."""
    import numpy as np
    from repro_torch.core import (DataDep, PPoly, Process, ResourceDep,
                                  Workflow, sequential_allocation, total_usage)
    from repro_torch.sweep import Scenario

    V, C = paper.VIDEO_BYTES, paper.LINK_BPS
    rows = []
    for frac in SHARED_FRACS:
        wf = Workflow()
        for n in ("dl1", "dl2"):
            wf.add(Process(n, data={"remote": DataDep.stream(V, V)},
                           resources={"link": ResourceDep.stream(V, V)},
                           total_progress=V).identity_output())
            wf.set_data_input(n, "remote", PPoly.constant(V))
        users = [("dl1", "link", PPoly.constant(frac * C)),
                 ("dl2", "link", PPoly.constant(C))]
        alloc_s, res = host_s(lambda: sequential_allocation(wf, users, C))
        t1, t2 = res["dl1"].finish_time, res["dl2"].finish_time
        check(abs(t1 - V / (frac * C)) <= 1e-9 * t1, f"dl1 at {frac}: {t1}")
        check(abs(t2 - 2 * V / C) <= 1e-6 * t2, f"dl2 at {frac}: {t2}")
        tot = total_usage(res, "link", np.linspace(0.0, 400.0, 801))
        check(float(tot.max()) <= C * (1 + 1e-9), f"usage {tot.max()} > {C}")
        plan = wf.compile()
        rep = plan.sweep(plan.prepare([Scenario()]), backend="torch")
        check_torch_report(rep, "shared_link")
        for n, want in (("dl1", t1), ("dl2", t2)):
            got = float(rep.finish[n][0])
            check(abs(got - want) <= 1e-5 * want, f"card {n} {got} vs {want}")
        rows.append({"frac": frac, "dl1_s": t1, "dl2_s": t2,
                     "max_usage_over_capacity": float(tot.max()) / C,
                     "allocation_s": alloc_s})
    emit("shared_link", dl2_expected_s=2 * V / C, cases=rows)


def phase_trace_report(paper, scenarios):
    """``trace_report`` for the fig7 (B = 600) and b10k_ramped packs on the
    card and on the CPU, each twice (identical counts), one level loop per
    topology level; the device events of one warm sweep from torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sweep.torch_engine import trace_report

    out = {}
    for name, scs in (
            ("fig7", paper.sweep_scenarios(np.linspace(0.02, 0.98, 600))),
            ("b10k_ramped", ramped_scenarios(paper, scenarios, B_LARGE))):
        row = {}
        for dev in ("cuda", "cpu"):
            plan = paper.compile_paper_plan(0.5, device=dev)
            pack = plan.prepare(scs)
            plan.sweep(pack, backend="torch")          # proves the cap
            first = trace_report(plan, pack)
            second = trace_report(plan, pack)
            check(first == second, f"{name} on {dev}: counts differ between calls")
            check(first["level_loops"] == len(plan.levels) == 3,
                  f"{name} on {dev}: {first['level_loops']} loops, "
                  f"{len(plan.levels)} levels")
            check(not first["overflow"], f"{name} on {dev}: overflow at the cap")
            row[dev] = first
            if dev == "cuda":
                plan.sweep(pack, backend="torch")
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    warm_s, _ = host_s(lambda: plan.sweep(pack, backend="torch"))
                events = [e for e in prof.events() if e.device_type.name == "CUDA"]
                row["cuda_profile"] = {
                    "device_events": len(events),
                    "device_busy_ms": sum(e.time_range.elapsed_us()
                                          for e in events) / 1e3,
                    "wall_ms": warm_s * 1e3}
            del plan, pack
        out[name] = row
    emit("trace_report", **out)


def phase_sweep_shim(paper):
    """The deprecated ``repro_torch.sweep.analyze`` on the card: it warns and
    equals ``plan.sweep`` bit for bit."""
    import warnings

    import numpy as np
    from repro_torch import sweep

    scs = paper.sweep_scenarios(np.linspace(0.02, 0.98, 600))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = sweep.analyze(paper.build_workflow(0.5), scs, backend="torch")
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "sweep.analyze did not warn")
    check(sweep.SweepResult is type(got), "SweepResult is not the Report")
    want = paper.compile_paper_plan(0.5).sweep(scs, backend="torch")
    check_torch_report(got, "sweep_shim")
    check(got.makespans.tobytes() == want.makespans.tobytes(), "makespans differ")
    check(got.share_seconds.tobytes() == want.share_seconds.tobytes(),
          "shares differ")
    for pn in want.order:
        check(got.finish[pn].tobytes() == want.finish[pn].tobytes(),
              f"finish {pn} differs")
    emit("sweep_shim", B=got.B, device=str(got.plan.device), warned=True,
         bitwise_vs_plan_sweep=True)


# ------------------------------------------------------- sharded packs ----
def same_sweep(got, want, what: str) -> None:
    """Two Reports equal bit for bit: rows, finish times, share seconds."""
    check(got.makespans.tobytes() == want.makespans.tobytes(), f"{what}: makespans")
    check(got.share_seconds.tobytes() == want.share_seconds.tobytes(),
          f"{what}: share seconds")
    for pn in want.order:
        check(got.finish[pn].tobytes() == want.finish[pn].tobytes(),
              f"{what}: finish {pn}")


def phase_shard_sweep(paper, scenarios, kernel):
    """Sharded scenario packs (``ScenarioPack.shard``): the b10k_ramped set
    through ``pack.shard()`` (every visible card) and ``pack.shard(1)``,
    each bit for bit the unsharded sweep's rows, share seconds and curve
    queries at T = 1024 (the queries of the sharded Reports recorded and
    held against the plain versions, their launches counted from 0);
    ``pack.shard(device_count() + 1)`` refused; the Fig. 7 pack at
    ``shard(CPU_SHARDS)`` on the CPU bit for bit; ``plan.mc(shards=1)``
    against ``shards=None`` on the card.  Returns (launches, max errors)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    plan = paper.compile_paper_plan(0.5)
    pack = plan.prepare(ramped_scenarios(paper, scenarios, B_LARGE))
    plan.sweep(pack, backend="torch")
    unsharded_s, want = host_s(lambda: plan.sweep(pack, backend="torch"))
    ts = np.linspace(0.0, float(np.max(want.makespans)) * 1.05, T_QUERIES)
    wanted = {(call, pn): query_fn(want, call, pn, ts)()
              for pn in want.order for call in QUERY_OPS}
    n_dev = torch.cuda.device_count()
    walls = {}
    with Recorder(kernel, KERNELS) as rec:
        reset_launches()
        for n in (None, 1):
            sp = pack.shard(n)
            check(sp.shards == (n_dev if n is None else n), f"shard({n}): {sp.shards}")
            cold, got = host_s(lambda: plan.sweep(sp, backend="torch"))
            warm, got = host_s(lambda: plan.sweep(sp, backend="torch"))
            check_torch_report(got, f"shard_sweep shard({n})")
            same_sweep(got, want, f"shard({n})")
            q_s = 0.0
            for (call, pn), out in wanted.items():
                wall, res = host_s(query_fn(got, call, pn, ts))
                q_s += wall
                check(same_result(res, out), f"shard({n}) {call} {pn}: differs")
            walls[f"shard({'' if n is None else n})"] = {
                "shards": sp.shards, "cold_s": cold, "warm_s": warm, "queries_s": q_s}
        torch.cuda.synchronize()
        launches = read_launches()
    errs = {name: 0.0 for name in KERNELS}
    for name, args, out in rec.calls:
        errs[name] = max(errs[name], hold_against_plain(name, args, out))
    for name, rt in (("ppoly_eval", "vec"), ("ppoly_min_eval", "vec"),
                     ("ppoly_first_crossing", "row")):
        check(launches[name] == launches[f"{name}_{rt}"] == 2 * len(want.order),
              f"shard_sweep: {launches[name]} {name} calls, "
              f"{launches[f'{name}_{rt}']} on {rt}")
    try:
        pack.shard(n_dev + 1)
    except ValueError as e:
        check("device" in str(e), f"shard({n_dev + 1}): {e}")
    else:
        check(False, f"shard({n_dev + 1}) with {n_dev} card(s) was not refused")
    cplan = paper.compile_paper_plan(0.5, device="cpu")
    cpack = cplan.prepare(paper.sweep_scenarios(np.linspace(0.02, 0.98, 600)))
    cpu_s, cwant = host_s(lambda: cplan.sweep(cpack, backend="torch"))
    cpu_sharded_s, cgot = host_s(lambda: cplan.sweep(cpack.shard(CPU_SHARDS),
                                                     backend="torch"))
    same_sweep(cgot, cwant, f"cpu shard({CPU_SHARDS})")
    for pn in cwant.order:
        for call in QUERY_OPS:
            check(same_result(query_fn(cgot, call, pn, ts[::16])(),
                              query_fn(cwant, call, pn, ts[::16])()),
                  f"cpu shard({CPU_SHARDS}) {call} {pn}: differs")
    mc_none_s, m0 = host_s(lambda: plan.mc(paper.mc_spec(), n=MC_N, seed=0))
    mc_one_s, m1 = host_s(lambda: plan.mc(paper.mc_spec(), n=MC_N, seed=0, shards=1))
    check(m0.makespans.tobytes() == m1.makespans.tobytes(), "mc shards=1: makespans")
    check(m0.quantiles() == m1.quantiles(), "mc shards=1: quantiles")
    emit("shard_sweep", B=want.B, T=T_QUERIES, cards=n_dev, unsharded_warm_s=unsharded_s,
         sharded=walls, launches={k: v for k, v in launches.items() if v},
         max_abs_err=errs, refused=n_dev + 1,
         cpu={"B": cwant.B, "shards": CPU_SHARDS, "unsharded_s": cpu_s,
              "sharded_s": cpu_sharded_s},
         mc={"n": MC_N, "shards_none_s": mc_none_s, "shards_1_s": mc_one_s},
         iter_caps=plan._torch_engine.proven_caps_rows(), bitwise=True,
         seconds=time.perf_counter() - t0)
    return launches, errs


def phase_examples_torch():
    """The example twins on the card (their default device), each in its
    own process, started together: each exits with 0; their first and last
    lines and wall times."""
    t0 = time.perf_counter()
    runs = {}
    results = run_children([[sys.executable, str(ROOT / "examples" / name)]
                            for name in EXAMPLES_TORCH], timeout=300)
    for name, (res, wall) in zip(EXAMPLES_TORCH, results):
        check(res.returncode == 0, f"{name}: exit {res.returncode}\n"
                                   f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
        lines = res.stdout.strip().splitlines()
        runs[name] = {"wall_s": wall, "first": lines[0], "last": lines[-1]}
    check("shard(s)" in runs["sweep_allocations_torch.py"]["first"]
          and "cuda" in runs["sweep_allocations_torch.py"]["first"],
          f"sweep_allocations_torch.py: {runs['sweep_allocations_torch.py']['first']}")
    emit("examples_torch", runs=runs, seconds=time.perf_counter() - t0)


# ------------------------------------------- MoE and Mamba families ----
def cut_config(arch: str, n_layers: int):
    """The full-width config cut to ``n_layers``; (cfg, the cut)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    return (dataclasses.replace(full, n_layers=n_layers),
            {"n_layers": [full.n_layers, n_layers]})


def phase_lm_prefill_cut(phase: str, arch: str, n_layers: int):
    """``arch`` at full width cut to ``n_layers`` in bf16, weights from
    init_params(seed=0) on the card; prefill of B x S seeded tokens, every
    flash call recorded and held against the plain version with the bars of
    ``flash_failures``.  Returns (cfg, model, launches, worst error, the
    first flash call's inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg, reduced = cut_config(arch, n_layers)
    kinds = [cfg.layer_kind(i % cfg.period) for i in range(cfg.n_layers)]
    n_attn = sum(k["mixer"] == "attn" for k in kinds)
    init_s, tree = host_s(lambda: init_params(cfg, seed=0))
    model = T.DecoderLM(cfg, tree)
    del tree
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                                     generator=gen, device="cuda")}
    with torch.inference_mode():
        with Recorder(fa, ["flash_attention"]) as rec:
            reset_launches()
            cold_s, last = host_s(lambda: T.prefill(model, cfg, batch))
            launches = read_launches()
        check(launches["flash_attention"] == launches["flash_attention_tc"]
              == n_attn, f"{launches['flash_attention']} flash launches "
              f"({launches['flash_attention_tc']} on the tensor cores), "
              f"{n_attn} attention layers")
        check(tuple(last.shape) == (LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(last).all()), f"{phase} logits")
        errs = [flash_err(out, args, kw)
                for (_n, args, out), kw in zip(rec.calls, rec.kwargs)]
        first = (rec.calls[0][1], rec.kwargs[0])
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        warm_s, last2 = host_s(lambda: T.prefill(model, cfg, batch))
        peak = torch.cuda.max_memory_allocated()
        drift = float((last2.float() - last.float()).abs().max())
    split = prefill_split(cfg, model, batch)
    q, k = first[0][0], first[0][1]
    emit(phase, arch=cfg.name, dtype=cfg.dtype, reduced=reduced,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         experts=[cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.capacity_factor],
         layer_kinds=[f"{k['mixer']}+{k['ffn']}" for k in kinds],
         batch=LM_BATCH, seq=LM_SEQ, n_params=cfg.n_params(),
         weight_bytes=weight_bytes, init_s=init_s, cold_s=cold_s,
         warm_s=warm_s, tok_s=LM_BATCH * LM_SEQ / warm_s,
         peak_memory_bytes=peak, split=split, launches=launches,
         flash_calls=len(errs), flash_shape={"q": list(q.shape), "k": list(k.shape),
                      "group": q.shape[1] // k.shape[1]},
         **worst_of(errs), tol=0.03, rel_l2_tol=4e-3,
         elem_bar="2**-8 (|want| + P|V|) + 2e-05", rerun_max_abs_diff=drift)
    return cfg, model, launches, worst_of(errs)["max_abs_err"], first


def prefill_split(cfg, model, batch) -> dict:
    """One prefill taken apart: host seconds (each ending in a synchronize)
    of the embedding, of every layer's mixer and FFN, summed by kind, and
    of the logits; the pieces run the same calls as ``Block.forward``."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attn_forward
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.mamba import mamba_forward

    mixer_s: dict[str, float] = {}
    ffn_s: dict[str, float] = {}
    with torch.inference_mode():
        embed_s, h = host_s(lambda: model.embed_in(batch))
        B, S = h.shape[:2]
        positions = T._positions(cfg, batch, B, S, h.device)
        for blk in model.blocks:
            mixer, ffn = blk.kind["mixer"], blk.kind["ffn"]

            def mix(h=h, blk=blk, mixer=mixer):
                hn = rmsnorm(h, blk.norm_mixer, cfg.norm_eps)
                if mixer == "attn":
                    return h + attn_forward(blk.attn, hn, cfg, positions)[0]
                return h + mamba_forward(blk.mamba, hn, cfg)

            t, h = host_s(mix)
            mixer_s[mixer] = mixer_s.get(mixer, 0.0) + t
            t, h = host_s(lambda h=h, blk=blk: blk._ffn(h))
            ffn_s[ffn] = ffn_s.get(ffn, 0.0) + t
        logits_s, _ = host_s(lambda: model.logits_out(h)[:, -1])
    return {"embed_s": embed_s, "mixer_s": mixer_s, "ffn_s": ffn_s,
            "logits_s": logits_s,
            "sum_s": embed_s + sum(mixer_s.values()) + sum(ffn_s.values())
            + logits_s}


def serve_cut(arch: str, model) -> dict:
    """The serving launcher with a model cut in depth (its ``params=``)."""
    import torch
    from repro_torch.launch import serve

    reset_launches()
    out = serve.main(["--arch", arch, "--no-smoke"], params=model)
    launches = read_launches()
    gen = out["continuations"]
    check(gen.shape == (8, 16) and out["requests"] == 8, f"served {gen.shape}")
    check(bool(torch.isfinite(out["prompt_logits"]).all()),
          "decode logits not finite")
    trace = trace_decode(model.cfg, model, out["requests"],
                         out["prompt_len"] + out["generated"])
    return {"arch": out["arch"], "requests": out["requests"],
            "prompt_len": out["prompt_len"], "generated": out["generated"],
            "wall_s": out["wall_s"], "tok_s": out["tok_s"],
            "median_step_ms": out["median_step_ms"], "sample": out["sample"],
            "launches": launches, "decode_trace": trace}


def crosscheck_f32(cfg) -> dict:
    """Prefill against a token-by-token decode in float32 at the same width
    and depth, the same seed's weights before their bf16 rounding, capacity
    drops off (``capacity_factor = n_experts``: drops depend on the token
    count, the reference's rule); max abs at the reference's 2e-2, the
    relative L2 beside it."""
    import dataclasses

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                capacity_factor=float(cfg.n_experts))
    model = T.DecoderLM(cfg32, init_params(cfg32, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, XCHECK_SHAPE, generator=gen,
                         device="cuda")
    with torch.inference_mode():
        full = T.forward(model, cfg32, {"tokens": toks})
        cache = T.init_cache(cfg32, toks.shape[0], toks.shape[1])
        steps = []
        for t in range(toks.shape[1]):
            logits, cache = T.decode_step(model, cfg32, cache,
                                          {"tokens": toks[:, t:t + 1]}, t)
            steps.append(logits)
        dec = torch.stack(steps, 1)
    err = float((dec - full).abs().max())
    rel = rel_l2(dec, full)
    check(bool(torch.isfinite(dec).all()), "float32 decode logits not finite")
    check(err < XCHECK_TOL, f"{cfg.name} float32 prefill vs decode: max abs "
                            f"{err} (relative L2 {rel})")
    del model, cache, full, dec
    torch.cuda.empty_cache()
    return {"crosscheck_f32_max_abs": err, "crosscheck_f32_tol": XCHECK_TOL,
            "crosscheck_f32_rel_l2": rel,
            "crosscheck_f32_shape": list(XCHECK_SHAPE),
            "crosscheck_f32_capacity_factor": cfg32.capacity_factor}


def flash_shape_times(first) -> dict:
    """One flash call of a prefill, timed by CUDA events: the kernel, the
    plain version, scaled_dot_product_attention; its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa

    (q, k, v), kw = first
    B, H, S, D = q.shape
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters=10)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=10)
    b_ms, b_by = flash_bound(q, k, v, kw["causal"], kw["window"])
    flops = 4 * B * H * D * attended_pairs(S, kw["causal"], kw["window"])
    return {"q": list(q.shape), "k": list(k.shape), "group": H // k.shape[1],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "tflops": flops / ms / 1e9}


#: each curve query of the Report: its op and the tables it reads
QUERY_OPS = {"sample_progress": ("ppoly_eval", "progress"),
             "data_ceiling": ("ppoly_min_eval", "ceilings"),
             "kernel_finish_times": ("ppoly_first_crossing", "progress")}


def query_fn(rep, call: str, pn: str, ts):
    """The Report's call as a user makes it."""
    if call == "kernel_finish_times":
        return lambda: rep.kernel_finish_times(pn)
    return lambda: getattr(rep, call)(pn, ts)


def same_result(a, b) -> bool:
    """Equal bit for bit: the same arrays of the same dtypes and shapes."""
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def phase_queries(rep):
    """The Report's curve queries at T = 1024 on every process, each once:
    checked, and each call's host wall time (ending in a synchronize).
    Returns (ts, shapes, host seconds per call in call order, results)."""
    import numpy as np

    ts = np.linspace(0.0, float(np.max(rep.makespans)) * 1.05, T_QUERIES)
    shapes, walls, results = {}, [], []
    for pn in rep.order:
        for call in QUERY_OPS:
            wall, out = host_s(query_fn(rep, call, pn, ts))
            walls.append((call, pn, wall))
            results.append((call, pn, out))
        prog, (vals, arg), fin = (out for _c, _p, out in results[-3:])
        check(prog.shape == (rep.B, T_QUERIES) and np.isfinite(prog).all(),
              f"sample_progress {pn}: shape {prog.shape} / non-finite")
        check(vals.shape == arg.shape == (rep.B, T_QUERIES),
              f"data_ceiling {pn}: shapes {vals.shape} {arg.shape}")
        check(prog.dtype == vals.dtype == np.float32 and arg.dtype == np.int32
              and fin.dtype == np.float64, f"{pn}: result dtypes")
        np.testing.assert_array_equal(np.isfinite(fin),
                                      np.isfinite(rep.finish[pn]))
        ok = np.isfinite(fin)
        np.testing.assert_allclose(fin[ok], rep.finish[pn][ok], rtol=1e-4,
                                   err_msg=f"kernel_finish_times {pn}")
        shapes[pn] = {"progress": list(prog.shape), "ceiling_slots":
                      len(rep.proc_results[pn].ceilings)}
    return ts, shapes, walls, results


def pack_by_hand(rep, kind: str, pn: str):
    """The float32 tables of a curve query, packed here from the process's
    piecewise functions (``kernel_args()``) and not by the Report: the
    progress functions (B, P) / (B, P, K), or the data ceilings padded to
    (B, F, P) / (B, F, P, K) with absent pieces at ``PAD_START``."""
    import numpy as np
    from repro_torch.kernels.ppoly_eval import PAD_START

    r = rep.proc_results[pn]
    if kind == "progress":
        return r.progress.kernel_args()
    packs = [c.kernel_args() for c in r.ceilings]
    P = max(s.shape[1] for s, _c in packs)
    K = max(c.shape[-1] for _s, c in packs)
    starts = np.full((rep.B, len(packs), P), PAD_START, np.float32)
    coeffs = np.zeros((rep.B, len(packs), P, K), np.float32)
    for f, (s, c) in enumerate(packs):
        starts[:, f, :s.shape[1]] = s
        coeffs[:, f, :s.shape[1], :c.shape[-1]] = c
    return starts, coeffs


def explicit_call(rep, call: str, pn: str, ts):
    """The call's op on inputs packed by hand on the host
    (:func:`pack_by_hand`), as the Report sent them before it kept its
    tables on the card: the tables packed, the levels broadcast to (B, T)
    and made contiguous, each array copied to the card, the op, the result
    copied back.  Returns (the result as the call returns it, each step's
    host time in ms, ending in a synchronize)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ppoly_eval as ops

    name, kind = QUERY_OPS[call]
    split = {}

    def step(key, fn):
        s, out = host_s(fn)
        split[key] = s * 1e3
        return out

    starts, coeffs = step("pack_ms", lambda: pack_by_hand(rep, kind, pn))
    if call == "kernel_finish_times":
        p_end = rep.proc_results[pn].p_end
        levels = step("levels_ms", lambda: np.full((rep.B, 1), p_end, np.float32))
    else:
        levels = step("levels_ms", lambda: np.ascontiguousarray(
            np.broadcast_to(np.asarray(ts, np.float32), (rep.B, len(ts)))))
    dev = [step(f"h2d_{k}_ms", lambda a=a: torch.as_tensor(a, device=rep.plan.device))
           for k, a in (("starts", starts), ("coeffs", coeffs), ("levels", levels))]
    out = step("kernel_ms", lambda: getattr(ops, name)(*dev))
    outs = out if isinstance(out, tuple) else (out,)
    host = step("d2h_ms", lambda: tuple(o.cpu().numpy() for o in outs))
    if call == "kernel_finish_times":
        fin = host[0][:, 0]
        return np.where(fin >= 1e29, np.inf, fin.astype(np.float64)), split
    return (host if call == "data_ceiling" else host[0]), split


def report_calls(plan, pack, ts) -> dict:
    """On a Report of its own (a warm re-sweep of the pack), each call on
    every process twice in a row: the first and the second call's host
    wall time in ms (the tables reach the card at the first), and both
    results equal bit for bit."""
    rep = plan.sweep(pack, backend="torch")
    out: dict[str, list] = {call: [] for call in QUERY_OPS}
    for pn in rep.order:
        for call in QUERY_OPS:
            fn = query_fn(rep, call, pn, ts)
            first, a = host_s(fn)
            second, b = host_s(fn)
            check(same_result(a, b), f"{call} {pn}: a second call differs")
            out[call].append({"proc": pn, "first_ms": first * 1e3,
                              "second_ms": second * 1e3})
    return out


def report_split(plan, pack, ts) -> dict:
    """The steps of the Report's calls as it takes them, on a Report of its
    own, each on the host clock (ms, ending in a synchronize): the lazy
    ceilings' first access (numpy, once a Report), the tables' packing on
    the host and their copy to the card (the first call's; then they stay
    there), the levels sent as one row and broadcast on the card, each op,
    and its copy back."""
    import torch
    from repro_torch.kernels import ppoly_eval as ops

    rep = plan.sweep(pack, backend="torch")
    out = {}
    for pn in rep.order:
        r = rep.proc_results[pn]
        s = {"ceilings_first_access_ms": host_s(lambda: len(r.ceilings))[0] * 1e3}
        for kind in ("progress", "ceilings"):
            s[f"pack_{kind}_ms"] = host_s(lambda: rep._host_tables(kind, pn))[0] * 1e3
            s[f"pack_and_copy_{kind}_ms"] = host_s(lambda: rep._tables(kind, pn))[0] * 1e3
        s["levels_ms"] = host_s(lambda: rep._levels(ts).contiguous())[0] * 1e3
        for call, (name, kind) in QUERY_OPS.items():
            starts, coeffs = rep._tables(kind, pn)
            levels = (torch.full((rep.B, 1), r.p_end, dtype=torch.float32,
                                 device=starts.device)
                      if call == "kernel_finish_times" else rep._levels(ts))
            k_s, res = host_s(lambda: getattr(ops, name)(starts, coeffs, levels))
            res = res if isinstance(res, tuple) else (res,)
            s[f"{call}_op_ms"] = k_s * 1e3
            s[f"{call}_copy_back_ms"] = host_s(
                lambda: [o.cpu().numpy() for o in res])[0] * 1e3
        out[pn] = s
    return out


def pinned_bytes() -> dict:
    """The pinned host allocator's footprint: the bytes of the blocks it
    owns (in use or cached; it never returns them to the system unless
    asked), of those in use, and the blocks it has had to create."""
    import torch

    st = torch.cuda.host_memory_stats()
    return {"owned_bytes": st.get("allocated_bytes.current"),
            "in_use_bytes": st.get("active_bytes.current"),
            "blocks_created": st.get("num_host_alloc")}


def copy_back(calls) -> dict:
    """Every result of the main path's queries (the device tensors its calls
    returned, all still held, as the main path holds its numpy results)
    copied back once more each way, in turns (every other call pinned
    first), every copy kept to the end as the main path keeps its results:
    into pageable memory (``.cpu().numpy()``, as the Report does) and by one
    ``non_blocking`` copy each into new pinned memory, then one synchronize
    (the alternative it measured against).  Host ms per call each way, and
    the pinned allocator's footprint before and after."""
    import torch

    def pageable(outs):
        return [o.cpu().numpy() for o in outs]

    def pinned(outs):
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        torch.cuda.synchronize()
        return [h.numpy() for h in host]

    out = {"pinned_before": pinned_bytes(), "pageable_ms": {},
           "pinned_ms": {}}
    kept = []
    for i, (name, _args, res) in enumerate(calls):
        res = res if isinstance(res, tuple) else (res,)
        ways = (("pageable", pageable), ("pinned", pinned))
        for way, fn in ways[::-1] if i % 2 else ways:
            s, host = host_s(lambda: fn(res))
            kept.append(host)
            out[f"{way}_ms"].setdefault(name, []).append(s * 1e3)
    out["pinned_after_copies"] = pinned_bytes()
    del kept
    return out


def query_host_times(walls, calls) -> dict:
    """Per Report call, in call order: its host wall time and the device
    time of the one kernel it launched (queued, back to back) on the same
    inputs, and the kernel's share of the wall time."""
    from repro_torch.kernels.ppoly_eval import kernel
    from repro_torch.kernels.ppoly_eval.variants import queued_ms

    check([QUERY_OPS[c][0] for c, _p, _w in walls] == [n for n, _a, _o in calls],
          "the Report's calls and the kernel launches do not pair up")
    out = {}
    for (call, pn, wall), (name, args, _o) in zip(walls, calls):
        k_ms = queued_ms(lambda: getattr(kernel, f"{name}_cuda")(*args), iters=5)
        out.setdefault(call, []).append(
            {"proc": pn, "wall_ms": wall * 1e3, "kernel_ms": k_ms,
             "kernel_share": k_ms / (wall * 1e3)})
    return out


def ppoly_ptxas(name: str, P: int, K: int) -> dict:
    """Registers and spill bytes of ``name``'s kernels at (P, K), from
    ``ptxas -v`` in the build log: the "tile" kernel and the "vec" (for the
    crossing the "row") instances."""
    from repro_torch.kernels.ppoly_eval import kernel

    if name == "ppoly_first_crossing":
        want = {"ppoly_first_crossing_kernel", f"{name}_row_kernel<{K}>"}
    else:
        want = {f"{name}_kernel", f"{name}_vec_kernel<{P},{K}>"}
    return {k: v for k, v in kernel_ptxas(kernel, "ppoly_").items() if k in want}


def ppoly_row(name: str, args, launches: dict, err: float) -> dict:
    """Times at the main path's largest call: the op (the route it takes;
    queued back to back, the smaller of two runs around the plain version),
    the same with the L2 flushed between launches, the "tile" route on the
    same inputs, the plain version; achieved bytes/s and share of the
    bound.  For the crossing also the time of an empty kernel on the row
    route's grid, the launch floor."""
    import torch
    from repro_torch.kernels.ppoly_eval import kernel, ref
    from repro_torch.kernels.ppoly_eval.variants import empty_launcher, queued_ms

    cuda_fn = getattr(kernel, f"{name}_cuda")
    plain_fn = getattr(ref, f"{name}_ref")
    row = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": KERNELS[name], "launches": launches[name]}
    ms = queued_ms(lambda: cuda_fn(*args))
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters=5)
    ms2 = queued_ms(lambda: cuda_fn(*args))
    b_ms, b_by, nbytes = bound(name, args)
    best = min(ms, ms2)
    row.update({"max_abs_err": err, "ms": best, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library_note": "no single PyTorch call evaluates a piecewise "
                "polynomial", "tb_s": nbytes / best / 1e9,
                "share_of_bound": b_ms / best})
    starts, coeffs, _q = args
    launch = getattr(kernel, LAUNCH[name])
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    flushed = queued_ms(lambda: cuda_fn(*args), flush=flush)
    tile_ms = queued_ms(lambda: launch("tile", *args))
    tile_flushed = queued_ms(lambda: launch("tile", *args), flush=flush)
    row.update({f"launches_{rt}": launches[f"{name}_{rt}"]
                for rt in routes_of(name, args)})
    row.update({"flushed_ms": flushed, "flushed_tb_s": nbytes / flushed / 1e9,
                "flushed_share_of_bound": b_ms / flushed,
                "tile_ms": tile_ms, "tile_flushed_ms": tile_flushed,
                "ptxas": ppoly_ptxas(name, starts.shape[-1], coeffs.shape[-1])})
    if name == "ppoly_first_crossing":
        blocks = -(-starts.shape[0] // 8)   # the row route: 8 rows of 128 threads
        empty = empty_launcher(blocks, 128)
        row["launch_floor"] = {"blocks": blocks, "threads": 128,
                               "ms": queued_ms(empty),
                               "flushed_ms": queued_ms(empty, flush=flush)}
    del flush
    row["shape"] = {"starts": list(args[0].shape), "coeffs": list(args[1].shape),
                    "q": list(args[2].shape)}
    return row


# -------------------------------------------------------------- training ----
def grad_case(fn, ins, cots, plain):
    """``fn`` (the op, through its autograd wrapper) and ``plain`` (the
    plain version) on the same card tensors ``ins``, each output dotted
    with its cotangent and differentiated: (outputs, wrapper gradients,
    plain gradients), one per input that requires a gradient."""
    import torch

    def run(f):
        xs = [x.detach().requires_grad_(x.requires_grad) for x in ins]
        outs = f(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o.float() * c).sum() for o, c in zip(outs, cots)).backward()
        return outs, [x.grad for x in xs if x.requires_grad]

    outs, got = run(fn)
    _, want = run(plain)
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in got),
          "an input that requires a gradient got none, or a non-finite one")
    return outs, got, want


def grad_errors(got, want, abs_bar, rel_bar, what: str) -> dict:
    """Each gradient against the plain version's: max abs (at ``abs_bar``
    times max(1, max |want|)) and relative L2 (at ``rel_bar``)."""
    import torch

    worst = {"max_abs_err": 0.0, "rel_l2": 0.0}
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        err = float(diff.max())
        rel = float(torch.linalg.vector_norm(diff)
                    / torch.linalg.vector_norm(w.float()).clamp(min=1e-30))
        check(err <= abs_bar * max(1.0, float(w.float().abs().max())) and rel <= rel_bar,
              f"{what}: gradient max abs {err}, relative L2 {rel}")
        worst = {"max_abs_err": max(worst["max_abs_err"], err),
                 "rel_l2": max(worst["rel_l2"], rel)}
    return worst


def phase_train_grad_kernels():
    """The two LM kernels' autograd wrappers on seeded card tensors: flash
    attention in float32 and bf16 at GQA groups 1, 4 and 8, causal with and
    without a window, S = 200 (off the 64 multiple); wkv6 at chunk 32,
    L = 77 (off the chunk multiple), with a zero s0 and with an s0 that
    requires a gradient.  The wrapper's forward is bit for bit the
    kernel's, every input that requires a gradient gets one, and each
    gradient equals the plain version's autograd gradient on the same
    tensors at the kernel bars."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import MAX_ABS, REL_L2
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import wkv6, wkv_chunked_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")
    errs: dict = {"float32": [], "bfloat16": []}
    cases = 0
    for H, Hkv in ((8, 8), (8, 2), (8, 1)):
        for window in (None, 48):
            for dtype in (torch.float32, torch.bfloat16):
                ins = [torch.randn((2, h, 200, 64), generator=gen, device=dev)
                       .to(dtype).requires_grad_() for h in (H, Hkv, Hkv)]
                cot = torch.randn((2, H, 200, 64), generator=gen, device=dev)
                kw = {"causal": True, "window": window}
                (out,), got, want = grad_case(
                    lambda q, k, v: flash_attention(q, k, v, **kw), ins, (cot,),
                    lambda q, k, v: attention_ref(q, k, v, **kw))
                check(type(out.grad_fn).__name__ == "FlashAttentionFnBackward",
                      f"flash {dtype} group {H // Hkv}: not through the wrapper")
                check(torch.equal(out, fa.flash_attention_cuda(*(x.detach() for x in ins),
                                                               **kw)),
                      "flash: the wrapper's forward is not the kernel's output")
                check(len(got) == 3, "flash: an input got no gradient")
                name = str(dtype).split(".")[-1]
                errs[name].append(grad_errors(got, want, MAX_ABS[dtype], REL_L2[dtype],
                                              f"flash {name} group {H // Hkv} {kw}"))
                cases += 1
    wkv = []
    for s0_grad in (False, True):
        B, L, H, N = 2, 77, 4, 64
        r, k, v, _w, u, s0 = wkv_inputs(gen, B, L, H, N)
        if not s0_grad:
            s0 = torch.zeros_like(s0)
        ins = [r.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
               _w.requires_grad_(), u.requires_grad_(), s0.requires_grad_(s0_grad)]
        cots = (torch.randn((B, L, H, N), generator=gen, device=dev),
                torch.randn((B, H, N, N), generator=gen, device=dev))
        outs, got, want = grad_case(lambda *a: wkv6(*a, chunk=32), ins, cots,
                                    lambda *a: wkv_chunked_ref(*a, chunk=32))
        check(type(outs[0].grad_fn).__name__ == "Wkv6FnBackward",
              "wkv6: not through the wrapper")
        direct = wk.wkv6_cuda(*(x.detach() for x in ins), chunk=32)
        check(all(torch.equal(a, b) for a, b in zip(outs, direct)),
              "wkv6: the wrapper's forward is not the kernel's output")
        check(len(got) == 5 + s0_grad, "wkv6: an input got no gradient")
        wkv.append(grad_errors(got, want, WKV_ABS, WKV_REL_L2, f"wkv6 s0 grad {s0_grad}"))
        cases += 1
    emit("train_grad_kernels", cases=cases, forward_bitwise=True,
         flash={n: worst_of(e) for n, e in errs.items()}, wkv6=worst_of(wkv),
         flash_tol={"float32": [MAX_ABS[torch.float32], REL_L2[torch.float32]],
                    "bfloat16": [MAX_ABS[torch.bfloat16], REL_L2[torch.bfloat16]]},
         wkv6_tol=[WKV_ABS, WKV_REL_L2])


def card_vs_cpu_step(cfg, data_cfg, ckpt_dir: Path) -> dict:
    """One train step from the same parameters (``init_params(seed=0)`` on
    the card, carried to the CPU by ``params_to_arrays``) and the same
    batch on the card and on the CPU: the loss at TRAIN_LOSS_RTOL, each
    gradient leaf (the reference's stacked layout) within relative L2
    TRAIN_GRAD_REL_L2.  Returns the worst of each and the two step times."""
    import numpy as np
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.convert import (array_from_tensor, params_from_arrays,
                                            params_to_arrays, reference_layout)
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    batch = SyntheticTokenPipeline(data_cfg).batch_at(0)
    card = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir)), data_cfg=data_cfg)
    cpu = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir)), data_cfg=data_cfg,
                  device="cpu")
    model, st = card.init_state()
    cpu_model = params_from_arrays(params_to_arrays(model), cfg, device="cpu")
    cpu_model.requires_grad_(True)
    cpu_st = adamw_init(list(cpu_model.parameters()), cpu.opt_cfg)
    card_s, m = host_s(lambda: card.train_step(model, st, card.device_batch(batch)))
    t0 = time.perf_counter()
    m_cpu = cpu.train_step(cpu_model, cpu_st, cpu.device_batch(batch))
    cpu_s = time.perf_counter() - t0
    rels = {}
    ps, cps = list(model.parameters()), list(cpu_model.parameters())
    for path, idx in reference_layout(model).items():
        # a reference leaf: the layer slices of a block leaf, stacked
        got, want = (np.concatenate([array_from_tensor(p[j].grad).ravel() for j in idx])
                     .astype(np.float64) for p in (ps, cps))
        rels[path] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    del ps, cps
    del model, st, cpu_model, cpu_st
    worst = max(rels, key=rels.get)
    loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"{cfg.name}: card loss {loss}, CPU {loss_cpu}")
    check(rels[worst] <= TRAIN_GRAD_REL_L2,
          f"{cfg.name}: gradient {worst} relative L2 {rels[worst]} card against CPU")
    return {"loss_card": loss, "loss_cpu": loss_cpu, "loss_rel": loss_rel,
            "loss_rtol": TRAIN_LOSS_RTOL, "grad_leaves": len(rels),
            "grad_worst_leaf": worst, "grad_worst_rel_l2": rels[worst],
            "grad_rel_l2_tol": TRAIN_GRAD_REL_L2, "card_step_s": card_s,
            "cpu_step_s": cpu_s}


def same_state(a: dict, b: dict) -> bool:
    """Two state trees (numpy leaves) equal bit for bit."""
    import numpy as np

    return a.keys() == b.keys() and all(
        same_state(a[k], b[k]) if isinstance(a[k], dict)
        else (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])) for k in a)


def phase_train_100m() -> dict:
    """``repro_torch.launch.train.main`` with the launcher's defaults
    (dense-100m, float32: the float32 flash kernel at head_dim 64; B = 8,
    S = 256) for TRAIN_STEPS steps, checkpoints under build/; the loss
    falls.  Then a run stopped at TRAIN_STOP and restarted to TRAIN_STEPS:
    the restore gives the stopped run's state bit for bit and the
    restarted losses are the uninterrupted run's within TRAIN_RESUME_TOL.
    Then one step on the card against the CPU.  Returns the launches of the
    launcher's run."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, data_config_for

    base = ROOT / "build" / "train_100m"
    shutil.rmtree(base, ignore_errors=True)
    reset_launches()
    whole = train.main(["--steps", str(TRAIN_STEPS), "--ckpt-dir", str(base / "whole")])
    torch.cuda.synchronize()
    launches = read_launches()
    losses = whole["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "train_100m losses")
    check(whole["loss_last"] < whole["loss_first"],
          f"train_100m: mean of the last 5 losses {whole['loss_last']} not below "
          f"the first {whole['loss_first']}")
    check(launches["flash_attention"] > 0, "train_100m never launched the flash kernel")
    cfg = train.preset_100m()
    dc = data_config_for(cfg, 256, 8)

    def trainer(steps):
        return Trainer(cfg, TrainerConfig(steps=steps, ckpt_dir=str(base / "cut")),
                       data_cfg=dc)

    first = trainer(TRAIN_STOP)
    s_first = first.run()
    at_stop = first.state_tree(first.model, first.opt_state)
    step_ms = float(np.median(first.monitor.durations)) * 1e3
    del first
    again = trainer(TRAIN_STEPS)
    model, st = again.init_state()
    again.restore(TRAIN_STOP, model, st)
    check(same_state(again.state_tree(model, st), at_stop),
          f"the step-{TRAIN_STOP} checkpoint does not restore the stopped state bit for bit")
    del model, st, at_stop
    s_rest = again.run()
    rest = np.asarray(s_rest["losses"])
    want = np.asarray(losses[TRAIN_STOP:])
    resume_rel = float(np.max(np.abs(rest - want) / np.abs(want)))
    check(len(rest) == TRAIN_STEPS - TRAIN_STOP and resume_rel <= TRAIN_RESUME_TOL,
          f"restarted losses {rest.tolist()} against {want.tolist()}")
    del again
    xcheck = card_vs_cpu_step(cfg, dc, base / "xcheck")
    shutil.rmtree(base, ignore_errors=True)
    emit("train_100m", arch=cfg.name, dtype=cfg.dtype, n_params=cfg.n_params(),
         batch=dc.global_batch, seq=dc.seq_len, steps=TRAIN_STEPS,
         loss_first=whole["loss_first"], loss_last=whole["loss_last"],
         losses=losses, wall_s=whole["wall_s"], median_step_ms=step_ms,
         tok_s=dc.global_batch * dc.seq_len / step_ms * 1e3,
         stragglers=whole["stragglers"], stop_at=TRAIN_STOP,
         stopped_first=s_first["loss_first"], restored_bitwise=True,
         resume_max_rel=resume_rel, resume_tol=TRAIN_RESUME_TOL,
         launches=launches, card_vs_cpu=xcheck)
    return launches


def train_timed(phase: str, cfg, reduced: dict, mixer: str) -> dict:
    """TRAIN_TIMED eager steps after one warm-up, bf16 parameters and
    float32 moments, B x S = TRAIN_BATCH x TRAIN_SEQ from the pipeline;
    every loss and gradient norm finite, every parameter with a finite
    gradient, every mixer kernel call on its route.  Returns the launches."""
    import math
    import shutil
    import statistics

    import torch
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, data_config_for

    dc = data_config_for(cfg, TRAIN_SEQ, TRAIN_BATCH)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(ROOT / "build" / phase)), data_cfg=dc)
    init_s, (model, st) = host_s(tr.init_state)
    state_bytes = sum(p.numel() * p.element_size() * 2 for p in model.parameters()) + sum(
        m.numel() * m.element_size() for m in st["m"] + st["v"])
    pipe = SyntheticTokenPipeline(dc)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, metrics = [], []
    for step in range(TRAIN_TIMED + 1):
        batch = tr.device_batch(pipe.batch_at(step))
        secs, m = host_s(lambda: tr.train_step(model, st, batch))
        times.append(secs)
        metrics.append({k: float(v) for k, v in m.items()})
        check(all(map(math.isfinite, metrics[-1].values())),
              f"{phase} step {step}: {metrics[-1]}")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in model.parameters()), f"{phase}: a parameter got no finite gradient")
    steps = TRAIN_TIMED + 1
    per_step = cfg.n_layers * (2 if cfg.remat else 1)   # remat runs it again
    if mixer == "attn":
        check(launches["flash_attention"] == launches["flash_attention_tc"]
              == steps * per_step,
              f"{phase}: {launches['flash_attention']} flash launches, "
              f"{launches['flash_attention_tc']} on the tensor cores, "
              f"{steps} steps x {per_step} (forward and remat)")
    else:
        check(launches["wkv6"] == launches["wkv6_chunked"] == steps * per_step,
              f"{phase}: {launches['wkv6']} wkv6 calls, {launches['wkv6_chunked']} "
              f"chunked, {steps} steps x {per_step} (forward and remat)")
    median = statistics.median(times[1:])
    batch = tr.device_batch(pipe.batch_at(steps))
    extra = {}
    if mixer == "rwkv6":
        extra["wkv_min_head_rms"] = wkv_head_rms(model, batch)
    split = step_split(tr, model, st, batch)
    del model, st, tr
    shutil.rmtree(ROOT / "build" / phase, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(phase, arch=cfg.name, dtype=cfg.dtype, reduced=reduced, n_params=cfg.n_params(),
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps, warmup=1, remat=cfg.remat,
         init_s=init_s, first_step_s=times[0], step_s=times[1:], median_step_s=median,
         tok_s=TRAIN_BATCH * TRAIN_SEQ / median, peak_memory_bytes=peak,
         state_bytes=state_bytes, losses=[m["loss"] for m in metrics],
         grad_norms=[m["grad_norm"] for m in metrics], launches=launches,
         split=split, **extra)
    return launches


def wkv_head_rms(model, batch) -> list[float]:
    """Each RWKV layer's smallest per-head RMS of the wkv output over one
    batch, where the time mix divides by it (``max(rms, 1e-6)``): a forward
    without autograd, the kernel's outputs recorded."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import transformer as T

    with torch.no_grad(), Recorder(wk, ["wkv6"]) as rec:
        T.loss_fn(model, model.cfg, batch)
    return [float(y.square().mean(-1).sqrt().min()) for _n, _a, (y, _s) in rec.calls]


def step_split(tr, model, st, batch) -> dict:
    """One more step taken apart as ``Trainer.train_step`` runs it: host
    seconds, each ending in a synchronize, of the forward and loss, the
    backward (with remat's second forward and the kernels' recomputed plain
    backward) and the AdamW update."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_update

    params = list(model.parameters())
    for p in params:
        p.grad = None
    fwd, loss = host_s(lambda: T.loss_fn(model, model.cfg, batch))
    bwd, _ = host_s(loss.backward)
    upd, _ = host_s(lambda: adamw_update([p.grad for p in params], st, params,
                                         tr.opt_cfg))
    return {"forward_s": fwd, "backward_s": bwd, "adamw_s": upd}


def phase_train_yi() -> dict:
    cfg, reduced = cut_config(LM_ARCH, TRAIN_YI_LAYERS)
    return train_timed("train_yi", cfg, reduced, "attn")


def phase_train_rwkv() -> tuple[dict, dict]:
    """rwkv6-1.6b at full width and depth (:func:`train_timed`), then cut to
    RWKV_CPU_LAYERS layers in float32: one step on the card against the CPU
    at RWKV_CPU_SHAPE.  Returns the launches of both."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.trainer import data_config_for

    launches = train_timed("train_rwkv", get_config(RWKV_ARCH), {}, "rwkv6")
    cfg32, reduced = cut_config(RWKV_ARCH, RWKV_CPU_LAYERS)
    cfg32 = dataclasses.replace(cfg32, dtype="float32")
    B, S = RWKV_CPU_SHAPE
    reset_launches()
    ckpt = ROOT / "build" / "train_rwkv_f32"
    xcheck = card_vs_cpu_step(cfg32, data_config_for(cfg32, S, B), ckpt)
    torch.cuda.synchronize()
    f32_launches = read_launches()
    shutil.rmtree(ckpt, ignore_errors=True)
    check(f32_launches["wkv6"] == f32_launches["wkv6_chunked"] == 2 * RWKV_CPU_LAYERS,
          f"train_rwkv_f32: {f32_launches['wkv6']} wkv6 calls")
    emit("train_rwkv_f32", arch=cfg32.name, dtype=cfg32.dtype, reduced=reduced,
         batch=B, seq=S, launches=f32_launches, card_vs_cpu=xcheck)
    return launches, f32_launches


def count_step(cfg, shape) -> dict:
    """The per-device counts of one step on a 1x1 mesh
    (``repro_torch.launch.specs.count_cell`` on meta tensors, no device),
    taken at one and two scan groups and extended linearly to the
    config's ``n_groups``: every group runs the same ops on the same shapes,
    so the count is exactly linear in the groups.  Returns flops, bytes
    and the seconds it took."""
    import dataclasses

    from repro_torch.distributed import axis_rules
    from repro_torch.launch.dryrun import flash_estimate, track_sizes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import count_cell, make_cell

    t0 = time.perf_counter()
    mesh = make_host_mesh()
    one_card = {"data": 1, "model": 1}
    reps = []
    for g in (1, 2):
        c = dataclasses.replace(cfg, n_layers=g * cfg.period)
        with axis_rules(mesh):
            reps.append(count_cell(make_cell(c, shape), mesh,
                                   track_sizes(c, shape, one_card)))
    one, two = reps
    n = cfg.n_groups
    out = {key: getattr(one, key) + (n - 1) * (getattr(two, key) - getattr(one, key))
           for key in ("flops", "bytes", "tracked_bytes")}
    if out["tracked_bytes"] > 0:
        out["flash_io_bytes"], out["flash_bytes"] = flash_estimate(
            cfg, shape, one_card, out["bytes"], out["tracked_bytes"])
    return {**out, "count_s": time.perf_counter() - t0}


def phase_perfmodel_steps():
    """The perf model held against the card: for the steps train_100m,
    train_yi, train_rwkv and lm_prefill measured (their medians, not run
    again; lm_prefill's single warm run), the same step at the same config,
    cut and shape counted on a 1x1 mesh, its roofline terms (H100
    constants) and the BottleMod step model's prediction with the host
    pipeline's rate measured from ``batch_at``.  Every measured step must
    be at or above its compute bound.  The linear extension of the counts
    is checked once against a whole count (yi-9b's prefill)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed import axis_rules
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import count_cell, make_cell
    from repro_torch.perfmodel import roofline, stepmodel
    from repro_torch.runtime.trainer import data_config_for

    t0 = time.perf_counter()
    steps = (
        ("train_100m", train.preset_100m(), ShapeSpec("train_100m", 256, 8, "train"),
         EMITTED["train_100m"]["median_step_ms"] / 1e3),
        ("train_yi", cut_config(LM_ARCH, TRAIN_YI_LAYERS)[0],
         ShapeSpec("train_yi", TRAIN_SEQ, TRAIN_BATCH, "train"),
         EMITTED["train_yi"]["median_step_s"]),
        ("train_rwkv", get_config(RWKV_ARCH),
         ShapeSpec("train_rwkv", TRAIN_SEQ, TRAIN_BATCH, "train"),
         EMITTED["train_rwkv"]["median_step_s"]),
        ("lm_prefill", get_config(LM_ARCH), ShapeSpec("lm_prefill", LM_SEQ, LM_BATCH, "prefill"),
         EMITTED["lm_prefill"]["warm_s"]),
    )
    out = {}
    for name, cfg, shape, measured in steps:
        counts = count_step(cfg, shape)
        if name == "lm_prefill":
            mesh = make_host_mesh()
            with axis_rules(mesh):
                whole = count_cell(make_cell(cfg, shape), mesh)
            check(whole.flops == counts["flops"] and whole.bytes == counts["bytes"],
                  f"{name}: linear count {counts} against the whole count "
                  f"{whole.flops}, {whole.bytes}")
        rr = roofline.roofline_terms(cfg=cfg, shape=shape, n_chips=1,
                                     flops_per_device=counts["flops"],
                                     bytes_per_device=counts["bytes"],
                                     collective_bytes_per_device=0.0)
        pipe = SyntheticTokenPipeline(data_config_for(cfg, shape.seq_len,
                                                      shape.global_batch))
        data_s = min(host_s(lambda i=i: pipe.batch_at(i))[0] for i in range(5))
        pred = stepmodel.predict(stepmodel.StepModelInputs(
            flops_per_step=counts["flops"], hbm_bytes_per_step=counts["bytes"],
            coll_bytes_per_step=0.0, n_steps=10, data_rate_steps_per_s=1.0 / data_s))
        flash = {}
        if "flash_bytes" in counts:     # the score chain in the flash kernel
            flash = {"memory_flash_s": counts["flash_bytes"] / roofline.HBM_BW,
                     "predicted_flash_s": stepmodel.predict(stepmodel.StepModelInputs(
                         flops_per_step=counts["flops"],
                         hbm_bytes_per_step=counts["flash_bytes"], coll_bytes_per_step=0.0,
                         n_steps=10, data_rate_steps_per_s=1.0 / data_s)).step_time_s}
        check(measured >= rr["compute_s"],
              f"{name}: measured {measured} s below the compute bound {rr['compute_s']} s")
        out[name] = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
                     "batch": shape.global_batch, "seq": shape.seq_len, "kind": shape.kind,
                     **counts, "compute_s": rr["compute_s"], "memory_s": rr["memory_s"],
                     "dominant": rr["dominant"], "data_rate_steps_per_s": 1.0 / data_s,
                     "predicted_s": pred.step_time_s, "predicted_bottleneck": pred.dominant(),
                     "measured_s": measured,
                     "measured_over_predicted": measured / pred.step_time_s,
                     "measured_over_compute": measured / rr["compute_s"], **flash}
    emit("perfmodel_steps", steps=out, peak_flops=roofline.PEAK_FLOPS,
         hbm_bw=roofline.HBM_BW, seconds=time.perf_counter() - t0)


def run_children(cmds: list[list[str]], timeout: float) -> list[tuple]:
    """Each command in its own child process, all started together (the
    port on ``PYTHONPATH``); (result, wall seconds) of each, in order."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    def one(cmd):
        t1 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                             cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(SRC)})
        return res, time.perf_counter() - t1

    with ThreadPoolExecutor(len(cmds)) as ex:
        return list(ex.map(one, cmds))


def phase_dryrun_cells():
    """``python -m repro_torch.launch.dryrun`` in a child process for each
    of DRYRUN_CELLS on the 256-card fake mesh (the reference's integration
    cell, rwkv6-1.6b decode, yi-9b's training step and qwen3-moe's decode),
    the children started together: status ok, 256 chips, FLOPs counted,
    the decodes memory-bound, the step model's prediction from each record
    positive."""
    import shutil

    from repro_torch.perfmodel.stepmodel import from_dryrun_record, predict

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_cells"
    shutil.rmtree(out_dir, ignore_errors=True)
    cells = {}
    runs = run_children([[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", "single", "--out", str(out_dir)]
                         for arch, shape in DRYRUN_CELLS], timeout=900)
    for (arch, shape), (res, wall) in zip(DRYRUN_CELLS, runs):
        check(res.returncode == 0, f"dry-run {arch} {shape}: exit {res.returncode}\n"
                                   f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
        rec = json.loads((out_dir / f"{arch}_{shape}_single.json").read_text())
        rr = rec["roofline"]
        check(rec["status"] == "ok" and rec["chips"] == 256, f"{arch} {shape}: {rec}")
        check(shape != "decode_32k" or rr["dominant"] == "memory",
              f"{arch} {shape}: {rr['dominant']}-bound")
        check(rec["per_device"]["flops"] > 0, f"{arch} {shape}: no FLOPs counted")
        p = predict(from_dryrun_record(rec, n_steps=10, data_rate_steps_per_s=1e6))
        check(p.step_time_s > 0, f"{arch} {shape}: step time {p.step_time_s}")
        cells[f"{arch}_{shape}"] = {
            **rec["per_device"], "dominant": rr["dominant"], "compute_s": rr["compute_s"],
            "memory_s": rr["memory_s"], "collective_s": rr["collective_s"],
            "useful_flops_ratio": rr["useful_flops_ratio"], "n_ops": rec["collectives"]["n_ops"],
            "count_s": rec["count_s"], "wall_s": wall, "predicted_step_s": p.step_time_s,
            "memory": rec["memory"], "torch": rec["torch"], "status": rec["status"]}
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("dryrun_cells", cells=cells, seconds=time.perf_counter() - t0)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    # the plain versions are the reference: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import gc

    from repro_torch.analysis import scenarios
    from repro_torch.configs import paper_workflow as paper
    from repro_torch.kernels.ppoly_eval import kernel

    smi = phase_env()
    phase_build()
    phase_kernels()
    flash_long_case = phase_flash_kernels()
    phase_wkv6_kernels()
    wkv_bf16_case = phase_wkv6_bf16_kernels()

    # ---- the analysis path, counted: sweeps and the Report's curve queries ----
    with Recorder(kernel, KERNELS) as rec:
        reset_launches()
        grid = phase_sweep_fig7(paper)
        rep, pack = phase_sweep_b10k(paper, scenarios)
        ts, shapes, walls, results = phase_queries(rep)
        torch.cuda.synchronize()
        launches = read_launches()
    errs = {n: 0.0 for n in KERNELS}
    for name, args, out in rec.calls:
        errs[name] = max(errs[name], hold_against_plain(name, args, out))
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    for name, rt in (("ppoly_eval", "vec"), ("ppoly_min_eval", "vec"),
                     ("ppoly_first_crossing", "row")):
        check(launches[name] == launches[f"{name}_{rt}"] == len(rep.order),
              f"{launches[name]} {name} calls, {launches[f'{name}_{rt}']} on the "
              f"{rt} route, {len(rep.order)} processes")
    host = query_host_times(walls, rec.calls)
    copies = copy_back(rec.calls)
    explicit = {}
    for call, pn, got in results:
        want, split = explicit_call(rep, call, pn, ts)
        check(same_result(got, want),
              f"{call} {pn}: differs from the op on explicitly packed inputs")
        explicit.setdefault(call, []).append({"proc": pn, **split})
    del results
    emit("queries", T=T_QUERIES, B=rep.B, calls=len(rec.calls),
         launches=launches, max_abs_err=errs, shapes=shapes, host=host,
         copy_back=copies, explicit=explicit, bitwise_vs_explicit=True,
         first_second=report_calls(rep.plan, pack, ts),
         split=report_split(rep.plan, pack, ts))

    # ---- times at the main path's shapes (the largest call per kernel) ----
    rows = []
    for name in KERNELS:
        args = max((a for n, a, _o in rec.calls if n == name),
                   key=lambda a: sum(x.numel() for x in a))
        rows.append(ppoly_row(name, args, launches, errs[name]))
    analysis_peak = torch.cuda.max_memory_allocated()
    del rec, rep, pack, args
    gc.collect()
    torch.cuda.empty_cache()

    # ---- optimize and Monte Carlo: float64 PyTorch, no kernel of their own ----
    reset_launches()
    phase_optimize_fig7(paper, scenarios, grid)
    phase_optimize_grad(paper, scenarios)
    phase_mc_b10k(paper)
    phase_optimize_mc(paper)
    torch.cuda.synchronize()
    emit("optimize_and_mc_launches", launches=read_launches())
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the analysis service: each phase counted from 0 ----
    service = {}
    for name, run in (("service_load", phase_service_load),
                      ("service_b10k", lambda: phase_service_b10k(paper, scenarios)),
                      ("service_faults", lambda: phase_service_faults(paper)),
                      ("service_durable", lambda: phase_service_durable(paper)),
                      ("service_mc", lambda: phase_service_mc(paper))):
        reset_launches()
        counts = run()
        torch.cuda.synchronize()
        counts = read_launches() if counts is None else counts
        service[name] = {k: n for k, n in counts.items() if n}
    emit("service_launches", launches=service)

    # ---- the rest of the analysis side: DES, shared link, trace, shim ----
    rest = {}
    for name, run in (("des_vs_model", lambda: phase_des_vs_model(paper)),
                      ("shared_link", lambda: phase_shared_link(paper)),
                      ("trace_report", lambda: phase_trace_report(paper, scenarios)),
                      ("sweep_shim", lambda: phase_sweep_shim(paper))):
        reset_launches()
        run()
        torch.cuda.synchronize()
        rest[name] = {k: n for k, n in read_launches().items() if n}
    emit("analysis_rest_launches", launches=rest)
    # ---- sharded packs: counted from 0 inside the phase ----
    shard_launches, shard_errs = phase_shard_sweep(paper, scenarios, kernel)
    gc.collect()
    torch.cuda.empty_cache()
    for row in rows:
        row["launches_by_path"] = {"analysis": row["launches"], **{
            name: counts.get(row["name"], 0) for name, counts in service.items()},
            "shard_sweep": shard_launches[row["name"]]}
        row["max_abs_err"] = max(row["max_abs_err"], shard_errs[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the serving path: prefill, then the launcher's cached decode ----
    cfg, model, lm_launches, flash_errs, first = phase_lm_prefill()
    phase_lm_serve(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    attn_bf16_launches = phase_attn_bf16_card()
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(flash_row(lm_launches, flash_errs, first, flash_long_case))
    del first
    gc.collect()
    torch.cuda.empty_cache()

    # ---- RWKV-6 serving: prefill, then the launcher's cached decode ----
    cfg, model, rwkv_launches, wkv_errs, first = phase_lm_prefill_rwkv()
    serve_launches = phase_lm_serve_rwkv(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    wkv_launches = {key: rwkv_launches[key] + serve_launches[key]
                    for key in ("wkv6", "wkv6_chunked", "wkv6_serial")}
    wkv_launches["by_phase"] = {"lm_prefill_rwkv": rwkv_launches["wkv6"],
                                "lm_serve_rwkv": serve_launches["wkv6"]}
    rows.append(wkv_row(wkv_launches, wkv_errs, first))
    del first
    gc.collect()
    torch.cuda.empty_cache()
    _bf16_launches, bf16_row = phase_lm_rwkv_bf16(wkv_bf16_case)
    rows.append(bf16_row)
    del wkv_bf16_case
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the MoE and Mamba families: prefill, the launcher, float32 check ----
    flash = next(r for r in rows if r["name"] == "flash_attention")
    flash["launches_by_path"] = {"lm_prefill": flash["launches"],
                                 "attn_bf16_card": attn_bf16_launches["flash_attention"]}
    flash["by_shape"] = {}
    for arch, depth, tag in ((MOE_ARCH, MOE_LAYERS, "moe"),
                             (JAMBA_ARCH, JAMBA_LAYERS, "jamba")):
        cfg, model, cut_launches, err, first = phase_lm_prefill_cut(
            f"lm_prefill_{tag}", arch, depth)
        flash["launches_by_path"][f"lm_prefill_{tag}"] = cut_launches["flash_attention"]
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        flash["by_shape"][f"lm_prefill_{tag}"] = flash_shape_times(first)
        del first
        served = serve_cut(arch, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        emit(f"lm_serve_{tag}", reduced=cut_config(arch, depth)[1], **served,
             **crosscheck_f32(cfg))
        gc.collect()
        torch.cuda.empty_cache()
    # ---- training: the kernels' gradients, then each training path ----
    t_train = time.perf_counter()
    phase_train_grad_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    wkv = next(r for r in rows if r["name"] == "wkv6")
    for tag, run in (("train_100m", phase_train_100m), ("train_yi", phase_train_yi)):
        counts = run()
        flash["launches_by_path"][tag] = counts["flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    flash["launches_by_path_note"] = ("train_*: forward and remat's second "
                                      "forward; train_100m on the float32 kernel")
    rwkv_counts, f32_counts = phase_train_rwkv()
    wkv["launches_by_phase"]["train_rwkv"] = rwkv_counts["wkv6"]
    wkv["launches_by_phase"]["train_rwkv_f32"] = f32_counts["wkv6"]
    gc.collect()
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t_train
    # ---- the perf model against the steps measured, then the dry-run ----
    phase_perfmodel_steps()
    phase_dryrun_cells()
    phase_examples_torch()
    import torch.distributed

    check(not torch.distributed.is_initialized(),
          "a torch.distributed process group is left in this process")
    new_phases = ("wkv6_bf16_kernels", "attn_bf16_card", "lm_rwkv_bf16",
                  "perfmodel_steps", "dryrun_cells")
    emit("timing", script_s=time.perf_counter() - t_start, train_phases_s=train_s,
         bf16_and_perfmodel_phases_s=sum(EMITTED[p]["seconds"] for p in new_phases),
         shard_and_examples_phases_s=sum(EMITTED[p]["seconds"]
                                         for p in ("shard_sweep", "examples_torch")),
         analysis_peak_memory_bytes=analysis_peak,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
