#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each
against its plain PyTorch version, drives the port's main path — compile ->
prepare -> fused sweep -> Report, with the Report's curve queries — on the
card, checks the results, and times the kernels.  Every phase prints one
JSON line; any failure raises and ends the run with a non-zero exit.  The
last line is ``{"ok": true, "device": {...}}``.

Phases: env, build, kernels (random ragged shapes), sweep_fig7 (B = 600,
the paper's Fig. 7 sweep), sweep_b10k_ramped (B = 10,000 with ramped link
allocations), queries (T = 1024 curve queries on the B = 10,000 Report),
then the per-kernel line with launches on the main path, errors and times
at the main path's shapes.

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


def emit(phase: str, **kv) -> None:
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
class Recorder:
    """Wraps the three kernel wrappers while the main path runs and keeps
    every call's inputs and outputs, so each can be held against the plain
    version afterwards.  The launch counts stay in the wrappers."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls: list[tuple[str, tuple, object]] = []
        self._orig = {}

    def __enter__(self):
        for name in KERNELS:
            attr = f"{name}_cuda"
            orig = getattr(self.kernel, attr)
            self._orig[attr] = orig

            def shim(*args, _name=name, _orig=orig):
                out = _orig(*args)
                self.calls.append((_name, args, out))
                return out

            setattr(self.kernel, attr, shim)
        return self

    def __exit__(self, *exc):
        for attr, orig in self._orig.items():
            setattr(self.kernel, attr, orig)
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
def bound(name: str, args) -> tuple[float, str]:
    """Least time for the work on these inputs: max(bytes moved / memory
    rate, float32 operations / peak rate), each input read once and each
    output written once; data-dependent work counted from these inputs."""
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
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.kernels.ppoly_eval import kernel

    t0 = time.perf_counter()
    lib = kernel.library()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib._name),
         flags=list(kernel.NVCC_FLAGS))


def phase_kernels():
    """Seeded random ragged shapes: B and T off the block multiples, P up to
    64, K in 1..3, F up to 6 with absent slots, quadratic crossings and
    levels never reached."""
    import numpy as np
    import torch
    from repro_torch.kernels.ppoly_eval import kernel

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = {n: 0.0 for n in KERNELS}
    cases = 0
    for B, T, P, K in [(1, 1, 1, 1), (7, 129, 3, 2), (37, 1000, 64, 3),
                       (513, 77, 17, 1), (2049, 300, 5, 3), (10, 4097, 40, 2)]:
        F = int(rng.integers(1, 7))
        starts = np.sort(rng.uniform(0.0, 50.0, (B, F, P)), -1)
        starts[..., 0] = 0.0
        if P > 2:   # a duplicate start (a jump) in some rows
            starts[::3, :, 2] = starts[::3, :, 1]
        n_real = rng.integers(1, P + 1, (B, F))
        starts[np.arange(P)[None, None] >= n_real[..., None]] = 1e30
        absent = rng.random((B, F)) < 0.25
        absent[0, 0] = False
        starts[absent] = 1e30
        # monotone pieces: non-negative slopes and curvature, rising values
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
            cases += 1
    emit("kernels", cases=cases, tol=TOL, max_abs_err=worst)


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
    return plan


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
    return rep


def phase_queries(rep):
    import numpy as np

    ts = np.linspace(0.0, float(np.max(rep.makespans)) * 1.05, T_QUERIES)
    shapes = {}
    for pn in rep.order:
        prog = rep.sample_progress(pn, ts)
        vals, arg = rep.data_ceiling(pn, ts)
        fin = rep.kernel_finish_times(pn)
        check(prog.shape == (rep.B, T_QUERIES) and np.isfinite(prog).all(),
              f"sample_progress {pn}: shape {prog.shape} / non-finite")
        check(vals.shape == arg.shape == (rep.B, T_QUERIES),
              f"data_ceiling {pn}: shapes {vals.shape} {arg.shape}")
        np.testing.assert_array_equal(np.isfinite(fin),
                                      np.isfinite(rep.finish[pn]))
        ok = np.isfinite(fin)
        np.testing.assert_allclose(fin[ok], rep.finish[pn][ok], rtol=1e-4,
                                   err_msg=f"kernel_finish_times {pn}")
        shapes[pn] = {"progress": list(prog.shape), "ceiling_slots":
                      len(rep.proc_results[pn].ceilings)}
    return shapes


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
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)

    from repro_torch.analysis import scenarios
    from repro_torch.configs import paper_workflow as paper
    from repro_torch.kernels.ppoly_eval import kernel, ref

    smi = phase_env()
    phase_build()
    phase_kernels()

    # ---- the main path, counted: sweeps and the Report's curve queries ----
    with Recorder(kernel) as rec:
        kernel.reset_launches()
        phase_sweep_fig7(paper)
        rep = phase_sweep_b10k(paper, scenarios)
        shapes = phase_queries(rep)
        torch.cuda.synchronize()
        launches = dict(kernel.launches)
    errs = {n: 0.0 for n in KERNELS}
    for name, args, out in rec.calls:
        errs[name] = max(errs[name], hold_against_plain(name, args, out))
    emit("queries", T=T_QUERIES, B=rep.B, calls=len(rec.calls),
         launches=launches, max_abs_err=errs, shapes=shapes)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")

    # ---- times at the main path's shapes (the largest call per kernel) ----
    rows = []
    for name in KERNELS:
        args = max((a for n, a, _o in rec.calls if n == name),
                   key=lambda a: sum(x.numel() for x in a))
        cuda_fn = getattr(kernel, f"{name}_cuda")
        plain_fn = getattr(ref, f"{name}_ref")
        ms = cuda_ms(lambda: cuda_fn(*args))
        plain_ms = cuda_ms(lambda: plain_fn(*args), iters=5)
        ms2 = cuda_ms(lambda: cuda_fn(*args))
        b_ms, b_by = bound(name, args)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": KERNELS[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": min(ms, ms2),
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None,
                     "shape": {"starts": list(args[0].shape),
                               "coeffs": list(args[1].shape),
                               "q": list(args[2].shape)}})
    emit("timing", peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
