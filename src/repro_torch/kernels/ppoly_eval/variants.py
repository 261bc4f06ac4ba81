"""The kernels' launch constants and the first crossing's two routes
against each other, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ppoly_eval.variants

Builds copies of ``csrc/ppoly_eval.cu`` that differ from it in one constant
each (16-byte loads per lane, warps per block of the "vec" kernels, threads
per block of the crossing's "row" kernel), with the library's own flags,
into ``build/repro_torch/``; then, at the analysis path's shapes
(B = 10,000, T = 1024, P = 9, K = 3; F = 2 for the minimum; T = 1 for the
crossing), holds each variant bit for bit against the source as it stands
and times both "vec" kernels and the "row" crossing of each, in turns (all
variants, then all again in reverse order), by CUDA events around each
launch with every launch queued before the card reaches it, back to back
and with the L2 flushed (a 128 MB write) between launches.  Prints one JSON
line per variant: its changes, the kernels' registers and spills, and the
times.  Then one line per T of the crossing's "row" and "tile" routes on
the same inputs (B = 10,000, P = 9, K = 3; held bit for bit), in turns,
which places ``kernel.ROW_MAX_T``, and one line with the time of an empty kernel on the row route's
grid (:func:`empty_launcher`): the floor of a launch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..build import build, build_dir, ptxas_usage, require_card
from . import kernel

#: name -> (text in the source, its replacement), applied in order
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "source": [],
    "loads4": [("constexpr int kVecLoads = 2;", "constexpr int kVecLoads = 4;")],
    "loads8": [("constexpr int kVecLoads = 2;", "constexpr int kVecLoads = 8;")],
    "warps8": [("constexpr int kVecWarps = 4;", "constexpr int kVecWarps = 8;")],
    "row64": [("constexpr int kRowThreads = 128;", "constexpr int kRowThreads = 64;")],
    "row256": [("constexpr int kRowThreads = 128;", "constexpr int kRowThreads = 256;")],
}
B, T, P, K, F = 10_000, 1024, 9, 3, 2
#: levels a row at which the crossing's routes are timed against each other
CROSSING_T = (1, 2, 4, 8, 16, 17, 24, 32, 64, 128)

_EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(unsigned blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def _library(name: str, edits) -> tuple[ctypes.CDLL, dict]:
    text = kernel.SOURCES[0].read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    src = build_dir() / "variants" / f"ppoly_eval_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    path = build(f"ppoly_eval_{name}", (src,), kernel.NVCC_FLAGS)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ppoly_eval_vec_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.ppoly_min_eval_vec_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.ppoly_first_crossing_row_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    use = ptxas_usage(path.with_suffix(".log").read_text())
    mine = {k.split("vec_kernel")[0].rsplit("ppoly_", 1)[-1] + "vec": v
            for k, v in use.items() if f"vec_kernelILi{P}ELi{K}E" in k}
    mine.update({"first_crossing_row": v for k, v in use.items()
                 if f"row_kernelILi{K}E" in k})
    return lib, mine


def empty_launcher(blocks: int, threads: int):
    """A function that launches an empty kernel of ``blocks`` x ``threads``
    on the current stream: what any kernel of that grid costs at least."""
    src = build_dir() / "variants" / "empty.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_EMPTY)
    lib = ctypes.CDLL(str(build("empty", (src,), kernel.NVCC_FLAGS)))
    lib.empty_launch.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]

    def fn():
        err = lib.empty_launch(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty_launch: cudaError {err}")

    return fn


def _inputs(dev):
    rng = np.random.default_rng(16)
    starts = np.sort(rng.uniform(0.0, 200.0, (B, F, P)), -1)
    starts[..., 0] = 0.0
    n_real = rng.integers(2, P + 1, (B, F))
    starts[np.arange(P)[None, None] >= n_real[..., None]] = 1e30
    coeffs = rng.uniform(-3.0, 3.0, (B, F, P, K))
    q = np.broadcast_to(np.linspace(0.0, 300.0, T), (B, T))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    return t(starts), t(coeffs), t(q)


def _levels(coeffs, T: int):
    """(B, T) seeded levels for the crossing, on the scale of the values."""
    rng = np.random.default_rng(17)
    y = rng.uniform(-0.1, 1.3, (B, T)) * float(coeffs[..., 0].abs().max())
    return torch.as_tensor(y, dtype=torch.float32, device=coeffs.device)


def _launchers(lib, starts, coeffs, q):
    out = torch.empty((B, T), device=q.device)
    vals = torch.empty((B, T), device=q.device)
    arg = torch.empty((B, T), dtype=torch.int32, device=q.device)
    s1, c1 = starts[:, 0].contiguous(), coeffs[:, 0].contiguous()
    y = _levels(c1, 1)
    cross = torch.empty((B, 1), device=q.device)

    def ev():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppoly_eval_vec_launch(s1.data_ptr(), c1.data_ptr(), q.data_ptr(),
                                        out.data_ptr(), B, P, K, T, stream)
        if err:
            raise RuntimeError(f"ppoly_eval_vec_launch: cudaError {err}")

    def mn():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppoly_min_eval_vec_launch(
            starts.data_ptr(), coeffs.data_ptr(), q.data_ptr(), vals.data_ptr(),
            arg.data_ptr(), B, F, P, K, T, stream)
        if err:
            raise RuntimeError(f"ppoly_min_eval_vec_launch: cudaError {err}")

    def cr():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppoly_first_crossing_row_launch(
            s1.data_ptr(), c1.data_ptr(), y.data_ptr(), cross.data_ptr(), B, P, K,
            1, stream)
        if err:
            raise RuntimeError(f"ppoly_first_crossing_row_launch: cudaError {err}")

    return ev, mn, cr, (out, vals, arg, cross)


def queued_ms(fn, flush=None, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` by CUDA events around each launch,
    with the card held busy first (``torch.cuda._sleep``) so that every
    launch is queued before the card reaches it and no host time enters
    the events.  With ``flush`` (a tensor of 128 MB), a write of it between
    launches, outside the events, leaves the 50 MB L2 cold; without it the
    launches run back to back."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters)]
    torch.cuda._sleep(50_000_000)            # tens of ms at the card's clock
    for a, b in evs:
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


def main() -> None:
    require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: _library(*kv), VARIANTS.items())))
    dev = torch.device("cuda")
    args = _inputs(dev)
    runs = {name: _launchers(lib, *args) for name, (lib, _u) in libs.items()}
    for name, (ev, mn, cr, outs) in runs.items():
        ev()
        mn()
        cr()
        torch.cuda.synchronize()
        for a, b in zip(outs, runs["source"][3]):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"variant {name} differs from the source")
    flush = torch.empty(32 * 2**20, device=dev)
    times: dict[str, dict[str, list[float]]] = {n: {} for n in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ev, mn, cr, _o = runs[name]
            for key, fn, fl in (("eval_ms", ev, None), ("eval_flushed_ms", ev, flush),
                                ("min_ms", mn, None), ("min_flushed_ms", mn, flush),
                                ("crossing_row_ms", cr, None),
                                ("crossing_row_flushed_ms", cr, flush)):
                times[name].setdefault(key, []).append(queued_ms(fn, fl))
    for name in runs:
        print(json.dumps({"variant": name, "changes": VARIANTS[name],
                          "ptxas": libs[name][1], **times[name]}), flush=True)
    crossing_routes(args[0][:, 0].contiguous(), args[1][:, 0].contiguous(), flush)


def crossing_routes(starts, coeffs, flush) -> None:
    """The crossing's routes at each T of :data:`CROSSING_T` on the same
    inputs, each held bit for bit against "tile", in turns; then the empty
    kernel on the row route's grid."""
    for T_ in CROSSING_T:
        y = _levels(coeffs, T_)
        outs = {rt: kernel.launch_crossing(rt, starts, coeffs, y)
                for rt in kernel.CROSSING_ROUTES}
        torch.cuda.synchronize()
        for rt, out in outs.items():
            if not torch.equal(out.view(torch.int32), outs["tile"].view(torch.int32)):
                raise AssertionError(f"crossing, T = {T_}: {rt} differs from tile")
        times: dict[str, list[float]] = {}
        for order in (kernel.CROSSING_ROUTES, kernel.CROSSING_ROUTES[::-1]):
            for rt in order:
                fn = lambda rt=rt: kernel.launch_crossing(rt, starts, coeffs, y)  # noqa: E731
                times.setdefault(f"{rt}_ms", []).append(queued_ms(fn))
                times.setdefault(f"{rt}_flushed_ms", []).append(queued_ms(fn, flush))
        print(json.dumps({"crossing_T": T_, "route": kernel.crossing_route(P, K, T_),
                          **times}), flush=True)
    blocks = -(-B // 8)                       # the row route: 8 rows of 128 threads
    empty = empty_launcher(blocks, 128)
    print(json.dumps({"empty_kernel": {"blocks": blocks, "threads": 128},
                      "ms": [queued_ms(empty) for _ in range(2)],
                      "flushed_ms": [queued_ms(empty, flush) for _ in range(2)]}),
          flush=True)


if __name__ == "__main__":
    main()
