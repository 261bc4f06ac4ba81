"""CUDA kernels for the batched piecewise-polynomial queries, bound with ctypes.

The sources live in ``repro_torch/csrc/ppoly_eval.cu`` (see the note at its
top for what each kernel replaces and how it is laid out).  At first use
:func:`library` compiles them with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, under ``build/repro_torch/`` at the
root of the checkout, keyed by a hash of the sources and flags, and loads it
with :mod:`ctypes`; ``ptxas -v`` reports each kernel's registers and spills
into the build log beside the library.  Nothing is compiled or loaded when
this module is imported.

Evaluation and the minimum each have two routes, and :func:`route` picks one
by shape alone: ``"vec"`` (P <= 16, K <= 3, F <= 4: every call of the
analysis path), one warp per row and span of 256 queries with 16-byte loads
and stores; ``"tile"`` (the rest), the first design, one thread per query.
The first crossing has two, and :func:`crossing_route` picks one by
(P, K, T): ``"row"`` for P <= 16, K <= 3 and T <= :data:`ROW_MAX_T` levels a
row (the analysis path's T = 1), one thread per (row, piece) and a shuffle
reduction over the row's 16 lanes; ``"tile"`` for the rest, where it
measured faster than the row route from T = 32 (``python -m
repro_torch.kernels.ppoly_eval.variants``).  All routes of a kernel give the
same bits.
:func:`ppoly_eval_cuda`, :func:`ppoly_min_eval_cuda` and
:func:`ppoly_first_crossing_cuda` launch the route that :func:`route` or
:func:`crossing_route` names and add one to ``launches[name]`` and one to
``launches[f"{name}_{route}"]`` per call; :func:`launch_eval`,
:func:`launch_min_eval` and :func:`launch_crossing` run a route named by the
caller and count nothing, so that a check can hold each route against the
plain version and against the other.

Each wrapper checks device, dtype (float32), shape and contiguity, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream and
raises if the launch was refused.  The wrappers take CUDA tensors only; the
public ops in :mod:`.ops` route CPU tensors to the plain versions in
:mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import build, build_dir, require_card

__all__ = ["CROSSING_ROUTES", "NVCC_FLAGS", "ROUTES", "ROW_MAX_T", "SOURCES",
           "VEC_MAX_F", "VEC_MAX_K", "VEC_MAX_P", "build_dir", "crossing_route",
           "launch_crossing", "launch_eval", "launch_min_eval", "launches",
           "library", "ppoly_eval_cuda", "ppoly_first_crossing_cuda",
           "ppoly_min_eval_cuda", "reset_launches", "route"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "ppoly_eval.cu",)
#: no fast math: the crossing kernel's thresholds depend on IEEE division
#: and sqrt; -fmad=false keeps each multiply and add rounded on its own, as
#: in the plain PyTorch version; ``-Xptxas -v`` writes registers and spills
#: into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
ROUTES = ("vec", "tile")
CROSSING_ROUTES = ("row", "tile")
#: the shapes the "vec" kernels are instantiated for (and the "row" kernel
#: takes: one lane per piece, 16 lanes a row)
VEC_MAX_P, VEC_MAX_K, VEC_MAX_F = 16, 3, 4
#: the first crossing's "row" route takes T <= ROW_MAX_T levels a row, one
#: level a lane in a single pass; .variants on an H100 has it faster than
#: "tile" through T = 24 and slower from T = 32
ROW_MAX_T = 16

#: kernel launches, counted where each kernel is launched: per kernel and
#: per route
launches: dict[str, int] = {
    "ppoly_eval": 0, "ppoly_eval_vec": 0, "ppoly_eval_tile": 0,
    "ppoly_min_eval": 0, "ppoly_min_eval_vec": 0, "ppoly_min_eval_tile": 0,
    "ppoly_first_crossing": 0, "ppoly_first_crossing_row": 0,
    "ppoly_first_crossing_tile": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_MAX_T = 65535 * 128          # "tile": grid.y limit times the queries per block


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def route(P: int, K: int, F: int = 1) -> str:
    """The route of an evaluation or minimum with P pieces of K coefficients
    (F functions for the minimum): ``"vec"`` when P <= 16, K <= 3 and
    F <= 4, else ``"tile"``."""
    fits = P <= VEC_MAX_P and K <= VEC_MAX_K and F <= VEC_MAX_F
    return "vec" if fits else "tile"


def crossing_route(P: int, K: int, T: int) -> str:
    """The route of a first crossing with P pieces of K coefficients and T
    levels a row: ``"row"`` when P <= 16, K <= 3 and T <= :data:`ROW_MAX_T`,
    else ``"tile"``."""
    fits = P <= VEC_MAX_P and K <= VEC_MAX_K and T <= ROW_MAX_T
    return "row" if fits else "tile"


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            require_card()
            lib = ctypes.CDLL(str(build("ppoly_eval", SOURCES, NVCC_FLAGS)))
            p, i = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.ppoly_eval_launch, lib.ppoly_eval_vec_launch):
                fn.argtypes = [p, p, p, p, i, i, i, i, p]
            for fn in (lib.ppoly_min_eval_launch, lib.ppoly_min_eval_vec_launch):
                fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            crossing = (lib.ppoly_first_crossing_row_launch,
                        lib.ppoly_first_crossing_launch)
            for fn in crossing:
                fn.argtypes = [p, p, p, p, i, i, i, i, p]
            for fn in (lib.ppoly_eval_launch, lib.ppoly_eval_vec_launch,
                       lib.ppoly_min_eval_launch, lib.ppoly_min_eval_vec_launch,
                       *crossing):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {x.dtype}, expected torch.float32")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _empty_out(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An empty (B, T) tensor of ``dtype`` (4-byte elements) whose address
    has q's remainder modulo 16 bytes, as the "vec" kernels ask."""
    B, T = q.shape
    if q.data_ptr() % 16 == 0:
        return torch.empty((B, T), dtype=dtype, device=q.device)
    flat = torch.empty(B * T + 3, dtype=dtype, device=q.device)
    shift = (q.data_ptr() - flat.data_ptr()) % 16 // 4
    return flat[shift:shift + B * T].view(B, T)


def _eval_args(starts, coeffs, q) -> tuple[int, int, int, int]:
    if starts.dim() != 2 or coeffs.dim() != 3 or q.dim() != 2:
        raise ValueError("ppoly_eval: expected starts (B,P), coeffs (B,P,K), "
                         "q (B,T)")
    B, P = starts.shape
    K = coeffs.shape[-1]
    T = q.shape[-1]
    dev = starts.device
    _check("starts", starts, (B, P), dev)
    _check("coeffs", coeffs, (B, P, K), dev)
    _check("q", q, (B, T), dev)
    if P < 1 or K < 1:
        raise ValueError(f"ppoly_eval: unsupported P={P}, K={K}")
    return B, P, K, T


def _min_args(starts, coeffs, q) -> tuple[int, int, int, int, int]:
    if starts.dim() != 3 or coeffs.dim() != 4 or q.dim() != 2:
        raise ValueError("ppoly_min_eval: expected starts (B,F,P), coeffs "
                         "(B,F,P,K), q (B,T)")
    B, F, P = starts.shape
    K = coeffs.shape[-1]
    T = q.shape[-1]
    dev = starts.device
    _check("starts", starts, (B, F, P), dev)
    _check("coeffs", coeffs, (B, F, P, K), dev)
    _check("q", q, (B, T), dev)
    if F < 1 or P < 1 or K < 1:
        raise ValueError(f"ppoly_min_eval: unsupported F={F}, P={P}, K={K}")
    return B, F, P, K, T


def _admit(name: str, rt: str, P: int, K: int, F: int, T: int) -> None:
    routes = CROSSING_ROUTES if name == "ppoly_first_crossing" else ROUTES
    if rt not in routes:
        raise ValueError(f"{name}: route {rt!r}, expected one of {routes}")
    if rt != "tile" and route(P, K, F) == "tile":
        raise ValueError(f"{name}: the {rt} route takes P <= {VEC_MAX_P}, "
                         f"K <= {VEC_MAX_K}, F <= {VEC_MAX_F}; got P={P}, "
                         f"K={K}, F={F}")
    if rt == "tile" and T > _MAX_T:
        raise ValueError(f"{name}: the tile route takes T <= {_MAX_T}, got {T}")


def _eval(rt: str, starts, coeffs, q, B: int, P: int, K: int,
          T: int) -> torch.Tensor:
    out = _empty_out(q, torch.float32)
    if B and T:
        lib = library()
        fn = lib.ppoly_eval_vec_launch if rt == "vec" else lib.ppoly_eval_launch
        _raise_on(fn(starts.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
                     out.data_ptr(), B, P, K, T, _stream(q.device)),
                  f"ppoly_eval ({rt})")
    return out


def _min_eval(rt: str, starts, coeffs, q, B: int, F: int, P: int, K: int,
              T: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals = _empty_out(q, torch.float32)
    arg = _empty_out(q, torch.int32)
    if B and T:
        lib = library()
        fn = lib.ppoly_min_eval_vec_launch if rt == "vec" else lib.ppoly_min_eval_launch
        _raise_on(fn(starts.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
                     vals.data_ptr(), arg.data_ptr(), B, F, P, K, T,
                     _stream(q.device)), f"ppoly_min_eval ({rt})")
    return vals, arg


def ppoly_eval_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """starts (B, P) · coeffs (B, P, K) · q (B, T) -> (B, T) float32, by the
    route :func:`route` names."""
    B, P, K, T = _eval_args(starts, coeffs, q)
    rt = route(P, K)
    _admit("ppoly_eval", rt, P, K, 1, T)
    out = _eval(rt, starts, coeffs, q, B, P, K, T)
    if B and T:
        launches["ppoly_eval"] += 1
        launches[f"ppoly_eval_{rt}"] += 1
    return out


def launch_eval(rt: str, starts: torch.Tensor, coeffs: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """:func:`ppoly_eval_cuda` on the route ``rt``; counts nothing."""
    B, P, K, T = _eval_args(starts, coeffs, q)
    _admit("ppoly_eval", rt, P, K, 1, T)
    return _eval(rt, starts, coeffs, q, B, P, K, T)


def ppoly_min_eval_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                        q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """starts (B, F, P) · coeffs (B, F, P, K) · q (B, T) ->
    (vals (B, T) float32, argmin (B, T) int32), by the route :func:`route`
    names."""
    B, F, P, K, T = _min_args(starts, coeffs, q)
    rt = route(P, K, F)
    _admit("ppoly_min_eval", rt, P, K, F, T)
    out = _min_eval(rt, starts, coeffs, q, B, F, P, K, T)
    if B and T:
        launches["ppoly_min_eval"] += 1
        launches[f"ppoly_min_eval_{rt}"] += 1
    return out


def launch_min_eval(rt: str, starts: torch.Tensor, coeffs: torch.Tensor,
                    q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ppoly_min_eval_cuda` on the route ``rt``; counts nothing."""
    B, F, P, K, T = _min_args(starts, coeffs, q)
    _admit("ppoly_min_eval", rt, P, K, F, T)
    return _min_eval(rt, starts, coeffs, q, B, F, P, K, T)


def _crossing_args(starts, coeffs, y) -> tuple[int, int, int, int]:
    if starts.dim() != 2 or coeffs.dim() != 3 or y.dim() != 2:
        raise ValueError("ppoly_first_crossing: expected starts (B,P), "
                         "coeffs (B,P,K), y (B,T)")
    B, P = starts.shape
    K = coeffs.shape[-1]
    T = y.shape[-1]
    dev = starts.device
    _check("starts", starts, (B, P), dev)
    _check("coeffs", coeffs, (B, P, K), dev)
    _check("y", y, (B, T), dev)
    if P < 1 or not 1 <= K <= 3:
        raise ValueError(f"ppoly_first_crossing: unsupported P={P}, K={K}")
    return B, P, K, T


def _crossing(rt: str, starts, coeffs, y, B: int, P: int, K: int,
              T: int) -> torch.Tensor:
    out = torch.empty((B, T), dtype=torch.float32, device=y.device)
    if B and T:
        lib = library()
        fn = (lib.ppoly_first_crossing_row_launch if rt == "row"
              else lib.ppoly_first_crossing_launch)
        _raise_on(fn(starts.data_ptr(), coeffs.data_ptr(), y.data_ptr(),
                     out.data_ptr(), B, P, K, T, _stream(y.device)),
                  f"ppoly_first_crossing ({rt})")
    return out


def ppoly_first_crossing_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """starts (B, P) · coeffs (B, P, K <= 3) · y (B, T) -> (B, T) float32, by
    the route :func:`crossing_route` names."""
    B, P, K, T = _crossing_args(starts, coeffs, y)
    rt = crossing_route(P, K, T)
    _admit("ppoly_first_crossing", rt, P, K, 1, T)
    out = _crossing(rt, starts, coeffs, y, B, P, K, T)
    if B and T:
        launches["ppoly_first_crossing"] += 1
        launches[f"ppoly_first_crossing_{rt}"] += 1
    return out


def launch_crossing(rt: str, starts: torch.Tensor, coeffs: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """:func:`ppoly_first_crossing_cuda` on the route ``rt``; counts
    nothing."""
    B, P, K, T = _crossing_args(starts, coeffs, y)
    _admit("ppoly_first_crossing", rt, P, K, 1, T)
    return _crossing(rt, starts, coeffs, y, B, P, K, T)
