"""CUDA kernels for the batched piecewise-polynomial queries, bound with ctypes.

The sources live in ``repro_torch/csrc/ppoly_eval.cu`` (see the note at its
top for what each kernel replaces and how it is laid out).  At first use
:func:`library` compiles them with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, under ``build/repro_torch/`` at the
root of the checkout, keyed by a hash of the sources and flags, and loads it
with :mod:`ctypes`.  Nothing is compiled or loaded when this module is
imported.

Each wrapper checks device, dtype (float32), shape and contiguity, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch was refused, and adds one to :data:`launches` under its name.
The wrappers take CUDA tensors only; the public ops in :mod:`.ops` route CPU
tensors to the plain versions in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import build, build_dir, require_card

__all__ = ["NVCC_FLAGS", "SOURCES", "build_dir", "launches", "library",
           "ppoly_eval_cuda", "ppoly_first_crossing_cuda",
           "ppoly_min_eval_cuda", "reset_launches"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "ppoly_eval.cu",)
#: no fast math: the crossing kernel's thresholds depend on IEEE division
#: and sqrt; -fmad=false keeps each multiply and add rounded on its own, as
#: in the plain PyTorch version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

#: kernel launches per kernel, counted where each kernel is launched
launches: dict[str, int] = {"ppoly_eval": 0, "ppoly_min_eval": 0,
                            "ppoly_first_crossing": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_MAX_T = 65535 * 128          # grid.y limit times the queries per block


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            require_card()
            lib = ctypes.CDLL(str(build("ppoly_eval", SOURCES, NVCC_FLAGS)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ppoly_eval_launch.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.ppoly_min_eval_launch.argtypes = [p, p, p, p, p,
                                                  i, i, i, i, i, p]
            lib.ppoly_first_crossing_launch.argtypes = [p, p, p, p,
                                                        i, i, i, i, p]
            for fn in (lib.ppoly_eval_launch, lib.ppoly_min_eval_launch,
                       lib.ppoly_first_crossing_launch):
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


def ppoly_eval_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """starts (B, P) · coeffs (B, P, K) · q (B, T) -> (B, T) float32."""
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
    if P < 1 or K < 1 or T > _MAX_T:
        raise ValueError(f"ppoly_eval: unsupported P={P}, K={K}, T={T}")
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B and T:
        lib = library()
        _raise_on(lib.ppoly_eval_launch(
            starts.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
            out.data_ptr(), B, P, K, T, _stream(dev)), "ppoly_eval")
        launches["ppoly_eval"] += 1
    return out


def ppoly_min_eval_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                        q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """starts (B, F, P) · coeffs (B, F, P, K) · q (B, T) ->
    (vals (B, T) float32, argmin (B, T) int32)."""
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
    if F < 1 or P < 1 or K < 1 or T > _MAX_T:
        raise ValueError(
            f"ppoly_min_eval: unsupported F={F}, P={P}, K={K}, T={T}")
    vals = torch.empty((B, T), dtype=torch.float32, device=dev)
    arg = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B and T:
        lib = library()
        _raise_on(lib.ppoly_min_eval_launch(
            starts.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
            vals.data_ptr(), arg.data_ptr(), B, F, P, K, T, _stream(dev)),
            "ppoly_min_eval")
        launches["ppoly_min_eval"] += 1
    return vals, arg


def ppoly_first_crossing_cuda(starts: torch.Tensor, coeffs: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """starts (B, P) · coeffs (B, P, K <= 3) · y (B, T) -> (B, T) float32."""
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
    if P < 1 or not 1 <= K <= 3 or T > _MAX_T:
        raise ValueError(
            f"ppoly_first_crossing: unsupported P={P}, K={K}, T={T}")
    out = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B and T:
        lib = library()
        _raise_on(lib.ppoly_first_crossing_launch(
            starts.data_ptr(), coeffs.data_ptr(), y.data_ptr(),
            out.data_ptr(), B, P, K, T, _stream(dev)), "ppoly_first_crossing")
        launches["ppoly_first_crossing"] += 1
    return out
