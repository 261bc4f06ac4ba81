"""CUDA RWKV-6 wkv forward, bound with ctypes.

The source is ``repro_torch/csrc/wkv6.cu`` (its header says which TPU kernel
it replaces, what bounds it and how it is laid out).  At first use
:func:`library` compiles it with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface under ``build/repro_torch/`` and
loads it with :mod:`ctypes`.  Nothing is compiled or loaded when this module
is imported.

:func:`wkv6_cuda` checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch was refused, and adds one to ``launches["wkv6"]``.  It takes CUDA
tensors only; the public op in :mod:`.ops` routes CPU tensors to the plain
version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import build, build_dir, require_card

__all__ = ["CHUNKS", "MAX_HEAD_DIM", "NVCC_FLAGS", "SOURCES", "build_dir",
           "launches", "library", "reset_launches", "wkv6_cuda"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "wkv6.cu",)
#: no fast math: logf, expf and IEEE division, as in the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 64
CHUNKS = (16, 32, 64)

#: kernel launches, counted where the kernel is launched
launches: dict[str, int] = {"wkv6": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            require_card()
            lib = ctypes.CDLL(str(build("wkv6", SOURCES, NVCC_FLAGS)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.wkv6_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor, *,
              chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, L, H, N), u (H, N), s0 (B, H, N, N), float32 ->
    (y (B, L, H, N), s_final (B, H, N, N)), float32."""
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"wkv6: {name} must be a CUDA tensor")
        if x.device != r.device:
            raise ValueError(f"wkv6: {name} on {x.device}, r on {r.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"wkv6: {name} is {x.dtype}, expected float32")
        if not x.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous")
    check_shapes(r, k, v, w, u, s0, chunk)
    B, L, H, N = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    lib = library()
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), B, L, H, N, chunk,
        ctypes.c_void_p(torch.cuda.current_stream(r.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (cudaError {err})")
    launches["wkv6"] += 1
    return y, s_final


def check_shapes(r, k, v, w, u, s0, chunk: int) -> None:
    """What the kernel takes: N <= 64, chunk in {16, 32, 64}, B, L, H >= 1."""
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, L, H, N), got {tuple(r.shape)}")
    B, L, H, N = r.shape
    for name, x, want in (("k", k, (B, L, H, N)), ("v", v, (B, L, H, N)),
                          ("w", w, (B, L, H, N)), ("u", u, (H, N)),
                          ("s0", s0, (B, H, N, N))):
        if tuple(x.shape) != want:
            raise ValueError(f"wkv6: {name} is {tuple(x.shape)}, expected {want}")
    if min(B, L, H, N) < 1:
        raise ValueError(f"wkv6: empty input (B, L, H, N) = {(B, L, H, N)}")
    if N > MAX_HEAD_DIM:
        raise ValueError(f"wkv6: head size {N} above {MAX_HEAD_DIM}")
    if chunk not in CHUNKS:
        raise ValueError(f"wkv6: chunk {chunk}, expected one of {CHUNKS}")
    if B * H > 2**31 - 1:
        raise ValueError(f"wkv6: B * H = {B * H} too large")
