"""CUDA flash-attention forward, bound with ctypes.

The source is ``repro_torch/csrc/flash_attention.cu`` (its header says
which TPU kernel it replaces, what bounds it and how it is laid out).  At
first use :func:`library` compiles it with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface under
``build/repro_torch/`` and loads it with :mod:`ctypes`.  Nothing is compiled
or loaded when this module is imported.

The library holds two kernels, and :func:`route` picks one by dtype and
head size: bfloat16 with ``D % 8 == 0`` runs the tensor-core kernel
(``wgmma`` on TMA-staged tiles, bf16 probabilities in the P.V product);
float32, and bfloat16 with ``D % 8 != 0`` (no valid TMA row stride), run
the float32 kernel.

:func:`flash_attention_cuda` checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on the current CUDA
stream, raises if the launch was refused, and adds one to
``launches["flash_attention"]`` for every launch and to
``launches["flash_attention_tc"]`` for a tensor-core launch.  It takes CUDA
tensors only; the public op in :mod:`.ops` routes CPU tensors to the plain
version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch

from ..build import build, build_dir, require_card

__all__ = ["MAX_HEAD_DIM", "NVCC_FLAGS", "SOURCES", "build_dir",
           "flash_attention_cuda", "launches", "library", "reset_launches",
           "route"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "flash_attention.cu",)
#: no fast math: expf and IEEE division, as in the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q_TILES = 65535          # grid.y limit; 64 query rows per tile

#: kernel launches, counted where the kernel is launched: every launch, and
#: those of the tensor-core kernel
launches: dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call takes: ``"tc"`` (the bf16 tensor-core kernel) for
    bfloat16 with ``head_dim % 8 == 0``, whose rows TMA can stage (16-byte
    strides); ``"f32"`` (the float32 kernel) otherwise."""
    return "tc" if dtype == torch.bfloat16 and head_dim % 8 == 0 else "f32"


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            require_card()
            lib = ctypes.CDLL(str(build("flash_attention", SOURCES, NVCC_FLAGS)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                   i, i, ctypes.c_float, i, p]
            lib.flash_attention_launch.restype = ctypes.c_int
            lib.flash_attention_tc_launch.argtypes = [p, p, p, p, i, i, i, i,
                                                      i, i, i, ctypes.c_float, p]
            lib.flash_attention_tc_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype}, q is "
                             f"{q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}, expected float32 "
                         "or bfloat16")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of Hkv={Hkv}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if -(-S // 64) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention: sequence length {S} too long")
    tc = route(q.dtype, D) == "tc"
    if tc and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core kernel needs q, k "
                         "and v 16-byte aligned")
    out = torch.empty_like(q)
    if B and H and S:
        lib = library()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, S, D, int(causal), int(window or 0),
                1.0 / math.sqrt(D))
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        if tc:
            err = lib.flash_attention_tc_launch(*args, stream)
        else:
            err = lib.flash_attention_launch(*args, _DTYPES[q.dtype], stream)
        if err != 0:
            what = ("a tensor map was refused" if err == -1
                    else f"cudaError {err}")
            raise RuntimeError(f"flash_attention kernel launch failed ({what})")
        launches["flash_attention"] += 1
        if tc:
            launches["flash_attention_tc"] += 1
    return out
