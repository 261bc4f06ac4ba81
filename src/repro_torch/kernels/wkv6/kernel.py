"""CUDA RWKV-6 wkv forward, bound with ctypes.

The source is ``repro_torch/csrc/wkv6.cu`` (its header says which TPU kernel
it replaces, what bounds it and how it is laid out).  At first use
:func:`library` compiles it with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface under ``build/repro_torch/`` and
loads it with :mod:`ctypes`; ``ptxas -v`` reports each kernel's registers and
spills into the build log beside the library.  Nothing is compiled or loaded
when this module is imported.

The library holds two routes, and :func:`route` picks one by shape: a call
with ``L > chunk`` (a prefill) takes the chunked route, two kernels (phase 1,
state-independent and parallel over (b, h, chunk), then phase 2, the state
scan) with a scratch buffer of :func:`scratch_floats` floats; a call with
``L <= chunk`` (a decode step) takes the serial route, one kernel that walks
the chunks in order.

:func:`wkv6_cuda` launches the route :func:`route` names and adds one to
``launches["wkv6"]`` and one to ``launches["wkv6_chunked"]`` or
``launches["wkv6_serial"]`` per call, whatever number of kernels the route
launches.  :func:`launch_chunked` and :func:`launch_serial` run one route on
any shape and count nothing, so that a check can hold each route against the
plain version; :func:`launch_intra` and :func:`launch_scan` run one phase of
the chunked route each, so that a check can time them apart.  Each checks
device, dtype, shape and contiguity, allocates its outputs and the scratch
with ``torch.empty``, launches on the current CUDA stream and raises if a
launch was refused.  All take CUDA tensors only; the public op in
:mod:`.ops` routes CPU tensors to the plain version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..build import build, build_dir, require_card

__all__ = ["CHUNKS", "MAX_HEAD_DIM", "NVCC_FLAGS", "ROUTES", "SOURCES",
           "build_dir", "check_inputs", "launch_chunked", "launch_intra",
           "launch_scan", "launch_serial", "launches", "library",
           "reset_launches", "route", "scratch_floats", "wkv6_cuda"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "wkv6.cu",)
#: no fast math: logf, expf and IEEE division, as in the plain version;
#: ``-Xptxas -v`` writes registers and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 64
CHUNKS = (16, 32, 64)
ROUTES = ("chunked", "serial")

#: op calls, counted where their kernels are launched: every call, and the
#: calls of each route
launches: dict[str, int] = {"wkv6": 0, "wkv6_chunked": 0, "wkv6_serial": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def route(L: int, chunk: int) -> str:
    """The route a call takes: ``"chunked"`` when ``L > chunk`` (more than
    one chunk: the prefill), ``"serial"`` otherwise (a decode step)."""
    return "chunked" if L > chunk else "serial"


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
            lib.wkv6_intra_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.wkv6_intra_launch.restype = ctypes.c_int
            lib.wkv6_scan_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.wkv6_scan_launch.restype = ctypes.c_int
            lib.wkv6_scratch_floats.argtypes = [i, i, i, i, i]
            lib.wkv6_scratch_floats.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor, *,
              chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, L, H, N), u (H, N), s0 (B, H, N, N), float32 ->
    (y (B, L, H, N), s_final (B, H, N, N)), float32, by the route
    :func:`route` names."""
    check_inputs(r, k, v, w, u, s0, chunk)
    rt = route(r.shape[1], chunk)
    out = (_chunked if rt == "chunked" else _serial)(r, k, v, w, u, s0, chunk)
    launches["wkv6"] += 1
    launches[f"wkv6_{rt}"] += 1
    return out


def launch_serial(r, k, v, w, u, s0, *, chunk: int = 32):
    """The serial route on any shape, as :func:`wkv6_cuda`; counts nothing."""
    check_inputs(r, k, v, w, u, s0, chunk)
    return _serial(r, k, v, w, u, s0, chunk)


def launch_chunked(r, k, v, w, u, s0, *, chunk: int = 32):
    """The chunked route on any shape, as :func:`wkv6_cuda`; counts nothing."""
    check_inputs(r, k, v, w, u, s0, chunk)
    return _chunked(r, k, v, w, u, s0, chunk)


def launch_intra(r, k, v, w, u, s0, *, chunk: int = 32):
    """Phase 1 of the chunked route alone: (y holding y_intra, the scratch
    holding r_dec, dS and exp(total)); counts nothing."""
    check_inputs(r, k, v, w, u, s0, chunk)
    return _intra(r, k, v, w, u, chunk)


def launch_scan(s0: torch.Tensor, y: torch.Tensor, scratch: torch.Tensor, *,
                chunk: int = 32) -> torch.Tensor:
    """Phase 2 of the chunked route alone, on phase 1's ``y`` and
    ``scratch``: adds y_inter into ``y`` and returns s_final; counts
    nothing."""
    B, L, H, N = y.shape
    for name, x, want in (("y", y, (B, L, H, N)), ("s0", s0, (B, H, N, N)),
                          ("scratch", scratch, None)):
        if (x.device.type != "cuda" or x.device != y.device or x.dtype != torch.float32
                or not x.is_contiguous() or want not in (None, tuple(x.shape))):
            raise ValueError(f"wkv6: {name} must be a CUDA tensor, contiguous float32 "
                             f"on y's device" + (f", shaped {want}" if want else ""))
    n = scratch_floats(B, L, H, N, chunk)
    if scratch.numel() != n:
        raise ValueError(f"wkv6: scratch holds {scratch.numel()} floats, expected {n}")
    return _scan(s0, y, scratch, chunk)


def _serial(r, k, v, w, u, s0, chunk: int):
    B, L, H, N = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    _check(library().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), B, L, H, N, chunk,
        _stream(r)), "serial")
    return y, s_final


def _chunked(r, k, v, w, u, s0, chunk: int):
    y, scratch = _intra(r, k, v, w, u, chunk)
    return y, _scan(s0, y, scratch, chunk)


def _intra(r, k, v, w, u, chunk: int):
    B, L, H, N = r.shape
    y = torch.empty_like(r)
    scratch = torch.empty(scratch_floats(B, L, H, N, chunk), dtype=torch.float32,
                          device=r.device)
    _check(library().wkv6_intra_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), B, L, H, N, chunk, _stream(r)), "intra")
    return y, scratch


def _scan(s0, y, scratch, chunk: int):
    B, L, H, N = y.shape
    s_final = torch.empty_like(s0)
    _check(library().wkv6_scan_launch(
        s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), scratch.data_ptr(),
        B, L, H, N, chunk, _stream(y)), "scan")
    return s_final


def scratch_floats(B: int, L: int, H: int, N: int, chunk: int) -> int:
    """Floats of scratch the chunked route needs (r_dec, dS and exp(total)
    per chunk, the head size padded to 16), as the library computes it."""
    n = library().wkv6_scratch_floats(B, L, H, N, chunk)
    if n < 0:
        raise ValueError(f"wkv6: no scratch size for (B, L, H, N) = {(B, L, H, N)}, "
                         f"chunk {chunk}")
    return n


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"wkv6 {what} kernel launch failed (cudaError {err})")


def check_inputs(r, k, v, w, u, s0, chunk: int) -> None:
    """Contiguous float32 CUDA tensors on one device, of the shapes
    :func:`check_shapes` takes."""
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
