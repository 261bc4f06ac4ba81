"""CUDA decode attention, bound with ctypes.

The source is ``repro_torch/csrc/decode_attention.cu`` (its header says why
it was added, what bounds it and how it is laid out; it replaces no TPU
kernel).  At first use :func:`library` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface under
``build/repro_torch/`` and loads it with :mod:`ctypes`; ``ptxas -v`` reports
each kernel's registers and spills into the build log beside the library.
Nothing is compiled or loaded when this module is imported.

The library holds two kernels, picked by dtype: bfloat16 runs the
tensor-core kernel (``mma.sync`` on ``cp.async``-staged tiles, P kept at
float32 precision as three bf16 terms), float32 the CUDA-core kernel.
Where the ``B * Hk`` blocks of a call do not fill the card's resident
slots once, :func:`plan_splits` cuts the valid positions into splits and a
second kernel merges them.

:func:`decode_attention_cuda` checks its inputs (:func:`check_inputs`),
allocates the output and a split call's scratch with ``torch.empty``,
launches on q's device and its current CUDA stream, raises if a launch
was refused, and adds one to ``launches["decode_attention"]`` a call and
one to ``launches["decode_attention_split"]`` a split call.  It takes CUDA
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

__all__ = ["MAX_GROUP", "MAX_HEAD_DIM", "NVCC_FLAGS", "SOURCES", "TILE", "build_dir",
           "check_inputs", "decode_attention_cuda", "launches", "library",
           "plan_splits", "reset_launches", "slots"]

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCES = (_PKG / "csrc" / "decode_attention.cu",)
#: no fast math: expf and IEEE division, as in the plain version;
#: ``-Xptxas -v`` writes registers and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 128
MAX_GROUP = 16
#: positions a tile of each kernel (the source's kTile and kF32Tile): a split
#: is a whole number of them
TILE = {torch.bfloat16: 64, torch.float32: 32}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535             # grid.y (kv heads) and grid.z (batch rows)

#: op calls, counted where the kernel is launched: every call, and the calls
#: cut into splits (two launches: the splits, then their merge)
launches: dict[str, int] = {"decode_attention": 0, "decode_attention_split": 0}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_slots: dict[tuple, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            require_card()
            lib = ctypes.CDLL(str(build("decode_attention", SOURCES, NVCC_FLAGS)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                                    i, i, ctypes.c_float, i, p]
            lib.decode_attention_launch.restype = ctypes.c_int
            lib.decode_attention_blocks_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
            lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int) -> None:
    """Raise ``ValueError`` on what the kernel does not take: q (B, Hk, G,
    Dh), k and v (B, Hk, S_ctx, Dh), contiguous, all bfloat16 or all
    float32, G in 1..16, Dh a multiple of 8 in 8..128, n_valid in
    1..S_ctx.  The device is not checked here."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"decode_attention: {name} must be a 4-D tensor")
        if x.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {x.dtype}, q is {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype}, expected float32 or "
                         "bfloat16")
    B, Hk, G, D = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, Hk, S, D) or tuple(v.shape) != (B, Hk, S, D):
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: {G} query heads a kv head, outside "
                         f"1..{MAX_GROUP}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {D} is not a multiple of 8 in "
                         f"8..{MAX_HEAD_DIM}")
    if not 1 <= n_valid <= S:
        raise ValueError(f"decode_attention: n_valid {n_valid} outside 1..{S}")
    if not 1 <= B <= _MAX_GRID or not 1 <= Hk <= _MAX_GRID:
        raise ValueError(f"decode_attention: B = {B} and Hk = {Hk} must lie in "
                         f"1..{_MAX_GRID}")


def plan_splits(blocks: int, n_valid: int, tile: int, slots: int) -> tuple[int, int]:
    """(splits, positions a split) for a call of ``blocks`` = B * Hk blocks
    over ``n_valid`` positions, on a card with ``slots`` resident blocks.
    One split where the blocks fill the slots once; otherwise as many as
    fill them once (``slots // blocks``), at most one a tile, each a whole
    number of tiles and none empty."""
    tiles = -(-n_valid // tile)
    splits = 1 if blocks >= slots else max(1, min(tiles, slots // blocks))
    per = -(-tiles // splits)
    return -(-tiles // per), per * tile


def slots(device: torch.device, head_dim: int, dtype: torch.dtype) -> int:
    """Resident blocks of the kernel for (head_dim, dtype) on the whole
    card: SMs x blocks an SM holds (asked of the runtime once)."""
    key = (device.index, head_dim, dtype)
    if key not in _slots:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = library().decode_attention_blocks_per_sm(head_dim, _DTYPES[dtype],
                                                           ctypes.byref(blocks))
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"decode_attention: occupancy query failed (cudaError "
                               f"{err}, {blocks.value} blocks an SM)")
        _slots[key] = sms * blocks.value
    return _slots[key]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_valid: int) -> torch.Tensor:
    """q (B, Hk, G, Dh), k and v (B, Hk, S_ctx, Dh) on one CUDA device,
    slots 0 .. n_valid - 1 valid -> (B, Hk, G, Dh) in q's dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} must be a CUDA tensor")
        if x.device != q.device:
            raise ValueError(f"decode_attention: {name} on {x.device}, q on {q.device}")
    check_inputs(q, k, v, n_valid)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be 16-byte aligned")
    B, Hk, G, D = q.shape
    lib = library()
    splits, split_len = plan_splits(B * Hk, n_valid, TILE[q.dtype],
                                    slots(q.device, D, q.dtype))
    out = torch.empty_like(q)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((B, Hk, splits, G, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, Hk, splits, G, 2), dtype=torch.float32, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):        # the launch goes to the current device
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            B, Hk, G, D, k.shape[2], n_valid, splits, split_len, math.sqrt(D),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (cudaError {err})")
    launches["decode_attention"] += 1
    if splits > 1:
        launches["decode_attention_split"] += 1
    return out
