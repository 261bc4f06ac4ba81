"""Public ops: batched piecewise-polynomial queries.

* :func:`ppoly_eval` — evaluate B functions at T points each.
* :func:`ppoly_min_eval` — ``min_f`` over F stacked functions with argmin
  (the batched form of ``PPoly.minimum`` — bottleneck attribution).
* :func:`ppoly_first_crossing` — first ``t`` with ``f(t) >= y`` for monotone
  piecewise functions of degree <= 2 (batched finish-time extraction).
* :func:`pack_ppolys_np` / :func:`pack_bpl_np` / :func:`pack_ppoly_grid` —
  pad ``repro_torch.core.ppoly.PPoly`` objects into dense numpy arrays;
  :func:`pack_ppolys` puts the first as float32 tensors on a device.

The device of the inputs decides the route: CUDA tensors go to the CUDA
kernels (:mod:`.kernel`), CPU tensors to the plain versions (:mod:`.ref`).
Inputs are cast to float32 on their device; array-likes that are not
tensors become CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from . import kernel
from .ref import PAD_START, ppoly_eval_ref, ppoly_first_crossing_ref, ppoly_min_eval_ref


def _inputs(*xs) -> tuple[torch.Tensor, ...]:
    """float32, contiguous, each on the device it already lives on."""
    return tuple(torch.as_tensor(x).to(torch.float32).contiguous() for x in xs)


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on different devices ({t.device} vs {dev})")
    return dev


def ppoly_eval(starts, coeffs, q) -> torch.Tensor:
    """Evaluate B piecewise polynomials at T points each: (B, T) float32.

    ``starts (B, P)``, ``coeffs (B, P, K)``, ``q (B, T)``; agrees with
    ``repro_torch.core.ppoly.PPoly.__call__`` up to float32.
    """
    starts, coeffs, q = _inputs(starts, coeffs, q)
    if _same_device(starts, coeffs, q).type == "cuda":
        return kernel.ppoly_eval_cuda(starts, coeffs, q)
    return ppoly_eval_ref(starts, coeffs, q)


def ppoly_min_eval(starts, coeffs, q) -> tuple[torch.Tensor, torch.Tensor]:
    """``min_f f(t)`` with argmin over F stacked functions per batch row.

    Args:
      starts: (B, F, P); a slot whose first start is ``PAD_START`` is absent
        (can never attain the minimum).
      coeffs: (B, F, P, K).
      q:      (B, T) query positions.

    Returns:
      ``(vals (B,T) float32, argmin (B,T) int32)``.  This is the batched form
      of ``PPoly.minimum`` — eq. (2)'s section-wise limiting function with
      bottleneck attribution — over every scenario of a sweep at once.
    """
    starts, coeffs, q = _inputs(starts, coeffs, q)
    if _same_device(starts, coeffs, q).type == "cuda":
        return kernel.ppoly_min_eval_cuda(starts, coeffs, q)
    return ppoly_min_eval_ref(starts, coeffs, q)


def ppoly_first_crossing(starts, coeffs, y) -> torch.Tensor:
    """First ``t`` with ``f(t) >= y`` for monotone batches of degree <= 2.

    ``starts (B,P)``, ``coeffs (B,P,K<=3)``, ``y (B,T)`` → (B,T) float32 (a
    value ``>= 1e30`` means the level is never reached).  Quadratic pieces
    (the progress class under ramped resource allocations) are solved by the
    quadratic formula's numerically-stable branch; with ``y = p_end`` this
    extracts finish times from a whole sweep's progress functions at once.
    """
    starts, coeffs, y = _inputs(starts, coeffs, y)
    if coeffs.shape[-1] > 3:
        raise ValueError("ppoly_first_crossing requires input of degree <= 2")
    if _same_device(starts, coeffs, y).type == "cuda":
        return kernel.ppoly_first_crossing_cuda(starts, coeffs, y)
    return ppoly_first_crossing_ref(starts, coeffs, y)


def pack_ppolys_np(ppolys, max_pieces: int | None = None, max_coef: int | None = None,
                   dtype=np.float32):
    """Pack ``PPoly`` objects into padded numpy ``(B, P)`` / ``(B, P, K)``.

    The float64 variant is the exact packing used by the sweep engines; the
    float32 variant feeds the query kernels.
    """
    P = max_pieces or max(f.n_pieces for f in ppolys)
    K = max_coef or max(f.coeffs.shape[1] for f in ppolys)
    B = len(ppolys)
    starts = np.full((B, P), PAD_START, dtype)
    coeffs = np.zeros((B, P, K), dtype)
    for i, f in enumerate(ppolys):
        n = min(f.n_pieces, P)
        k = min(f.coeffs.shape[1], K)
        starts[i, :n] = f.starts[:n]
        coeffs[i, :n, :k] = f.coeffs[:n, :k]
    return starts, coeffs


def pack_ppolys(ppolys, max_pieces: int | None = None, max_coef: int | None = None,
                *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a list of ``repro_torch.core.ppoly.PPoly`` into padded float32
    ``(B, P)`` / ``(B, P, K)`` tensors on ``device`` (default: the CUDA
    card), ready for :func:`ppoly_eval`."""
    dev = resolve_device(device)
    starts, coeffs = pack_ppolys_np(ppolys, max_pieces, max_coef, np.float32)
    return (torch.as_tensor(starts, device=dev),
            torch.as_tensor(coeffs, device=dev))


def pack_bpl_np(starts, c0, c1, c2=None, dtype=np.float32):
    """BPL-layout arrays ``(starts, c0, c1[, c2])`` -> kernel ``(starts, coeffs)``.

    The sweep engines already keep every function batch in this module's
    padded layout, so handing their outputs to the query ops is a dtype cast
    plus one coefficient stack — no re-packing.  A quadratic plane (``c2``)
    stacks to a ``(B, P, 3)`` coefficient block; the degree-2 query ops
    accept both widths.
    """
    starts = np.asarray(starts, dtype)
    planes = [np.asarray(c0), np.asarray(c1)]
    if c2 is not None:
        planes.append(np.asarray(c2))
    coeffs = np.stack(planes, -1).astype(dtype)
    return starts, coeffs


def pack_ppoly_grid(grid, max_pieces: int | None = None, max_coef: int | None = None):
    """Pack a ``B x F`` nested list of PPolys (``None`` = absent slot) into
    (B, F, P) / (B, F, P, K) float32 numpy arrays for :func:`ppoly_min_eval`."""
    B = len(grid)
    F = max(len(row) for row in grid)
    flat = [f for row in grid for f in row if f is not None]
    P = max_pieces or max(f.n_pieces for f in flat)
    K = max_coef or max(f.coeffs.shape[1] for f in flat)
    starts = np.full((B, F, P), PAD_START, np.float32)
    coeffs = np.zeros((B, F, P, K), np.float32)
    for i, row in enumerate(grid):
        for j, f in enumerate(row):
            if f is None:
                continue
            n = min(f.n_pieces, P)
            k = min(f.coeffs.shape[1], K)
            starts[i, j, :n] = f.starts[:n]
            coeffs[i, j, :n, :k] = f.coeffs[:n, :k]
    return starts, coeffs
