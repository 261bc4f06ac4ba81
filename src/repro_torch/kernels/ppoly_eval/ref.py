"""Plain PyTorch versions of the batched piecewise-polynomial queries.

Three primitives, mirrored by the CUDA kernels in :mod:`.kernel`:

* :func:`ppoly_eval_ref` — evaluate B functions at T points each,
* :func:`ppoly_min_eval_ref` — ``min_k f_k(t)`` with argmin attribution over a
  stacked family of F functions per batch row (paper eq. (2): the limiting
  function IS the bottleneck),
* :func:`ppoly_first_crossing_ref` — first ``t`` with ``f(t) >= y`` for
  monotone piecewise ``f`` of degree <= 2 (finish-time extraction).

They run on whatever device their inputs live on; the public ops in
:mod:`.ops` call them for CPU tensors, and the kernels are held against
them on the card.
"""

from __future__ import annotations

import torch

PAD_START = 1e30  # sentinel start for padding pieces (never selected)
_BIG = 3e37       # "+inf" stand-in that survives float32 arithmetic


def _horner(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sum_k c[..., k] * u**k`` by Horner's rule, one rounding per op."""
    acc = torch.zeros_like(u)
    for k in range(c.shape[-1] - 1, -1, -1):
        acc = acc * u + c[..., k]
    return acc


def ppoly_eval_ref(starts: torch.Tensor, coeffs: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """Evaluate a batch of right-continuous piecewise polynomials.

    Args:
      starts: (B, P) piece start positions, ascending per row; padding pieces
        use ``PAD_START``.
      coeffs: (B, P, K) ascending local coefficients (c0 + c1*u + ...), with
        ``u = t - starts[i]``.
      q:      (B, T) query positions.

    Returns:
      (B, T) values.  Queries before ``starts[:, 0]`` clamp to piece 0
      (matching ``repro_torch.core.ppoly.PPoly.__call__``).
    """
    B, T = q.shape
    K = coeffs.shape[-1]
    cmp = starts[:, None, :] <= q[:, :, None]                       # (B,T,P)
    idx = (cmp.sum(-1) - 1).clamp_min(0)                            # (B,T)
    c = torch.gather(coeffs, 1, idx[:, :, None].expand(B, T, K))    # (B,T,K)
    s = torch.gather(starts, 1, idx)                                # (B,T)
    return _horner(c, q - s)


def ppoly_min_eval_ref(starts: torch.Tensor, coeffs: torch.Tensor,
                       q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``min_f`` over a stacked family of piecewise polynomials, with argmin.

    Args:
      starts: (B, F, P) piece starts; a slot whose first start is
        ``>= PAD_START / 2`` is absent and can never attain the minimum.
      coeffs: (B, F, P, K) ascending local coefficients.
      q:      (B, T) query positions.

    Returns:
      ``(vals, argmin)`` of shapes (B, T) / (B, T) int32.  Ties resolve to the
      lowest function index (matching ``PPoly.minimum`` attribution).
    """
    B, F, P = starts.shape
    K = coeffs.shape[-1]
    T = q.shape[-1]
    cmp = starts[:, :, None, :] <= q[:, None, :, None]              # (B,F,T,P)
    idx = (cmp.sum(-1) - 1).clamp_min(0)                            # (B,F,T)
    c = torch.gather(coeffs, 2, idx[..., None].expand(B, F, T, K))
    s = torch.gather(starts, 2, idx)                                # (B,F,T)
    acc = _horner(c, q[:, None, :] - s)
    valid = (starts[:, :, 0] < PAD_START * 0.5)[:, :, None]         # (B,F,1)
    acc = torch.where(valid, acc, torch.full_like(acc, _BIG))
    # argmin returns the first index among equal minima
    return acc.amin(1), acc.argmin(1).to(torch.int32)


def first_crossing_candidates(s, c0, c1, c2, plen, y, tol):
    """Per-piece first-crossing candidate times (broadcastable args).

    Linear pieces use the exact division; quadratic pieces the quadratic
    formula's numerically-stable q-branch (roots ``q/a`` and ``c/q``) — the
    float32 mirror of ``repro_torch.core.ppoly.first_pos_root``.  Pieces are
    monotone nondecreasing on their valid domain, so the smallest
    non-negative root is the crossing.  The CUDA kernel repeats these
    operations one for one.
    """
    # candidate 1: the piece already starts at/above y (covers jumps)
    cand = torch.where(c0 >= y - tol, s, _BIG)
    below = c0 < y - tol
    # candidate 2: an increasing LINEAR piece crosses y before its end
    u = (y - c0) / torch.where(c1 > 0, c1, 1.0)
    ok = (c2 == 0) & (c1 > 0) & below & (u <= plen)
    cand = torch.minimum(cand, torch.where(ok, s + u, _BIG))
    # candidate 3: a QUADRATIC piece crosses y before its end (stable roots)
    b, c = c1, c0 - y
    disc = b * b - 4.0 * c2 * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    qm = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    r1 = qm / torch.where(c2 != 0, c2, 1.0)
    r2 = c / torch.where(qm != 0, qm, 1.0)
    r1 = torch.where(r1 >= 0, r1, _BIG)
    r2 = torch.where((qm != 0) & (r2 >= 0), r2, _BIG)
    uq = torch.minimum(r1, r2)
    okq = (c2 != 0) & (disc >= 0) & below & (uq <= plen)
    return torch.minimum(cand, torch.where(okq, s + uq, _BIG))


def ppoly_first_crossing_ref(starts: torch.Tensor, coeffs: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """First ``t`` with ``f(t) >= y`` for monotone piecewise ``f``, degree <= 2.

    Args:
      starts: (B, P) piece starts (``PAD_START`` padding).
      coeffs: (B, P, K) with K <= 3 (linear or quadratic pieces; jumps
        allowed).
      y:      (B, T) query levels.

    Returns:
      (B, T) crossing times (``>= _BIG`` when the level is never reached).
    """
    B, P = starts.shape
    c0 = coeffs[..., 0]
    c1 = coeffs[..., 1] if coeffs.shape[-1] > 1 else torch.zeros_like(c0)
    c2 = coeffs[..., 2] if coeffs.shape[-1] > 2 else torch.zeros_like(c0)
    valid = starts < PAD_START * 0.5                                # (B,P)
    plen = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], PAD_START)],
                     1) - starts                                    # (B,P)
    y_ = y[:, :, None]                                              # (B,T,1)
    tol = 1e-6 * y_.abs().clamp_min(1.0)
    cand = first_crossing_candidates(
        starts[:, None, :], c0[:, None, :], c1[:, None, :], c2[:, None, :],
        plen[:, None, :], y_, tol)
    cand = torch.where(valid[:, None, :], cand, _BIG)
    return cand.min(-1).values
