"""Batched piecewise-polynomial (degree <= 2) function algebra on padded arrays.

The scalar substrate (:mod:`repro_torch.core.ppoly`) represents ONE function as an
object; a what-if sweep needs the same algebra over HUNDREDS of scenarios at
once.  :class:`BPL` holds a batch of right-continuous piecewise functions of
degree <= 2 as padded ``(B, P)`` arrays — exactly the layout of
``kernels/ppoly_eval`` — and implements every query the batched solver needs
as vectorized numpy (float64, exact to the same precision as the scalar
path):

* right/left evaluation, slopes, and quadratic coefficients,
* next-breakpoint queries,
* first-crossing (``min{t : f(t) >= y}``, the paper's eq. (8) inverse) —
  exact through the quadratic formula's numerically-stable branch
  (:func:`repro_torch.core.ppoly.first_pos_root`),
* antiderivatives of piecewise-constant *and* piecewise-linear rate
  functions (burst absorption under ramped allocations),
* composition ``outer(inner(t))`` of a *shared* scalar piecewise-linear
  ``outer`` with a batched monotone ``inner`` of degree <= 2 (paper eq. (1)).

The quadratic plane ``c2`` is OPTIONAL (``None`` = identically zero): a
purely piecewise-linear batch pays no extra memory or arithmetic, so the
linear fast path is bit-identical to what it was before degree-2 support.

Padding uses the kernels' ``PAD_START`` sentinel so a ``BPL`` can be handed
to the CUDA query kernels (after a float32 cast) without re-packing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ppoly import PPoly, TIME_TOL, VAL_RTOL, first_pos_root
from repro_torch.kernels.ppoly_eval.ops import pack_ppolys_np
from repro_torch.kernels.ppoly_eval.ref import PAD_START

_INF = float("inf")


def is_pw_constant(fn: PPoly) -> bool:
    """True when a scalar ``PPoly`` is piecewise-constant — the resource-rate
    subclass whose progress functions stay piecewise-LINEAR.  (The engines'
    trace selection uses the packed-batch signal ``BPL.max_degree()`` /
    ``ScenarioPack.ramps`` instead; this scalar predicate is kept as a public
    classification helper.)"""
    return fn.coeffs.shape[1] == 1 or bool(np.all(fn.coeffs[:, 1:] == 0.0))


def is_batchable_resource(fn: PPoly, tol: float = 1e-12) -> bool:
    """True when a scalar resource-rate input fits the batched engines:
    piecewise-LINEAR and non-negative on its whole domain.

    Linear resource × linear requirement → quadratic progress pieces, which
    the degree-2 engines solve in closed form; a rate that goes negative (or
    degree >= 2) is outside the model class and routes to the scalar loop.
    """
    if not fn.is_piecewise_linear:
        return False
    c0 = fn.coeffs[:, 0]
    if fn.coeffs.shape[1] == 1:  # pw-constant fast path (the common sweep)
        return bool((c0 >= 0.0).all())
    c1 = fn.coeffs[:, 1]
    scale = max(1.0, float(np.max(np.abs(c0))))
    if np.any(c0 < -tol * scale):
        return False
    ends = c0[:-1] + c1[:-1] * np.diff(fn.starts)
    if len(ends) and np.any(ends < -tol * scale):
        return False
    return bool(c1[-1] >= 0.0)


class UnsupportedScenario(ValueError):
    """The batched engine's restricted function class is violated.

    The engine covers monotone piecewise-linear data inputs (jumps allowed)
    and non-negative piecewise-linear resource rate inputs — everything the
    paper's evaluation sweeps use plus monitoring-derived ramps.  Anything
    richer falls back to the scalar solver.
    """


@dataclass
class BPL:
    """Batch of right-continuous piecewise functions of degree <= 2.

    ``starts (B, P)`` ascending per row, padded with ``PAD_START``;
    ``c0/c1 (B, P)`` value/slope in local coordinates ``u = t - start``;
    ``c2 (B, P)`` optional quadratic coefficients (``None`` = all zero, the
    piecewise-linear fast path).
    """

    starts: np.ndarray
    c0: np.ndarray
    c1: np.ndarray
    c2: np.ndarray | None = None

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_ppolys(fns: list[PPoly], max_pieces: int | None = None) -> "BPL":
        for f in fns:
            if not f.is_piecewise_quadratic:
                raise UnsupportedScenario(
                    "batched sweep requires functions of degree <= 2 "
                    f"(got degree {f.degree})")
        quad = any(f.coeffs.shape[1] > 2 for f in fns)
        starts, coeffs = pack_ppolys_np(fns, max_pieces=max_pieces,
                                        max_coef=3 if quad else 2,
                                        dtype=np.float64)
        return BPL(starts, coeffs[..., 0].copy(), coeffs[..., 1].copy(),
                   coeffs[..., 2].copy() if quad else None)

    @staticmethod
    def constant(v: np.ndarray, start: np.ndarray) -> "BPL":
        v = np.asarray(v, np.float64)
        return BPL(np.asarray(start, np.float64)[:, None], v[:, None],
                   np.zeros((len(v), 1)))

    def broadcast(self, B: int) -> "BPL":
        """Fan a single-row batch out to ``B`` rows as read-only views.

        Zero-copy: this is how a compiled plan reuses its packed base input
        functions across sweeps of any batch size (every engine query reads
        but never mutates the arrays)."""
        if self.B == B:
            return self
        if self.B != 1:
            raise ValueError(f"can only broadcast a single-row BPL, got B={self.B}")
        return BPL(np.broadcast_to(self.starts, (B, self.P)),
                   np.broadcast_to(self.c0, (B, self.P)),
                   np.broadcast_to(self.c1, (B, self.P)),
                   None if self.c2 is None
                   else np.broadcast_to(self.c2, (B, self.P)))

    def as_triple(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The raw ``(starts, c0, c1)`` arrays of a piecewise-LINEAR batch."""
        if self.c2 is not None:
            raise ValueError("as_triple() on a quadratic batch; use arrays()")
        return self.starts, self.c0, self.c1

    def arrays(self) -> tuple[np.ndarray, ...]:
        """``(starts, c0, c1[, c2])`` — the torch engine's currency.  The
        tuple length IS the degree signature: 3 = piecewise-linear,
        4 = quadratic (the engine specializes on it)."""
        if self.c2 is None:
            return self.starts, self.c0, self.c1
        return self.starts, self.c0, self.c1, self.c2

    def row_subset(self, idx: "np.ndarray | list[int]") -> "BPL":
        """Rows ``idx`` of the batch.  Single-row batches pass through
        unchanged — they are broadcasts, every row is the same function."""
        if self.B == 1:
            return self
        sel = np.asarray(list(idx), dtype=int)
        return BPL(*(a[sel] for a in self.arrays()))

    def kernel_args(self) -> tuple[np.ndarray, np.ndarray]:
        """Float32 ``(starts, coeffs)`` for the ``kernels/ppoly_eval`` ops —
        same layout, so no re-packing beyond the coefficient stack."""
        from repro_torch.kernels.ppoly_eval.ops import pack_bpl_np

        return pack_bpl_np(self.starts, self.c0, self.c1, self.c2)

    # -- basics ------------------------------------------------------------
    @property
    def B(self) -> int:
        return self.starts.shape[0]

    @property
    def P(self) -> int:
        return self.starts.shape[1]

    def valid(self) -> np.ndarray:
        return self.starts < PAD_START * 0.5

    def max_degree(self) -> int:
        """Highest piece degree over the valid pieces of the batch."""
        v = self.valid()
        if self.c2 is not None and bool(np.any(np.where(v, self.c2, 0.0) != 0.0)):
            return 2
        if bool(np.any(np.where(v, self.c1, 0.0) != 0.0)):
            return 1
        return 0

    def _gather(self, idx: np.ndarray):
        take = np.take_along_axis
        return (take(self.starts, idx, 1), take(self.c0, idx, 1),
                take(self.c1, idx, 1))

    def _index(self, t: np.ndarray, tol: float) -> np.ndarray:
        """Piece index per query; ``t`` is (B,) or (B, M)."""
        t2 = t[:, None] if t.ndim == 1 else t
        cmp = self.starts[:, None, :] <= t2[:, :, None] + tol        # (B,M,P)
        return np.maximum(cmp.sum(-1) - 1, 0)

    def _eval_at(self, t: np.ndarray, tol: float) -> np.ndarray:
        one = t.ndim == 1
        idx = self._index(t, tol)
        s, c0, c1 = self._gather(idx)
        t2 = t[:, None] if one else t
        u = t2 - s
        if self.c2 is None:
            out = c0 + c1 * u
        else:
            out = c0 + (c1 + np.take_along_axis(self.c2, idx, 1) * u) * u
        return out[:, 0] if one else out

    def eval_right(self, t: np.ndarray) -> np.ndarray:
        return self._eval_at(t, TIME_TOL)

    def eval_left(self, t: np.ndarray) -> np.ndarray:
        return self._eval_at(t, -TIME_TOL)

    def slope_right(self, t: np.ndarray) -> np.ndarray:
        one = t.ndim == 1
        idx = self._index(t, TIME_TOL)
        out = np.take_along_axis(self.c1, idx, 1)
        if self.c2 is not None:
            s = np.take_along_axis(self.starts, idx, 1)
            t2 = t[:, None] if one else t
            out = out + 2.0 * np.take_along_axis(self.c2, idx, 1) * (t2 - s)
        return out[:, 0] if one else out

    def eval_slope_quad_right(self, t: np.ndarray):
        """``(value, slope, quad)`` at ``t`` sharing one piece lookup — the
        local re-anchoring of each governing piece at ``t``."""
        one = t.ndim == 1
        idx = self._index(t, TIME_TOL)
        s, c0, c1 = self._gather(idx)
        t2 = t[:, None] if one else t
        u = t2 - s
        if self.c2 is None:
            v = c0 + c1 * u
            sl = c1
            qd = np.zeros_like(c1)
        else:
            q = np.take_along_axis(self.c2, idx, 1)
            v = c0 + (c1 + q * u) * u
            sl = c1 + 2.0 * q * u
            qd = q
        if one:
            return v[:, 0], sl[:, 0], qd[:, 0]
        return v, sl, qd

    def next_break_after(self, t: np.ndarray) -> np.ndarray:
        """Smallest breakpoint ``> t + TIME_TOL`` per row (inf if none)."""
        cand = np.where(self.valid() & (self.starts > t[:, None] + TIME_TOL),
                        self.starts, _INF)
        return cand.min(1)

    # -- queries -----------------------------------------------------------
    def first_at_or_above(self, y: np.ndarray, t_lo: np.ndarray | None = None) -> np.ndarray:
        """First ``t >= t_lo`` with ``f(t) >= y`` (f monotone nondecreasing)."""
        y_ = np.asarray(y, np.float64)[:, None]                      # (B,1)
        nxt = np.concatenate([self.starts[:, 1:],
                              np.full((self.B, 1), PAD_START)], 1)
        plen = nxt - self.starts
        tol = VAL_RTOL * np.maximum(1.0, np.abs(y_)) + 1e-12
        cand = np.where(self.c0 >= y_ - tol, self.starts, _INF)
        if self.c2 is None:
            with np.errstate(divide="ignore", invalid="ignore"):
                u = (y_ - self.c0) / np.where(self.c1 > 0, self.c1, 1.0)
            ok = (self.c1 > 0) & (self.c0 < y_ - tol) & (u <= plen + TIME_TOL)
        else:
            # exact quadratic crossing (stable branch); pieces are monotone
            # nondecreasing on their valid domain, so the smallest positive
            # root is the crossing
            u = first_pos_root(self.c2, self.c1, self.c0 - y_, tol=0.0)
            ok = (self.c0 < y_ - tol) & (u <= plen + TIME_TOL)
        cand = np.minimum(cand, np.where(ok, self.starts + u, _INF))
        cand = np.where(self.valid(), cand, _INF)
        out = cand.min(1)
        if t_lo is not None:
            out = np.where(np.isfinite(out), np.maximum(out, t_lo), out)
        return out

    # -- calculus ----------------------------------------------------------
    def is_piecewise_constant(self) -> bool:
        v = self.valid()
        if self.c2 is not None and np.any(np.where(v, self.c2, 0.0) != 0.0):
            return False
        return bool(np.all(np.where(v, self.c1, 0.0) == 0.0))

    def antiderivative(self) -> "BPL":
        """Continuous antiderivative (value 0 at the domain start).

        Accepts piecewise-constant AND piecewise-linear rate inputs (degree
        <= 1), so the result stays within the degree <= 2 class — the
        burst-absorption query of Algorithm 2 under ramped allocations.
        """
        if self.max_degree() > 1:
            raise UnsupportedScenario(
                "antiderivative needs rate inputs of degree <= 1")
        nxt = np.concatenate([self.starts[:, 1:],
                              np.full((self.B, 1), PAD_START)], 1)
        plen = np.where(nxt < PAD_START * 0.5, nxt - self.starts, 0.0)
        if self.is_piecewise_constant():
            areas = np.where(self.valid(), self.c0 * plen, 0.0)
            acc = np.concatenate([np.zeros((self.B, 1)),
                                  np.cumsum(areas, 1)[:, :-1]], 1)
            return BPL(self.starts.copy(), acc, self.c0.copy())
        areas = np.where(self.valid(),
                         (self.c0 + 0.5 * self.c1 * plen) * plen, 0.0)
        acc = np.concatenate([np.zeros((self.B, 1)),
                              np.cumsum(areas, 1)[:, :-1]], 1)
        return BPL(self.starts.copy(), acc, self.c0.copy(), 0.5 * self.c1)


def compose_scalar(outer: PPoly, inner: BPL) -> BPL:
    """``outer(inner(t))`` for shared piecewise-linear ``outer`` (jumps OK)
    and batched monotone non-decreasing ``inner`` of degree <= 2 (paper
    eq. (1), batched): a linear map of the inner's local pieces, so the
    result keeps the inner's degree.

    New breakpoints are inner's own plus the first crossing of each outer
    breakpoint value — per scenario, fully vectorized.
    """
    if outer.coeffs.shape[1] > 2:
        raise UnsupportedScenario(
            "batched sweep requires piecewise-linear requirement functions")
    o_s = outer.starts
    o_c0 = outer.coeffs[:, 0]
    o_c1 = outer.coeffs[:, 1] if outer.coeffs.shape[1] > 1 else np.zeros(len(o_s))
    B = inner.B
    cols = [inner.starts]
    for v in o_s[1:]:
        cross = inner.first_at_or_above(np.full(B, float(v)))
        cols.append(np.where(np.isfinite(cross), cross, PAD_START)[:, None])
    starts = np.sort(np.concatenate(cols, 1), axis=1)
    v, si, qi = inner.eval_slope_quad_right(starts)
    oi = np.maximum(np.searchsorted(o_s, v + TIME_TOL, side="right") - 1, 0)
    c0 = o_c0[oi] + o_c1[oi] * (v - o_s[oi])
    c1 = o_c1[oi] * si
    pad = starts >= PAD_START * 0.5
    c2 = None
    if inner.c2 is not None:
        c2 = np.where(pad, 0.0, o_c1[oi] * qi)
    return BPL(starts, np.where(pad, 0.0, c0), np.where(pad, 0.0, c1), c2)
