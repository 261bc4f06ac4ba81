"""Exact piecewise-polynomial function algebra — the substrate of BottleMod.

A :class:`PPoly` represents a right-continuous, piecewise-polynomial function
on ``[starts[0], +inf)``.  Piece ``i`` is valid on ``[starts[i], starts[i+1])``
(the last piece extends to ``+inf``) and is stored in *local* coordinates
``u = t - starts[i]`` with coefficients in **ascending** order
(``c[0] + c[1]*u + c[2]*u**2 + ...``).

Jump discontinuities are permitted (the representation is right-continuous);
``value_left`` gives the left limit at a breakpoint.

This module implements everything BottleMod's solver (paper Sect. 3/4) needs
symbolically:

* evaluation, derivative, antiderivative,
* addition / scalar multiplication,
* pointwise ``min`` of several functions *with argmin attribution* (paper
  eq. (2): section-wise choosing the lowest function),
* composition ``outer(inner(t))`` for monotone ``inner`` (paper eq. (1):
  ``P_Dk(t) = R_Dk(I_Dk(t))``),
* first-crossing queries (the event queue of Algorithm 2),
* pseudo-inverse of monotone piecewise-linear functions (paper eq. (8)).

Everything is plain float64 numpy; root finding uses closed forms for degree
<= 2 and ``np.roots`` above that.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PPoly", "poly_eval", "poly_shift", "poly_compose", "poly_real_roots",
           "first_pos_root"]

#: absolute tolerance used when comparing breakpoints / roots (time axis)
TIME_TOL = 1e-9
#: relative tolerance used when comparing function values
VAL_RTOL = 1e-9

_INF = float("inf")


# --------------------------------------------------------------------------
# plain-polynomial helpers (ascending coefficients)
# --------------------------------------------------------------------------

def poly_eval(c: np.ndarray, u):
    """Evaluate ascending-coefficient polynomial via Horner."""
    c = np.asarray(c, dtype=np.float64)
    acc = np.zeros_like(np.asarray(u, dtype=np.float64))
    for coef in c[::-1]:
        acc = acc * u + coef
    return acc


def poly_trim(c: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """Drop trailing (highest-degree) ~zero coefficients; keep >= 1 entry."""
    c = np.asarray(c, dtype=np.float64)
    n = len(c)
    while n > 1 and abs(c[n - 1]) <= tol:
        n -= 1
    return c[:n]


def poly_shift(c: np.ndarray, d: float) -> np.ndarray:
    """Coefficients of ``q(u) = p(u + d)`` (Taylor shift)."""
    c = np.asarray(c, dtype=np.float64)
    k = len(c)
    if k == 1 or d == 0.0:
        return c.copy()
    out = np.zeros(k)
    # binomial expansion: out[j] = sum_{i>=j} c[i] * C(i, j) * d**(i-j)
    from math import comb

    for j in range(k):
        s = 0.0
        for i in range(j, k):
            s += c[i] * comb(i, j) * (d ** (i - j))
        out[j] = s
    return out


def poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.convolve(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


def poly_compose(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """Coefficients of ``outer(inner(u))`` (ascending)."""
    outer = np.asarray(outer, dtype=np.float64)
    acc = np.array([0.0])
    for coef in outer[::-1]:
        acc = poly_mul(acc, inner)
        if len(acc) == 0:
            acc = np.array([0.0])
        acc = acc.copy()
        acc[0] += coef
    return acc


def poly_real_roots(c: np.ndarray, lo: float, hi: float, *, tol: float = TIME_TOL):
    """Real roots of the ascending-coefficient polynomial in ``[lo, hi)``.

    Returns a sorted list.  Degenerate (identically ~zero) polynomials return
    an empty list — callers treat "equal everywhere" separately.
    """
    c = poly_trim(np.asarray(c, dtype=np.float64))
    scale = max(np.max(np.abs(c)), 1e-300)
    c_n = c / scale
    deg = len(c_n) - 1
    roots: list[float] = []
    if deg == 0:
        return roots
    if deg == 1:
        b, a = c_n[0], c_n[1]
        if a != 0.0:
            roots = [-b / a]
    elif deg == 2:
        cc, bb, aa = c_n[0], c_n[1], c_n[2]
        disc = bb * bb - 4.0 * aa * cc
        if disc >= 0.0:
            sq = np.sqrt(disc)
            # numerically-stable quadratic roots
            q = -0.5 * (bb + np.copysign(sq, bb if bb != 0 else 1.0))
            r1 = q / aa
            r2 = cc / q if q != 0.0 else r1
            roots = sorted({r1, r2})
    else:
        rr = np.roots(c_n[::-1])
        roots = sorted(float(r.real) for r in rr if abs(r.imag) <= 1e-7 * max(1.0, abs(r.real)))
    out = []
    for r in roots:
        if lo - tol <= r < hi - tol:
            out.append(min(max(r, lo), hi))
    # dedupe
    ded: list[float] = []
    for r in out:
        if not ded or r - ded[-1] > tol:
            ded.append(r)
    return ded


def first_pos_root(a, b, c, tol: float = TIME_TOL):
    """Elementwise smallest root ``> tol`` of ``a·u² + b·u + c`` (inf if none).

    The quadratic-formula primitive of the batched engines: every event of
    the piecewise-quadratic lockstep solver ("when does motion cover Δ",
    "when do two ceilings cross", "when does a cap undercut the ceiling
    slope") is the first positive root of one quadratic per scenario.  Uses
    the numerically-stable ``q``-branch (``q = -(b + sign(b)·√disc)/2``,
    roots ``q/a`` and ``c/q``) so near-degenerate discriminants and tiny
    leading coefficients do not cancel catastrophically; ``a == 0`` rows
    fall back to the linear root exactly.  Mirrored op-for-op by the torch
    engine (:mod:`repro_torch.sweep.torch_engine`).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lin = np.where(b != 0.0, -c / np.where(b != 0.0, b, 1.0), _INF)
        disc = b * b - 4.0 * a * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        q = -0.5 * (b + np.where(b >= 0.0, sq, -sq))
        r1 = np.where(a != 0.0, q / np.where(a != 0.0, a, 1.0), _INF)
        r2 = np.where(q != 0.0, c / np.where(q != 0.0, q, 1.0), _INF)
    quad = np.minimum(np.where(r1 > tol, r1, _INF),
                      np.where(r2 > tol, r2, _INF))
    quad = np.where(disc >= 0.0, quad, _INF)
    return np.where(a == 0.0, np.where(lin > tol, lin, _INF), quad)


# --------------------------------------------------------------------------
# PPoly
# --------------------------------------------------------------------------

class PPoly:
    """Right-continuous piecewise polynomial on ``[starts[0], +inf)``."""

    __slots__ = ("starts", "coeffs")

    def __init__(self, starts, coeffs):
        starts = np.asarray(starts, dtype=np.float64)
        if starts.ndim != 1 or len(starts) == 0:
            raise ValueError("starts must be a non-empty 1-D array")
        if np.any(np.diff(starts) <= 0):
            raise ValueError("starts must be strictly increasing")
        if isinstance(coeffs, np.ndarray) and coeffs.ndim == 2:
            cl = [poly_trim(coeffs[i]) for i in range(coeffs.shape[0])]
        else:
            cl = [poly_trim(np.asarray(c, dtype=np.float64)) for c in coeffs]
        if len(cl) != len(starts):
            raise ValueError("coeffs and starts length mismatch")
        k = max(len(c) for c in cl)
        mat = np.zeros((len(cl), k))
        for i, c in enumerate(cl):
            mat[i, : len(c)] = c
        self.starts = starts
        self.coeffs = mat

    # -- constructors -----------------------------------------------------
    @staticmethod
    def constant(v: float, start: float = 0.0) -> "PPoly":
        return PPoly(np.array([start]), np.array([[float(v)]]))

    @staticmethod
    def linear(y0: float, slope: float, start: float = 0.0) -> "PPoly":
        return PPoly(np.array([start]), np.array([[float(y0), float(slope)]]))

    @staticmethod
    def pwlinear(xs, ys) -> "PPoly":
        """Continuous piecewise-linear interpolation through ``(xs, ys)``.

        The function is constant (= ``ys[-1]``) after ``xs[-1]``.
        """
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if len(xs) < 2:
            return PPoly.constant(ys[0], xs[0])
        starts = []
        coeffs = []
        for i in range(len(xs) - 1):
            dx = xs[i + 1] - xs[i]
            slope = (ys[i + 1] - ys[i]) / dx
            starts.append(xs[i])
            coeffs.append([ys[i], slope])
        starts.append(xs[-1])
        coeffs.append([ys[-1]])
        return PPoly(np.array(starts), coeffs)

    @staticmethod
    def step(xs, ys) -> "PPoly":
        """Right-continuous step function: value ``ys[i]`` on ``[xs[i], xs[i+1})``."""
        xs = np.asarray(xs, dtype=np.float64)
        return PPoly(xs, [[float(y)] for y in np.asarray(ys, dtype=np.float64)])

    # -- basics ------------------------------------------------------------
    @property
    def n_pieces(self) -> int:
        return len(self.starts)

    @property
    def degree(self) -> int:
        return self.coeffs.shape[1] - 1

    @property
    def is_piecewise_linear(self) -> bool:
        """True when every piece has degree <= 1 (the class of the batched
        engines' data inputs / requirements / outputs)."""
        return self.coeffs.shape[1] <= 2

    @property
    def is_piecewise_quadratic(self) -> bool:
        """True when every piece has degree <= 2 — the full function class of
        the batched sweep engines and the degree-2 ``kernels/ppoly_eval``
        queries (linear resource × linear requirement → quadratic progress)."""
        return self.coeffs.shape[1] <= 3

    def linear_parts(self):
        """``(starts, values, slopes)`` arrays of a piecewise-linear function
        — the packing hook used by the batched sweep substrate."""
        if not self.is_piecewise_linear:
            raise ValueError("linear_parts requires piecewise-linear input")
        c1 = (self.coeffs[:, 1] if self.coeffs.shape[1] > 1
              else np.zeros(self.n_pieces))
        return self.starts.copy(), self.coeffs[:, 0].copy(), c1.copy()

    def piece_index(self, t: float) -> int:
        """Index of the piece governing the *right* value at ``t``."""
        i = int(np.searchsorted(self.starts, t + TIME_TOL, side="right") - 1)
        return max(i, 0)

    def piece_end(self, i: int) -> float:
        return float(self.starts[i + 1]) if i + 1 < self.n_pieces else _INF

    def __call__(self, t):
        t_arr = np.asarray(t, dtype=np.float64)
        idx = np.clip(np.searchsorted(self.starts, t_arr + TIME_TOL, side="right") - 1, 0, None)
        u = t_arr - self.starts[idx]
        acc = np.zeros_like(t_arr)
        for j in range(self.coeffs.shape[1] - 1, -1, -1):
            acc = acc * u + self.coeffs[idx, j]
        return acc if acc.ndim else float(acc)

    def value_left(self, t: float) -> float:
        """Left limit at ``t`` (equals ``self(t)`` away from breakpoints)."""
        i = int(np.searchsorted(self.starts, t - TIME_TOL, side="right") - 1)
        i = max(i, 0)
        return float(poly_eval(self.coeffs[i], t - self.starts[i]))

    # -- calculus ----------------------------------------------------------
    def derivative(self) -> "PPoly":
        n, k = self.coeffs.shape
        if k == 1:
            return PPoly(self.starts.copy(), np.zeros((n, 1)))
        d = self.coeffs[:, 1:] * np.arange(1, k)[None, :]
        return PPoly(self.starts.copy(), d)

    def antiderivative(self, y0: float = 0.0) -> "PPoly":
        """Continuous antiderivative with value ``y0`` at ``starts[0]``."""
        n, k = self.coeffs.shape
        out = np.zeros((n, k + 1))
        out[:, 1:] = self.coeffs / np.arange(1, k + 1)[None, :]
        acc = float(y0)
        for i in range(n):
            out[i, 0] = acc
            if i + 1 < n:
                acc = float(poly_eval(out[i], self.starts[i + 1] - self.starts[i]))
        return PPoly(self.starts.copy(), out)

    def integrate(self, a: float, b: float) -> float:
        F = self.antiderivative()
        return float(F(b) - F(a))

    # -- structure ---------------------------------------------------------
    def shift_t(self, dt: float) -> "PPoly":
        return PPoly(self.starts + dt, self.coeffs.copy())

    def restrict(self, lo: float) -> "PPoly":
        """Drop pieces entirely before ``lo``; re-anchor the first piece at ``lo``."""
        i = self.piece_index(lo)
        starts = self.starts[i:].copy()
        coeffs = self.coeffs[i:].copy()
        if starts[0] < lo - TIME_TOL:
            coeffs[0] = np.resize(poly_shift(coeffs[0], lo - starts[0]), coeffs.shape[1])
            starts[0] = lo
        return PPoly(starts, coeffs)

    def simplify(self, tol: float = 1e-12) -> "PPoly":
        """Merge adjacent pieces that continue the same polynomial."""
        keep = [0]
        for i in range(1, self.n_pieces):
            prev = keep[-1]
            shifted = poly_shift(self.coeffs[prev], self.starts[i] - self.starts[prev])
            shifted = np.resize(shifted, self.coeffs.shape[1])
            scale = max(1.0, float(np.max(np.abs(self.coeffs[i]))))
            if np.allclose(shifted, self.coeffs[i], atol=tol * scale, rtol=tol):
                continue
            keep.append(i)
        return PPoly(self.starts[keep], self.coeffs[keep])

    def refine_starts(self, extra: np.ndarray) -> "PPoly":
        """Insert additional breakpoints (values unchanged)."""
        pts = [float(p) for p in extra if p > self.starts[0] + TIME_TOL]
        merged = list(self.starts)
        for p in pts:
            j = int(np.searchsorted(np.asarray(merged), p))
            if j > 0 and abs(merged[j - 1] - p) <= TIME_TOL:
                continue
            if j < len(merged) and abs(merged[j] - p) <= TIME_TOL:
                continue
            merged.insert(j, p)
        merged_arr = np.array(merged)
        coeffs = []
        for s in merged_arr:
            i = self.piece_index(s)
            coeffs.append(poly_shift(self.coeffs[i], s - self.starts[i]))
        return PPoly(merged_arr, coeffs)

    # -- algebra -----------------------------------------------------------
    def _binary(self, other: "PPoly", op) -> "PPoly":
        s0 = max(self.starts[0], other.starts[0])
        a = self.restrict(s0)
        b = other.restrict(s0)
        merged = np.union1d(a.starts, b.starts)
        # collapse nearly-equal breakpoints
        keep = [0]
        for i in range(1, len(merged)):
            if merged[i] - merged[keep[-1]] > TIME_TOL:
                keep.append(i)
        merged = merged[keep]
        coeffs = []
        for s in merged:
            ia, ib = a.piece_index(s), b.piece_index(s)
            ca = poly_shift(a.coeffs[ia], s - a.starts[ia])
            cb = poly_shift(b.coeffs[ib], s - b.starts[ib])
            k = max(len(ca), len(cb))
            ca = np.resize(np.append(ca, np.zeros(k - len(ca))), k)
            cb = np.resize(np.append(cb, np.zeros(k - len(cb))), k)
            coeffs.append(op(ca, cb))
        return PPoly(merged, coeffs)

    def __add__(self, other):
        if np.isscalar(other):
            c = self.coeffs.copy()
            c[:, 0] += float(other)
            return PPoly(self.starts.copy(), c)
        return self._binary(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        if np.isscalar(other):
            return self + (-float(other))
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, k):
        if not np.isscalar(k):
            raise TypeError("PPoly multiplication only supports scalars")
        return PPoly(self.starts.copy(), self.coeffs * float(k))

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    @staticmethod
    def multiply(f: "PPoly", g: "PPoly") -> "PPoly":
        """Pointwise product (piece degrees add)."""
        s0 = max(float(f.starts[0]), float(g.starts[0]))
        a, b = f.restrict(s0), g.restrict(s0)
        merged = np.union1d(a.starts, b.starts)
        keep = [0]
        for i in range(1, len(merged)):
            if merged[i] - merged[keep[-1]] > TIME_TOL:
                keep.append(i)
        merged = merged[keep]
        coeffs = []
        for s in merged:
            ca = poly_shift(a.coeffs[a.piece_index(s)], s - a.starts[a.piece_index(s)])
            cb = poly_shift(b.coeffs[b.piece_index(s)], s - b.starts[b.piece_index(s)])
            coeffs.append(poly_mul(ca, cb))
        return PPoly(merged, coeffs).simplify()

    def clip_min(self, lo: float = 0.0) -> "PPoly":
        """max(f, lo) — used to keep freed link capacity non-negative."""
        m, _ = PPoly.minimum([self * -1.0, PPoly.constant(-lo, float(self.starts[0]))])
        return m * -1.0

    # -- min with attribution (paper eq. (2)) --------------------------------
    @staticmethod
    def minimum(fns: list["PPoly"]):
        """Pointwise minimum of ``fns``.

        Returns ``(PPoly, segments)`` where ``segments`` is a list of
        ``(start_time, argmin_index)`` describing which input attains the
        minimum on each resulting piece (the paper's bottleneck attribution).
        """
        if len(fns) == 1:
            return fns[0], [(float(fns[0].starts[0]), 0)]
        cur, seg = fns[0], [(float(fns[0].starts[0]), 0)]
        for idx in range(1, len(fns)):
            cur, seg = _min2(cur, seg, fns[idx], idx)
        return cur, seg

    # -- composition (paper eq. (1)) ----------------------------------------
    @staticmethod
    def compose(outer: "PPoly", inner: "PPoly") -> "PPoly":
        """``outer(inner(t))`` for monotone non-decreasing ``inner``."""
        t0 = float(inner.starts[0])
        # breakpoints: inner's own, plus every t where inner crosses an outer
        # breakpoint value.
        cross: list[float] = []
        for ob in outer.starts[1:] if outer.n_pieces > 1 else []:
            ts = inner_crossings(inner, float(ob))
            cross.extend(ts)
        base = inner.refine_starts(np.array(cross)) if cross else inner
        coeffs = []
        for i, s in enumerate(base.starts):
            cin = base.coeffs[i]
            # pick the outer piece governing this interval: since inner is
            # monotone non-decreasing and the interval contains no crossing of
            # an outer breakpoint in its interior, the value slightly inside
            # the interval selects the correct piece (robust at boundaries).
            e = base.piece_end(i)
            mid = s + (e - s) * 0.5 if np.isfinite(e) else s + 0.5
            vmid = float(poly_eval(cin, mid - s))
            v0 = float(poly_eval(cin, 0.0))
            oi = outer.piece_index(max(v0, vmid) if vmid >= v0 else v0)
            cout = outer.coeffs[oi]
            # outer local coord: v_local = inner(u) - outer.starts[oi]
            inner_local = cin.copy()
            inner_local[0] -= outer.starts[oi]
            coeffs.append(poly_compose(cout, inner_local))
        return PPoly(base.starts.copy(), coeffs).simplify()

    # -- queries -------------------------------------------------------------
    def first_time_at_or_above(self, y: float, t_lo: float) -> float:
        """First ``t >= t_lo`` with ``f(t) >= y`` (f monotone non-decreasing).

        Returns ``inf`` if never reached.
        """
        t_lo = max(t_lo, float(self.starts[0]))
        if self(t_lo) >= y - abs(y) * VAL_RTOL - 1e-12:
            return t_lo
        i = self.piece_index(t_lo)
        while i < self.n_pieces:
            s = max(float(self.starts[i]), t_lo)
            e = self.piece_end(i)
            c = self.coeffs[i]
            v_end = float(poly_eval(c, (e - self.starts[i]) if np.isfinite(e) else 0.0)) if np.isfinite(e) else None
            # does this piece reach y?
            cc = c.copy()
            cc[0] -= y
            roots = poly_real_roots(cc, s - self.starts[i], (e - self.starts[i]) if np.isfinite(e) else _INF)
            for r in roots:
                t = float(self.starts[i]) + r
                if t >= t_lo - TIME_TOL:
                    return max(t, t_lo)
            if np.isfinite(e):
                # value may jump across the boundary
                if self(e) >= y - abs(y) * VAL_RTOL - 1e-12:
                    return float(e)
            i += 1
        return _INF

    def sup(self) -> float:
        """Limit for t -> inf (inf if the last piece is non-constant increasing)."""
        last = poly_trim(self.coeffs[-1])
        if len(last) == 1:
            return float(last[0])
        return _INF if last[-1] > 0 or (len(last) > 1 and last[1] > 0) else -_INF

    def is_monotone_nondecreasing(self, samples_per_piece: int = 17) -> bool:
        prev = None
        for i in range(self.n_pieces):
            s = float(self.starts[i])
            e = self.piece_end(i)
            if not np.isfinite(e):
                e = s + max(1.0, abs(s)) * 4.0
            us = np.linspace(0.0, e - s, samples_per_piece)
            vs = poly_eval(self.coeffs[i], us)
            if np.any(np.diff(vs) < -1e-7 * max(1.0, float(np.max(np.abs(vs))))):
                return False
            if prev is not None and vs[0] < prev - 1e-7 * max(1.0, abs(prev)):
                return False
            prev = float(vs[-1])
        return True

    # -- pseudo-inverse (paper eq. (8)) ---------------------------------------
    def inv_at(self, y) -> float:
        """Exact generalized inverse ``min{t : f(t) >= y}`` (monotone ``f``).

        Unlike :meth:`pseudo_inverse` this is correct *at* jump ordinates
        (``inv_at(y)`` of a burst function returns 0 at ``y = 0``), which is
        what eq. (8)'s consumed-data term needs.  Accepts scalars or arrays.
        """
        if np.ndim(y) == 0:
            return self.first_time_at_or_above(float(y), float(self.starts[0]))
        return np.array([self.first_time_at_or_above(float(v), float(self.starts[0])) for v in np.ravel(y)]).reshape(np.shape(y))

    def pseudo_inverse(self) -> "PPoly":
        """Generalized inverse ``g(y) = min{t : f(t) >= y}`` for monotone
        piecewise-linear ``f``.  Flat pieces of ``f`` become jumps of ``g``;
        jumps of ``f`` become flat pieces of ``g``.

        NOTE: the result is right-continuous, so *at* a jump ordinate of the
        input the post-jump preimage is returned (use :meth:`inv_at` for the
        exact left-limit semantics needed by eq. (8))."""
        if self.coeffs.shape[1] > 2:
            raise ValueError("pseudo_inverse requires piecewise-linear input")
        ys: list[float] = []
        cs: list[np.ndarray] = []
        y_prev = None
        for i in range(self.n_pieces):
            s = float(self.starts[i])
            c = self.coeffs[i]
            y0 = float(c[0])
            slope = float(c[1]) if len(c) > 1 else 0.0
            if y_prev is None:
                ys.append(y0)
                cs.append(np.array([s]) if slope == 0.0 else np.array([s, 1.0 / slope]))
                y_prev = y0
            else:
                if y0 > y_prev + VAL_RTOL * max(1.0, abs(y_prev)):
                    # jump in f -> flat piece in g at value s
                    ys.append(y_prev)
                    cs.append(np.array([s]))
                y_prev = y0
                if slope > 0.0:
                    ys.append(y0)
                    cs.append(np.array([s, 1.0 / slope]))
            if slope > 0.0:
                e = self.piece_end(i)
                if np.isfinite(e):
                    y_prev = float(poly_eval(c, e - s))
        # dedupe non-increasing starts
        out_y: list[float] = []
        out_c: list[np.ndarray] = []
        for y, c in zip(ys, cs):
            if out_y and y <= out_y[-1] + 1e-15 * max(1.0, abs(y)):
                out_c[-1] = c
                continue
            out_y.append(y)
            out_c.append(c)
        return PPoly(np.array(out_y), out_c)

    # -- misc -----------------------------------------------------------------
    def sample(self, ts: np.ndarray) -> np.ndarray:
        return self(np.asarray(ts, dtype=np.float64))

    def __repr__(self):
        return f"PPoly(n_pieces={self.n_pieces}, degree={self.degree}, t0={self.starts[0]:g})"


# --------------------------------------------------------------------------
# helpers for minimum / composition
# --------------------------------------------------------------------------

def _min2(f: PPoly, fseg: list, g: PPoly, g_idx: int):
    """min(f, g) where ``fseg`` carries f's existing argmin attribution."""
    s0 = max(float(f.starts[0]), float(g.starts[0]))
    a, b = f.restrict(s0), g.restrict(s0)
    merged = np.union1d(a.starts, b.starts)
    keep = [0]
    for i in range(1, len(merged)):
        if merged[i] - merged[keep[-1]] > TIME_TOL:
            keep.append(i)
    merged = list(merged[keep])
    # split further at interior roots of (a - b)
    diff = a._binary(b, lambda x, y: x - y)
    cut: list[float] = []
    for i in range(diff.n_pieces):
        s = float(diff.starts[i])
        e = diff.piece_end(i)
        hi = e - s if np.isfinite(e) else _INF
        for r in poly_real_roots(diff.coeffs[i], 0.0, hi):
            if r > TIME_TOL:
                cut.append(s + r)
    # f's attribution switches too: simplify() may have merged f's pieces
    # across a switch, and a g that ties f over the span would hide it
    switches = [float(ss) for ss, _ in fseg if ss > s0]
    allpts = sorted(set(merged) | set(cut) | set(switches))
    pts: list[float] = []
    for p in allpts:
        if not pts or p - pts[-1] > TIME_TOL:
            pts.append(p)
    starts, coeffs, seg = [], [], []

    def f_attr(t: float) -> int:
        lab = fseg[0][1]
        for (ss, ll) in fseg:
            if ss <= t + TIME_TOL:
                lab = ll
            else:
                break
        return lab

    prev_who = None
    for j, s in enumerate(pts):
        e = pts[j + 1] if j + 1 < len(pts) else _INF
        mid = s + (min(e, s + 1.0) - s) * 0.5 if np.isfinite(e) else s + 0.5
        va, vb = a(mid), b(mid)
        tol = VAL_RTOL * max(1.0, abs(va), abs(vb))
        use_a = va <= vb + tol
        ia = a.piece_index(s)
        ib = b.piece_index(s)
        c = poly_shift(a.coeffs[ia], s - a.starts[ia]) if use_a else poly_shift(b.coeffs[ib], s - b.starts[ib])
        who = f_attr(mid) if use_a else g_idx
        # also compare right values at s itself (jumps): right-continuity must
        # pick the min of right values
        va_s, vb_s = a(s), b(s)
        if use_a and vb_s < va_s - tol:
            c = poly_shift(b.coeffs[ib], s - b.starts[ib])
            who = g_idx
        elif (not use_a) and va_s < vb_s - tol:
            c = poly_shift(a.coeffs[ia], s - a.starts[ia])
            who = f_attr(mid)
        starts.append(s)
        coeffs.append(c)
        if prev_who is None or who != prev_who:
            seg.append((s, who))
            prev_who = who
    m = PPoly(np.array(starts), coeffs).simplify()
    return m, seg


def inner_crossings(inner: PPoly, level: float) -> list[float]:
    """All t where monotone ``inner`` first meets ``level`` inside each piece."""
    out: list[float] = []
    for i in range(inner.n_pieces):
        s = float(inner.starts[i])
        e = inner.piece_end(i)
        hi = (e - s) if np.isfinite(e) else _INF
        c = inner.coeffs[i].copy()
        c[0] -= level
        for r in poly_real_roots(c, 0.0, hi):
            out.append(s + r)
    return out
