"""Progress-function solvers — BottleMod Sect. 3 & 4.

Three solvers are provided:

* :func:`solve` — the production solver: an exact, event-driven
  implementation of the paper's **Algorithm 2**.  It advances only at the
  discrete points where a piece boundary or the limiting factor changes
  ("quasi-symbolic discrete-event" evaluation), so its runtime is independent
  of the amount of data moved — the paper's central performance claim.

* :func:`solve_euler` — forward-Euler direct integration of the progress
  dynamics ``P'(t) = min(ceiling-following, min_l I_Rl(t)/R'_Rl(P(t)))`` on a
  dense grid.  Used as the *numeric oracle* for property tests.

* :func:`solve_alg1` — the paper's generic **Algorithm 1** (iterative
  speedup-correction fixed point, eq. (5)/(6)) realized on a dense grid;
  demonstrably converges to the same fixed point as the other two.

The event-driven solver supports everything Sect. 2 allows: arbitrary
monotone piecewise-polynomial data requirements / data inputs (jumps = burst
behaviour), piecewise-linear resource requirements with jumps (burst
resources that stall progress until absorbed), and arbitrary
piecewise-polynomial resource rate inputs (including rate 0 = starvation).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ppoly import PPoly, TIME_TOL, poly_eval, poly_real_roots, poly_shift
from .process import Process

_INF = float("inf")

#: label constants for bottleneck attribution
DATA = "data"
RESOURCE = "resource"


@dataclass
class Segment:
    """One maximal time interval with a single limiting factor."""

    t_start: float
    t_end: float
    kind: str  # DATA | RESOURCE
    name: str  # which data input / resource limits progress here


@dataclass
class ProgressResult:
    """Result of analyzing one process (paper Sect. 3.3)."""

    process: Process
    progress: PPoly                    # P(t)
    data_progress: PPoly               # P_D(t) (eq. 2)
    finish_time: float                 # first t with P(t) >= p_end (inf if never)
    t_start: float
    segments: list[Segment] = field(default_factory=list)
    data_inputs: dict[str, PPoly] = field(default_factory=dict)
    resource_inputs: dict[str, PPoly] = field(default_factory=dict)
    iterations: int = 0                # event count (performance accounting)

    # -- Sect. 3.3.1: resource usage ---------------------------------------
    def resource_usage(self, name: str, ts: np.ndarray) -> np.ndarray:
        """``P'(t) * R'_Rl(P(t))`` (eq. 4) sampled at ``ts``."""
        dP = self.progress.derivative()
        dR = self.process.resources[name].requirement.derivative()
        return dP(ts) * dR(self.progress(ts))

    def relative_resource_usage(self, name: str, ts: np.ndarray) -> np.ndarray:
        """eq. (7): fraction of the allocated resource actually used."""
        use = self.resource_usage(name, ts)
        alloc = self.resource_inputs[name](ts)
        out = np.full_like(use, np.nan)
        nz = alloc > 0
        out[nz] = use[nz] / alloc[nz]
        out[~nz & (use <= 0)] = 0.0
        return out

    # -- Sect. 3.3.2: buffered data -----------------------------------------
    def buffered_data(self, name: str, ts: np.ndarray) -> np.ndarray:
        """eq. (8): ``I_Dk(t) - R_Dk^{-1}(P(t))`` — provided but unused data."""
        have = self.data_inputs[name](ts)
        consumed = self.process.data[name].requirement.inv_at(self.progress(ts))
        return have - consumed

    # -- Sect. 3.4: chaining ---------------------------------------------------
    def output_function(self, name: str = "out") -> PPoly:
        """``O_m(P(t))`` — usable as the data input of a successor process."""
        return PPoly.compose(self.process.outputs[name], self.progress)

    def bottleneck_at(self, t: float) -> Segment | None:
        for s in self.segments:
            if s.t_start - TIME_TOL <= t < s.t_end:
                return s
        return self.segments[-1] if self.segments and t >= self.segments[-1].t_start else None


# ==========================================================================
# Event-driven exact solver (Algorithm 2)
# ==========================================================================

MAX_EVENTS = 200_000


def _data_ceiling(process: Process, data_inputs: dict[str, PPoly], t0: float):
    """P_D = min_k R_Dk(I_Dk(t)) with argmin attribution (eq. 1–2)."""
    names = list(process.data.keys())
    if not names:
        return PPoly.constant(process.total_progress, t0), [(t0, -1)], names
    fns = []
    for k in names:
        pk = PPoly.compose(process.data[k].requirement, data_inputs[k].restrict(t0))
        fns.append(pk)
    pd, seg = PPoly.minimum(fns)
    return pd, seg, names


def solve(
    process: Process,
    data_inputs: dict[str, PPoly],
    resource_inputs: dict[str, PPoly],
    t0: float = 0.0,
) -> ProgressResult:
    """Exact event-driven solve (paper Algorithm 2, generalized)."""
    p_end = float(process.total_progress)
    pd, pd_seg, data_names = _data_ceiling(process, data_inputs, t0)

    res_names = list(process.resources.keys())
    R = {l: process.resources[l].requirement for l in res_names}
    dR = {l: R[l].derivative() for l in res_names}
    IR = {l: resource_inputs[l].restrict(t0) if resource_inputs[l].starts[0] < t0 else resource_inputs[l] for l in res_names}

    starts: list[float] = []
    coeffs: list[np.ndarray] = []
    raw_seg: list[tuple[float, str, str]] = []  # (t, kind, name)

    def data_attr(t: float) -> str:
        lab = pd_seg[0][1]
        for (ss, ll) in pd_seg:
            if ss <= t + TIME_TOL:
                lab = ll
            else:
                break
        return data_names[lab] if lab >= 0 else "<none>"

    def append_piece(s: float, c: np.ndarray, kind: str, name: str):
        if starts and s <= starts[-1] + TIME_TOL:
            # zero-width: replace
            starts[-1] = s if not starts else starts[-1]
            coeffs[-1] = c
        else:
            starts.append(s)
            coeffs.append(np.asarray(c, dtype=np.float64))
        if not raw_seg or raw_seg[-1][1:] != (kind, name):
            raw_seg.append((starts[-1], kind, name))

    t = float(t0)
    p = 0.0
    finish = _INF
    iters = 0
    ptol = 1e-9 * max(1.0, p_end)
    absorbed: set[tuple[str, int]] = set()  # burst jumps already paid for

    while p < p_end - 1e-9 * max(1.0, p_end) and iters < MAX_EVENTS:
        iters += 1
        pd_right = float(pd(t))
        pd_i = pd.piece_index(t)
        pd_piece_end = pd.piece_end(pd_i)

        # ---- per-resource slope caps on the current window ------------------
        slope_polys: list[PPoly] = []
        slope_names: list[str] = []
        window_end = pd_piece_end
        p_breaks: list[tuple[float, str, float, int]] = []  # (p_break, resource, jump, idx)
        for l in res_names:
            # evaluate the marginal requirement consistently with the
            # breakpoint scan below: a zero-jump breakpoint within ptol of p
            # counts as passed, so the slope must be the post-breakpoint one
            # (p can land a float-epsilon below a breakpoint whose scale far
            # exceeds the absolute TIME_TOL used by piece selection).
            cl = float(dR[l](p + ptol))
            # next unabsorbed progress breakpoint of R_Rl at/above p
            rs = R[l].starts
            j = int(np.searchsorted(rs, p - ptol, side="left"))
            while j < len(rs):
                pb = float(rs[j])
                jump = max(float(R[l](pb)) - float(R[l].value_left(pb)), 0.0)
                if pb < p - ptol or ((l, j) in absorbed) or (jump <= 0.0 and pb <= p + ptol):
                    j += 1
                    continue
                p_breaks.append((pb, l, jump, j))
                break
            ii = IR[l].piece_index(t)
            window_end = min(window_end, IR[l].piece_end(ii))
            if cl <= 0.0:
                continue  # resource not needed at this progress -> no cap
            local = poly_shift(IR[l].coeffs[ii], t - IR[l].starts[ii]) / cl
            slope_polys.append(PPoly(np.array([t]), [local]))
            slope_names.append(l)

        if slope_polys:
            smin, smin_seg = PPoly.minimum(slope_polys)
        else:
            smin, smin_seg = None, []

        # ---- unconstrained: jump instantly to the data ceiling -------------
        if smin is None:
            tol_p = 1e-12 * max(1.0, p_end)
            if p < pd_right - tol_p:
                # the jump up may be blocked by a burst-resource requirement
                blocking = sorted(b for b in p_breaks if b[2] > 0 and p + tol_p < b[0] <= pd_right + tol_p)
                if blocking:
                    p = blocking[0][0]
                    st = _stall_time(p, ptol, p_breaks, IR, t, absorbed)
                    if st is None or not np.isfinite(st[0]):
                        append_piece(t, np.array([p]), RESOURCE, blocking[0][1])
                        break  # starved forever
                    append_piece(t, np.array([p]), RESOURCE, st[1])
                    t = st[0]
                    continue
                p = pd_right
                if p >= p_end - 1e-9 * max(1.0, p_end):
                    finish = t
                    append_piece(t, np.array([p]), DATA, data_attr(t))
                    break
            # stalled exactly on a burst-resource jump?
            st = _stall_time(p, ptol, p_breaks, IR, t, absorbed)
            if st is not None:
                if not np.isfinite(st[0]):
                    append_piece(t, np.array([p]), RESOURCE, st[1])
                    break
                append_piece(t, np.array([p]), RESOURCE, st[1])
                t = st[0]
                continue
            # follow the ceiling piece, stopping at any burst-resource jump
            cpd = poly_shift(pd.coeffs[pd_i], t - pd.starts[pd_i])
            events = [pd_piece_end]
            for (pb, l, jump, _j) in p_breaks:
                if jump > 0:
                    tt = pd.first_time_at_or_above(pb, t)
                    if tt > t + TIME_TOL:
                        events.append(tt)
            t_fin = pd.first_time_at_or_above(p_end, t)
            events.append(t_fin)
            finite = [e for e in events if np.isfinite(e) and e > t + TIME_TOL]
            t_next = min(finite) if finite else _INF
            append_piece(t, cpd, DATA, data_attr(t))
            if np.isfinite(t_fin) and t_fin <= t_next + TIME_TOL:
                finish = t_fin
                break
            if not np.isfinite(t_next):
                break
            p = float(pd.value_left(t_next))
            t = t_next
            continue

        s_now = float(smin(t))
        cpd_local = poly_shift(pd.coeffs[pd_i], t - pd.starts[pd_i])
        dpd_local = _poly_deriv(cpd_local)
        pd_deriv_now = float(poly_eval(dpd_local, 0.0))
        on_ceiling = p >= pd_right - 1e-9 * max(1.0, p_end)

        data_lim = on_ceiling and pd_deriv_now <= s_now + 1e-12 * max(1.0, s_now)
        if data_lim and abs(pd_deriv_now - s_now) <= 1e-9 * max(1.0, abs(s_now)):
            # tangency tie-break (possible only with non-constant rate caps
            # or curved ceilings): at cap == ceiling-slope the instantaneous
            # comparison is blind — the rate that is LOWER just after t
            # governs, so compare the derivatives of the two rates
            i_s = smin.piece_index(t)
            s_rate = float(poly_eval(_poly_deriv(poly_shift(
                smin.coeffs[i_s], t - smin.starts[i_s])), 0.0))
            pdd_now = float(poly_eval(_poly_deriv(dpd_local), 0.0))
            if s_rate < pdd_now - 1e-12 * max(1.0, abs(pdd_now)):
                data_lim = False

        if data_lim:
            # ================= data-limited: follow P_D ======================
            events = [pd_piece_end, window_end]
            # resource becomes binding: first root of (smin - pd') in (t, ..)
            dpd = _poly_deriv(cpd_local)
            for sp, sl in zip(slope_polys, slope_names):
                diffc = _poly_sub(sp.coeffs[0], dpd)
                for r in poly_real_roots(diffc, 0.0, (min(pd_piece_end, window_end) - t) if np.isfinite(min(pd_piece_end, window_end)) else _INF):
                    if r > TIME_TOL:
                        events.append(t + r)
                        break
            # progress crossing a resource-requirement breakpoint
            for (pb, l, jump, _j) in p_breaks:
                tt = pd.first_time_at_or_above(pb, t)
                if tt > t + TIME_TOL or (jump > 0 and tt >= t):
                    events.append(max(tt, t))
            # completion must happen *within the continuous piece* — P cannot
            # follow an upward jump of P_D without resources to match it.
            ccf = cpd_local.copy()
            ccf[0] -= p_end
            hi_local = (min(pd_piece_end, window_end) - t) if np.isfinite(min(pd_piece_end, window_end)) else _INF
            rts = poly_real_roots(ccf, 0.0, hi_local + TIME_TOL if np.isfinite(hi_local) else _INF)
            t_fin = (t + rts[0]) if rts else (_INF if not (abs(float(poly_eval(cpd_local, 0.0)) - p_end) <= 1e-9 * max(1.0, p_end)) else t)
            events.append(t_fin)
            t_next = min(e for e in events if e > t + TIME_TOL) if any(np.isfinite(e) and e > t + TIME_TOL for e in events) else _INF
            # burst-resource stall exactly at t?
            stall = _stall_time(p, ptol, p_breaks, IR, t, absorbed)
            if stall is not None:
                t_stall_end, l_stall = stall
                append_piece(t, np.array([p]), RESOURCE, l_stall)
                t = t_stall_end
                continue
            append_piece(t, cpd_local, DATA, data_attr(t))
            if t_fin <= t_next + TIME_TOL and np.isfinite(t_fin):
                finish = t_fin
                break
            if not np.isfinite(t_next):
                break
            p = float(pd.value_left(t_next))
            t = t_next
            continue

        # ================= resource-limited: integrate min slope ============
        # burst stall first (progress pinned at a jump of some R_Rl)
        stall = _stall_time(p, ptol, p_breaks, IR, t, absorbed)
        if stall is not None:
            t_stall_end, l_stall = stall
            append_piece(t, np.array([p]), RESOURCE, l_stall)
            t = t_stall_end
            continue

        curve = smin.antiderivative(p)  # anchored at t with value p
        bound = min(window_end, pd_piece_end)
        events = [window_end, pd_piece_end]
        # hit the data ceiling
        t_hit = _first_meet(pd, curve, t, bound)
        if t_hit is not None:
            events.append(t_hit)
        # reach a resource-requirement breakpoint
        t_pb_best, pb_hit = _INF, None
        for (pb, l, jump, _j) in p_breaks:
            tt = curve.first_time_at_or_above(pb, t)
            if tt < t_pb_best:
                t_pb_best, pb_hit = tt, (pb, l, jump)
        events.append(t_pb_best)
        # completion
        t_fin = curve.first_time_at_or_above(p_end, t)
        events.append(t_fin)
        finite = [e for e in events if np.isfinite(e) and e > t + TIME_TOL]
        t_next = min(finite) if finite else _INF

        # append curve pieces with attribution from smin argmin
        _append_curve(append_piece, curve, smin_seg, slope_names, t, t_next)
        if np.isfinite(t_fin) and t_fin <= t_next + TIME_TOL:
            finish = t_fin
            break
        if not np.isfinite(t_next):
            break
        p = float(curve.value_left(t_next)) if np.isfinite(t_next) else p
        # never exceed the ceiling (numeric guard)
        p = min(p, float(pd.value_left(t_next)))
        t = t_next

    if p >= p_end - 1e-9 * max(1.0, p_end) and not np.isfinite(finish):
        finish = t  # completion reached exactly at a piece boundary
    if not starts:
        append_piece(t0, np.array([0.0]), DATA, data_attr(t0))
    P = PPoly(np.array(starts), coeffs)
    if np.isfinite(finish):
        # a finished process holds at p_end (progress is capped — Sect. 3)
        kept_s = [s for s in P.starts if s < finish - TIME_TOL]
        kept_c = [P.coeffs[i] for i in range(len(kept_s))]
        kept_s.append(finish)
        kept_c.append(np.array([p_end]))
        P = PPoly(np.array(kept_s), kept_c) if kept_s[0] <= finish else PPoly(np.array([finish]), [np.array([p_end])])
    segs: list[Segment] = []
    for i, (s, kind, name) in enumerate(raw_seg):
        e = raw_seg[i + 1][0] if i + 1 < len(raw_seg) else (finish if np.isfinite(finish) else _INF)
        segs.append(Segment(s, e, kind, name))
    return ProgressResult(
        process=process,
        progress=P,
        data_progress=pd,
        finish_time=finish,
        t_start=t0,
        segments=segs,
        data_inputs={k: v for k, v in data_inputs.items()},
        resource_inputs={k: v for k, v in resource_inputs.items()},
        iterations=iters,
    )


def _poly_deriv(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float64)
    if len(c) == 1:
        return np.array([0.0])
    return c[1:] * np.arange(1, len(c))


def _poly_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    k = max(len(a), len(b))
    out = np.zeros(k)
    out[: len(a)] += a
    out[: len(b)] -= b
    return out


def _first_meet(upper: PPoly, lower: PPoly, t: float, bound: float):
    """First τ in (t, bound) where ``lower`` catches ``upper`` (diff -> 0)."""
    hi = bound if np.isfinite(bound) else t + 1e30
    i_u = upper.piece_index(t)
    cu = poly_shift(upper.coeffs[i_u], t - upper.starts[i_u])
    # lower may have several pieces in (t, bound)
    j = lower.piece_index(t)
    while j < lower.n_pieces:
        s = max(float(lower.starts[j]), t)
        e = min(lower.piece_end(j), hi)
        if s >= hi:
            break
        cl = poly_shift(lower.coeffs[j], s - lower.starts[j])
        cu_s = poly_shift(cu, s - t)
        diff = _poly_sub(cu_s, cl)
        roots = poly_real_roots(diff, 0.0, (e - s) if np.isfinite(e) else _INF)
        for r in roots:
            if r > TIME_TOL:
                return s + r
        j += 1
        if not np.isfinite(e) or e >= hi:
            break
    return None


def _stall_time(p, ptol, p_breaks, IR, t, absorbed):
    """If progress is pinned at a burst jump of some resource requirement,
    absorb the jump: returns (stall_end, resource_name) — the time until the
    jump amounts are paid for by the allocated resource rates (paper
    Fig. 1(b) 'burst').  Matched jumps are added to ``absorbed``."""
    best = None
    hits = []
    for (pb, l, jump, j) in p_breaks:
        if jump <= 0.0 or (l, j) in absorbed:
            continue
        if abs(pb - p) > ptol:
            continue
        hits.append((l, j))
        # absorb `jump` of resource l starting at t
        F = IR[l].restrict(t).antiderivative(0.0)
        te = F.first_time_at_or_above(jump, t)
        if best is None or te > best[0]:
            best = (te, l)
    for h in hits:
        absorbed.add(h)
    return best


def _append_curve(append_piece, curve: PPoly, smin_seg, slope_names, t, t_next):
    hi = t_next if np.isfinite(t_next) else _INF

    def attr(tt: float) -> str:
        lab = smin_seg[0][1] if smin_seg else 0
        for (ss, ll) in smin_seg:
            if ss <= tt + TIME_TOL:
                lab = ll
            else:
                break
        return slope_names[lab]

    for i in range(curve.n_pieces):
        s = float(curve.starts[i])
        if s >= hi:
            break
        if curve.piece_end(i) <= t + TIME_TOL:
            continue
        s_eff = max(s, t)
        c = poly_shift(curve.coeffs[i], s_eff - s)
        append_piece(s_eff, c, RESOURCE, attr(s_eff))


# ==========================================================================
# Numeric oracle (forward Euler) and the paper's Algorithm 1 on a grid
# ==========================================================================

def solve_euler(
    process: Process,
    data_inputs: dict[str, PPoly],
    resource_inputs: dict[str, PPoly],
    t0: float = 0.0,
    t_end: float = 1e4,
    dt: float = 1e-3,
):
    """Forward-Euler reference (continuous piecewise-linear R_R only)."""
    pd, _, _ = _data_ceiling(process, data_inputs, t0)
    res = list(process.resources.keys())
    dR = {l: process.resources[l].requirement.derivative() for l in res}
    IR = {l: resource_inputs[l] for l in res}
    n = int(np.ceil((t_end - t0) / dt)) + 1
    ts = t0 + np.arange(n) * dt
    pd_s = pd(ts)
    ir_s = {l: IR[l](ts) for l in res}
    p = 0.0
    ps = np.zeros(n)
    finish = _INF
    p_endv = float(process.total_progress)
    for i in range(n - 1):
        ps[i] = p
        if p >= p_endv - 1e-9 * max(1.0, p_endv):
            if not np.isfinite(finish):
                finish = ts[i]
            ps[i:] = p
            break
        smin = _INF
        p_q = min(p, p_endv - max(1e-7 * p_endv, 1e-7))  # left-limit slope at completion
        for l in res:
            cl = float(dR[l](p_q))
            if cl > 0:
                smin = min(smin, ir_s[l][i] / cl)
        if smin is _INF or not np.isfinite(smin):
            p_new = pd_s[i + 1]
        else:
            p_new = min(pd_s[i + 1], p + dt * smin)
        p = max(p, p_new)
    else:
        ps[-1] = p
    if not np.isfinite(finish) and p >= p_endv - 1e-9 * max(1.0, p_endv):
        finish = ts[-1]
    return ts, ps, finish


def solve_alg1(
    process: Process,
    data_inputs: dict[str, PPoly],
    resource_inputs: dict[str, PPoly],
    t0: float = 0.0,
    t_end: float = 1e4,
    dt: float = 1e-3,
    max_iter: int = 50,
):
    """The paper's Algorithm 1 (iterative eq. (5)/(6) fixed point) on a grid.

    Returns (ts, P, n_iterations_until_stable).
    """
    pd, _, _ = _data_ceiling(process, data_inputs, t0)
    res = list(process.resources.keys())
    dR = {l: process.resources[l].requirement.derivative() for l in res}
    n = int(np.ceil((t_end - t0) / dt)) + 1
    ts = t0 + np.arange(n) * dt
    pd_s = pd(ts)
    ir_s = {l: resource_inputs[l](ts) for l in res}

    # eq. (5)/(6) iterate.  Two observations make the grid version exact:
    # (1) P'·S_Rl = I_Rl/R'_Rl(P), independent of P' — the same cancellation
    #     the paper performs in eq. (9) — so each sweep integrates the
    #     resource-capped rate evaluated at the *previous* iterate's progress.
    # (2) the paper anchors each correction at t_x (progress is "assumed
    #     correct up to t_x"); integrating forward from each binding point is
    #     the min-plus recurrence  P[i+1] = min(P_D[i+1], P[i] + r[i]·dt),
    #     whose closed form  P[i] = C[i] + min_{j<=i}(anchor[j] - C[j]) with
    #     C = cumsum(r·dt) vectorizes with a running minimum.
    # Iteration is then over the progress argument of R'_Rl only, and stops
    # when P is stable — exactly Algorithm 1's termination condition.
    big = float(np.max(pd_s) + 1.0) / dt  # "infinite" slope: ceiling in one step
    P = pd_s.copy()
    it = 0
    prev_delta = _INF
    for it in range(1, max_iter + 1):
        rate = np.full(n, _INF)
        # evaluate requirement slopes just below completion: the flat
        # extension beyond p_end has derivative 0 and would otherwise create
        # a spurious "free progress" fixed point at the ceiling.
        pe = float(process.total_progress)
        P_q = np.minimum(P, pe - max(1e-7 * pe, 1e-7))
        for l in res:
            cl = dR[l](P_q)
            with np.errstate(divide="ignore", invalid="ignore"):
                s = np.where(cl > 0, ir_s[l] / np.where(cl > 0, cl, 1.0), _INF)
            rate = np.minimum(rate, s)
        r = np.where(np.isfinite(rate), rate, big)
        C = np.concatenate([[0.0], np.cumsum(r[:-1]) * dt])
        anchor = np.minimum(pd_s, np.concatenate([[0.0], np.full(n - 1, _INF)]))
        Pn = C + np.minimum.accumulate(anchor - C)
        Pn = np.maximum.accumulate(np.minimum(Pn, pd_s))
        delta = float(np.max(np.abs(Pn - P)))
        if delta <= 1e-6 * max(1.0, float(np.max(np.abs(P)))):
            P = Pn
            break
        # The paper's exact variant guarantees progress via the t_x anchor;
        # on a fixed grid the discretized rate can 2-cycle across an R'_Rl
        # piece boundary — damp the update when the residual stalls.
        if delta >= prev_delta * 0.9:
            Pn = np.maximum.accumulate(np.minimum(0.5 * (P + Pn), pd_s))
        prev_delta = delta
        P = Pn
    return ts, P, it
