"""Batched event-driven solver — Algorithm 2 in lockstep over B scenarios.

The scalar solver (:func:`repro_torch.core.solver.solve`) advances one process of
one scenario event by event.  This engine advances *every scenario of a
sweep* one event per iteration: all state is ``(B,)``-shaped, every event
time is a closed form (the function class is piecewise-quadratic, see
:mod:`.plin` — piecewise-linear resource inputs make progress pieces
quadratic, and every event reduces to the stable quadratic formula in
:func:`repro_torch.core.ppoly.first_pos_root`), and each iteration is a handful of
vectorized numpy ops.  The Python-loop trip count is the *maximum* event
count over the batch (tens), not ``B × events`` — which is where the
>5x-per-scenario speedup over the looped scalar solver comes from.

Purely piecewise-linear sweeps (constant resource rates) take the exact
pre-quadratic code path: the ``ramp`` flag below gates every widened
formula, so the legacy class pays nothing for degree-2 support.

The event logic mirrors ``core.solver.solve`` case for case (unconstrained
ceiling-jumps, burst-resource stalls, data-limited ceiling following,
resource-limited minimum-slope integration, starvation) so per-scenario
results agree with the scalar solver to float tolerance — asserted by the
test suite.

This module is the REFERENCE backend: :mod:`.torch_engine` transcribes the
same loop into level-stacked float64 torch tensor ops and is pinned against
it by ``tests/test_torch_engine.py``.  Semantic changes here
(event cases, tolerances, record/attribution layout) must be mirrored there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ppoly import TIME_TOL, VAL_RTOL, first_pos_root
from repro_torch.core.process import Process

from repro_torch.kernels.ppoly_eval.ref import PAD_START

from .plin import BPL, UnsupportedScenario, compose_scalar

_INF = float("inf")

#: safety cap on lockstep iterations (events per scenario are typically tens)
MAX_LOCKSTEP_ITERS = 20_000


@dataclass
class BatchProcResult:
    """Batched analogue of :class:`repro_torch.core.solver.ProgressResult`."""

    name: str
    p_end: float
    t_start: np.ndarray                 # (B,)
    finish: np.ndarray                  # (B,) inf where never finishing
    progress: BPL                       # capped at p_end after finish
    ceilings: list[BPL]                 # per data dep: R_Dk(I_Dk(t))
    factor_kinds: list[str]             # len K+L
    factor_names: list[str]             # len K+L
    share_seconds: np.ndarray           # (B, K+L)
    iterations: int = 0

    def share_fractions(self) -> np.ndarray:
        """Fraction of each scenario's process runtime per limiting factor."""
        fin = np.where(np.isfinite(self.finish), self.finish,
                       self.t_start + self.share_seconds.sum(1))
        total = np.maximum(fin - self.t_start, 1e-12)
        return self.share_seconds / total[:, None]

    def nan_mask(self) -> np.ndarray:
        """(B,) bool: rows whose finish time is NaN — unambiguous engine
        garbage (``inf`` is a legitimate "never finishes"; NaN never is).
        Surfaces per-process on the engine result so the serving tier's
        degradation guard and the chaos tests can attribute garbage rows
        without re-deriving them from the merged report."""
        return np.isnan(self.finish)


def _res_tables(proc: Process):
    """Static per-resource tables: breakpoints, slopes, jump magnitudes."""
    tables = []
    for l, dep in proc.resources.items():
        R = dep.requirement
        if R.coeffs.shape[1] > 2:
            raise UnsupportedScenario("resource requirements must be pw-linear")
        rb = R.starts.astype(np.float64)
        rc1 = R.coeffs[:, 1] if R.coeffs.shape[1] > 1 else np.zeros(len(rb))
        jumps = np.array([max(float(R(b)) - float(R.value_left(b)), 0.0)
                          for b in rb])
        jumps[0] = 0.0
        tables.append((l, rb, rc1.astype(np.float64), jumps))
    return tables


def solve_batch(proc: Process, data_bpls: dict[str, BPL],
                res_bpls: dict[str, BPL], t0: np.ndarray, *,
                res_tables: list | None = None,
                ceilings: dict[str, BPL] | None = None) -> BatchProcResult:
    """Solve one process for all B scenarios in lockstep.

    ``res_tables`` and ``ceilings`` let a compiled plan
    (:class:`repro_torch.analysis.plan.CompiledWorkflow`) pass in the static
    requirement tables and pre-composed data ceilings it derived once at
    compile time; both default to being derived here per call.
    """
    B = len(t0)
    p_end = float(proc.total_progress)
    data_names = list(proc.data.keys())
    K = len(data_names)
    if res_tables is None:
        res_tables = _res_tables(proc)
    res_names = [l for (l, *_rest) in res_tables]
    L = len(res_names)

    # data ceilings P_Dk = R_Dk(I_Dk(t))  (eq. 1), batched composition —
    # unless the caller pre-composed them (plan cache)
    ceilings = ceilings or {}
    if K:
        ceils = [ceilings[k] if k in ceilings else
                 compose_scalar(proc.data[k].requirement, data_bpls[k])
                 for k in data_names]
    else:
        ceils = [BPL.constant(np.full(B, p_end), t0)]

    IR = [res_bpls[l] for l in res_names]
    for l, bpl in zip(res_names, IR):
        if bpl.max_degree() > 1:
            raise UnsupportedScenario(
                f"resource input {l!r} must be piecewise-linear for the "
                "batched engine (use the loop backend for richer inputs)")
    # ramped resources (or quadratic incoming ceilings from a ramped
    # upstream process) switch every event formula to the quadratic branch;
    # the purely-linear class keeps the exact legacy arithmetic
    ramp = (any(bpl.max_degree() > 0 for bpl in IR)
            or any(c.max_degree() > 1 for c in ceils))
    A = [bpl.antiderivative() for bpl in IR]
    absorbed = [np.zeros((B, len(rb)), bool) for (_l, rb, _c, _j) in res_tables]

    t = t0.astype(np.float64).copy()
    p = np.zeros(B)
    finish = np.full(B, _INF)
    active = np.ones(B, bool)
    ptol = 1e-9 * max(1.0, p_end)
    ftol = 1e-9 * max(1.0, p_end)
    jtol = 1e-12 * max(1.0, p_end)
    arangeB = np.arange(B)

    # recorded pieces: one slot per iteration, (B,) columns
    rec_t: list[np.ndarray] = []
    rec_c0: list[np.ndarray] = []
    rec_c1: list[np.ndarray] = []
    rec_c2: list[np.ndarray] = []
    rec_attr: list[np.ndarray] = []
    rec_mask: list[np.ndarray] = []
    _zeros = np.zeros(B)

    def record(mask, ts, c0s, c1s, attrs, c2s=_zeros):
        rec_t.append(np.where(mask, ts, 0.0))
        rec_c0.append(np.where(mask, c0s, 0.0))
        rec_c1.append(np.where(mask, c1s, 0.0))
        rec_c2.append(np.where(mask, c2s, 0.0))
        rec_attr.append(np.where(mask, attrs, -1).astype(np.int64))
        rec_mask.append(mask.copy())

    it = 0
    for it in range(1, MAX_LOCKSTEP_ITERS + 1):
        act = active & (p < p_end - ftol)
        if not act.any():
            break

        # ---- ceilings at t (right values/slopes + attribution) -------------
        if ramp:
            VSQ = [c.eval_slope_quad_right(t) for c in ceils]
            V = np.stack([x[0] for x in VSQ])                    # (nC, B)
            S = np.stack([x[1] for x in VSQ])
            Qc = np.stack([x[2] for x in VSQ])
            # ties on value break on slope, then curvature (the function that
            # is lower just after t governs the piece — the scalar minimum's
            # midpoint rule, resolved one derivative at a time)
            vtie = V <= V.min(0) + VAL_RTOL * np.maximum(1.0, np.abs(V.min(0)))
            St = np.where(vtie, S, _INF)
            Smin = St.min(0)
            stie = vtie & (St <= Smin + VAL_RTOL * np.maximum(1.0, np.abs(Smin)))
            kstar = np.where(stie, Qc, _INF).argmin(0)
        else:
            V = np.stack([c.eval_right(t) for c in ceils])       # (nC, B)
            S = np.stack([c.slope_right(t) for c in ceils])
            Qc = None
            kstar = V.argmin(0)                                  # ties -> low k
        pd = V[kstar, arangeB]
        pdslope = S[kstar, arangeB]
        pdq = Qc[kstar, arangeB] if ramp else _zeros
        tb_ceil = np.min(np.stack([c.next_break_after(t) for c in ceils]), 0)

        # ---- resource caps and next requirement breakpoints ----------------
        caps = np.full((max(L, 1), B), _INF)
        caps1 = np.zeros((max(L, 1), B))       # cap time-derivative (ramped)
        pb = np.full((L, B), _INF) if L else np.zeros((0, B))
        pjump = np.zeros((L, B))
        pbidx = np.zeros((L, B), np.int64)
        tb_ir = np.full(B, _INF)
        for li, (l, rb, rc1, jumps) in enumerate(res_tables):
            if ramp:
                r_now, r_sl, _ = IR[li].eval_slope_quad_right(t)
            else:
                r_now = IR[li].eval_right(t)
            tb_ir = np.minimum(tb_ir, IR[li].next_break_after(t))
            # ptol (not TIME_TOL): consistent with the breakpoint scan below —
            # a zero-jump breakpoint within ptol of p counts as passed, so the
            # marginal requirement must be the post-breakpoint slope
            ri = np.maximum(np.searchsorted(rb, p + ptol, side="right") - 1, 0)
            cl = rc1[ri]
            with np.errstate(divide="ignore", invalid="ignore"):
                caps[li] = np.where(cl > 0, r_now / np.where(cl > 0, cl, 1.0), _INF)
                if ramp:
                    caps1[li] = np.where(cl > 0, r_sl / np.where(cl > 0, cl, 1.0), 0.0)
            # first qualifying breakpoint at/above p (mirrors the scalar scan)
            cond = ((rb[None, :] >= p[:, None] - ptol) & ~absorbed[li]
                    & ((jumps[None, :] > 0) | (rb[None, :] > p[:, None] + ptol)))
            has = cond.any(1)
            j = cond.argmax(1)
            pb[li] = np.where(has, rb[j], _INF)
            pjump[li] = np.where(has, jumps[j], 0.0)
            pbidx[li] = j
        if not L:
            smin = np.full(B, _INF)
            lstar = np.zeros(B, np.int64)
            smin1 = _zeros
        elif ramp:
            smin = caps.min(0)
            # value ties break on the cap's time-derivative: the cap that is
            # lower just after t governs the motion
            ctie = caps <= smin + VAL_RTOL * np.maximum(
                1.0, np.abs(np.where(np.isfinite(smin), smin, 1.0)))
            lstar = np.where(ctie, caps1, _INF).argmin(0)
            smin1 = np.where(np.isfinite(smin), caps1[lstar, arangeB], 0.0)
        else:
            smin = caps.min(0)
            lstar = caps.argmin(0)
            smin1 = _zeros

        # ---- unconstrained: jump instantly toward the data ceiling ---------
        uncon = act & ~np.isfinite(smin) & (p < pd - jtol)
        if uncon.any():
            blk = np.where((pjump > 0) & (pb > p[None] + jtol)
                           & (pb <= pd[None] + jtol), pb, _INF)
            blk_pb = blk.min(0) if L else np.full(B, _INF)
            target = np.where(np.isfinite(blk_pb), blk_pb, pd)
            p = np.where(uncon, target, p)
            fin_jump = uncon & ~np.isfinite(blk_pb) & (p >= p_end - ftol)
            finish = np.where(fin_jump, t, finish)
            active &= ~fin_jump
            act &= ~fin_jump

        # ---- burst-resource stall: absorb jumps pinned at p ----------------
        stall_end = np.full(B, -_INF)
        stall_attr = np.full(B, -1, np.int64)
        for li in range(L):
            pinned = act & (pjump[li] > 0) & (np.abs(pb[li] - p) <= ptol)
            if not pinned.any():
                continue
            need = A[li].eval_right(t) + pjump[li]
            te = A[li].first_at_or_above(need, t)
            te = np.where(pinned, te, -_INF)
            upd = pinned & (te > stall_end)  # ties keep the first resource
            stall_attr = np.where(upd, K + li, stall_attr)
            stall_end = np.maximum(stall_end, te)
            absorbed[li][pinned, pbidx[li][pinned]] = True
        stalled = act & (stall_end > -_INF)
        if stalled.any():
            record(stalled, t, p, np.zeros(B), stall_attr)
            dead = stalled & ~np.isfinite(stall_end)
            active &= ~dead
            t = np.where(stalled & np.isfinite(stall_end), stall_end, t)
            act &= ~stalled

        if not act.any():
            continue

        # ---- movement: data-limited ceiling following or min-slope ---------
        on_ceiling = p >= pd - ftol
        cap_ok = ~np.isfinite(smin) | (pdslope <= smin + 1e-12 * np.maximum(1.0, np.where(np.isfinite(smin), smin, 1.0)))
        if ramp:
            # tangency tie-break (mirrors the scalar solver): at
            # cap == ceiling-slope the rate that is lower just after t
            # governs — a cap falling faster than the ceiling slope grows
            # binds immediately
            smin_s = np.where(np.isfinite(smin), smin, 1.0)
            eq = np.abs(pdslope - smin_s) <= 1e-9 * np.maximum(1.0, np.abs(smin_s))
            falling = smin1 < 2.0 * pdq - 1e-12 * np.maximum(1.0, np.abs(pdq))
            cap_ok = cap_ok & ~(np.isfinite(smin) & eq & falling)
        data_lim = on_ceiling & cap_ok
        slope = np.where(data_lim, pdslope, np.where(np.isfinite(smin), smin, 0.0))
        # quadratic motion coefficient: the ceiling's curvature when
        # data-limited, half the cap's time-derivative when resource-limited
        # (p' = cap(t) linear in t => p quadratic)
        qmov = (np.where(data_lim, pdq, np.where(np.isfinite(smin),
                                                 0.5 * smin1, 0.0))
                if ramp else _zeros)
        attr = np.where(data_lim, kstar, K + lstar)

        events = np.stack([tb_ceil, tb_ir])
        # ceiling argmin crossover (the other limiting function takes over)
        if ramp:
            dv_s = np.where(np.isfinite(V), V - pd[None], 1.0)
            ux = first_pos_root(Qc - pdq[None], S - pdslope[None], dv_s)
            ux = np.where(np.isfinite(V), ux, _INF)
        else:
            dv = V - pd[None]
            ds = pdslope[None] - S
            with np.errstate(divide="ignore", invalid="ignore"):
                ux = np.where(ds > 1e-300, dv / np.where(ds > 1e-300, ds, 1.0), _INF)
            ux = np.where(ux > TIME_TOL, ux, _INF)
        events = np.concatenate([events, (t[None] + ux)])
        # progress reaching a resource-requirement breakpoint
        if L:
            if ramp:
                dpb = np.where(np.isfinite(pb), p[None] - pb, 1.0)
                upb = first_pos_root(np.broadcast_to(qmov, (L, B)),
                                     np.broadcast_to(slope, (L, B)), dpb)
                upb = np.where(np.isfinite(pb), upb, _INF)
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    upb = np.where((slope[None] > 0) & np.isfinite(pb),
                                   (pb - p[None]) / np.where(slope[None] > 0, slope[None], 1.0),
                                   _INF)
                upb = np.where(upb > TIME_TOL, upb, _INF)
            events = np.concatenate([events, t[None] + upb])
        # catching up with the ceiling (resource-limited below the ceiling)
        if ramp:
            # unlike the linear class, catch-up from EQUALITY is possible: a
            # decelerating ceiling (pdq < 0) re-meets constant-rate progress
            # even when p == pd at t, so only data-limited rows are exempt;
            # the gap is clamped to <= 0 so float noise above the ceiling
            # cannot schedule a bogus downward crossing
            ucatch = first_pos_root(qmov - pdq, slope - pdslope,
                                    np.minimum(p - pd, 0.0))
            ucatch = np.where(~data_lim, ucatch, _INF)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ucatch = np.where(~data_lim & (p < pd - jtol) & (slope > pdslope + 1e-300),
                                  (pd - p) / np.where(slope > pdslope, slope - pdslope, 1.0),
                                  _INF)
            ucatch = np.where(ucatch > TIME_TOL, ucatch, _INF)
        events = np.concatenate([events, (t + ucatch)[None]])
        if ramp and L:
            # governor change: a time-varying cap undercuts the current rate
            # bound — the ceiling's slope when data-limited (cap becomes
            # binding mid-piece), the minimum cap when resource-limited (cap
            # crossover).  Both are linear-in-time crossings.
            base0 = np.where(data_lim, pdslope, smin)
            base1 = np.where(data_lim, 2.0 * pdq, smin1)
            capf = np.isfinite(caps)
            ug = first_pos_root(np.zeros((max(L, 1), B)), caps1 - base1[None],
                                np.where(capf, caps - base0[None], 1.0))
            ug = np.where(capf & np.isfinite(base0)[None], ug, _INF)
            events = np.concatenate([events, t[None] + ug])
        t_next = events.min(0)

        if ramp:
            ufin = first_pos_root(qmov, slope, p - p_end, tol=0.0)
            t_fin = t + ufin
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ufin = np.where(slope > 0, (p_end - p) / np.where(slope > 0, slope, 1.0), _INF)
            t_fin = np.where(ufin > 0, t + ufin, t)

        record(act, t, p, slope, attr, qmov)
        done = act & np.isfinite(t_fin) & (t_fin <= t_next + TIME_TOL)
        finish = np.where(done, t_fin, finish)
        active &= ~done
        cont = act & ~done
        stuck = cont & ~np.isfinite(t_next)
        active &= ~stuck
        adv = cont & ~stuck
        if adv.any():
            t_safe = np.where(np.isfinite(t_next), t_next, t)
            pd_left = np.min(np.stack([c.eval_left(t_safe) for c in ceils]), 0)
            du = t_safe - t
            p_new = np.minimum(p + (slope + qmov * du) * du, pd_left)
            p = np.where(adv, np.maximum(p, p_new), p)
            t = np.where(adv, t_safe, t)

    # scenarios that reached p_end without an explicit completion event
    late = active & (p >= p_end - ftol) & ~np.isfinite(finish)
    finish = np.where(late, t, finish)

    progress = _assemble_progress(rec_t, rec_c0, rec_c1, rec_mask,
                                  t0, finish, p_end,
                                  rec_c2=rec_c2 if ramp else None)
    share = _aggregate_shares(rec_t, rec_attr, rec_mask, finish, K + L)
    kinds = ["data"] * K + ["resource"] * L
    names = list(data_names) + res_names
    if not K:
        kinds, names = ["data"] + kinds, ["<none>"] + names
        share = np.concatenate([np.zeros((B, 1)), share], 1)
    return BatchProcResult(name=proc.name, p_end=p_end, t_start=t0,
                           finish=finish, progress=progress, ceilings=ceils,
                           factor_kinds=kinds, factor_names=names,
                           share_seconds=share, iterations=it)


def _assemble_progress(rec_t, rec_c0, rec_c1, rec_mask, t0, finish, p_end,
                       rec_c2=None):
    """Stack recorded pieces into a padded progress BPL, clamped at finish."""
    B = len(t0)
    if rec_t:
        T = np.stack(rec_t, 1)          # (B, I)
        C0 = np.stack(rec_c0, 1)
        C1 = np.stack(rec_c1, 1)
        C2 = np.stack(rec_c2, 1) if rec_c2 is not None else None
        M = np.stack(rec_mask, 1)
    else:
        T = np.zeros((B, 0))
        C0 = np.zeros((B, 0))
        C1 = np.zeros((B, 0))
        C2 = np.zeros((B, 0)) if rec_c2 is not None else None
        M = np.zeros((B, 0), bool)
    # drop pieces at/after the finish time; the terminal clamp replaces them
    fin_col = finish[:, None]
    M = M & (T < fin_col - TIME_TOL)
    # zero-width dedupe: a later piece within TIME_TOL replaces an earlier one
    for i in range(T.shape[1] - 1):
        later = M[:, i + 1:] & (np.abs(T[:, i + 1:] - T[:, i:i + 1]) <= TIME_TOL)
        M[:, i] &= ~later.any(1)
    n_valid = M.sum(1)
    has_fin = np.isfinite(finish)
    P = int(n_valid.max() if len(n_valid) else 0) + 1
    starts = np.full((B, P), PAD_START)
    c0 = np.zeros((B, P))
    c1 = np.zeros((B, P))
    c2 = np.zeros((B, P)) if C2 is not None else None
    order = np.argsort(~M, 1, kind="stable")    # valid pieces first, in order
    Ts = np.take_along_axis(T, order, 1)
    C0s = np.take_along_axis(C0, order, 1)
    C1s = np.take_along_axis(C1, order, 1)
    C2s = np.take_along_axis(C2, order, 1) if C2 is not None else None
    nkeep = min(P - 1, T.shape[1])
    if nkeep:
        keep = np.arange(nkeep)[None, :] < n_valid[:, None]
        starts[:, :nkeep] = np.where(keep, Ts[:, :nkeep], PAD_START)
        c0[:, :nkeep] = np.where(keep, C0s[:, :nkeep], 0.0)
        c1[:, :nkeep] = np.where(keep, C1s[:, :nkeep], 0.0)
        if c2 is not None:
            c2[:, :nkeep] = np.where(keep, C2s[:, :nkeep], 0.0)
    # terminal piece: hold p_end after finish (finished), else nothing to add
    term = np.where(has_fin, finish, PAD_START)
    np.put_along_axis(starts, n_valid[:, None], term[:, None], 1)
    np.put_along_axis(c0, n_valid[:, None],
                      np.where(has_fin, p_end, 0.0)[:, None], 1)
    np.put_along_axis(c1, n_valid[:, None], np.zeros((B, 1)), 1)
    if c2 is not None:
        np.put_along_axis(c2, n_valid[:, None], np.zeros((B, 1)), 1)
    # rows with no pieces at all: anchor the domain at t_start with value 0
    empty = (n_valid == 0) & ~has_fin
    if empty.any():
        starts[empty, 0] = t0[empty]
    return BPL(starts, c0, c1, c2)


def _aggregate_shares(rec_t, rec_attr, rec_mask, finish, n_factors):
    """Seconds attributed to each limiting factor (eq. (2) attribution)."""
    B = len(finish)
    out = np.zeros((B, max(n_factors, 1)))
    if not rec_t:
        return out[:, :n_factors]
    T = np.stack(rec_t, 1)
    ATTR = np.stack(rec_attr, 1)
    M = np.stack(rec_mask, 1)
    # piece ends: the next valid piece start (else finish / last event)
    I = T.shape[1]
    nxt = np.full((B,), _INF)
    ends = np.zeros((B, I))
    for i in range(I - 1, -1, -1):
        ends[:, i] = np.where(M[:, i], nxt, 0.0)
        nxt = np.where(M[:, i], T[:, i], nxt)
    # effective finish for never-finishing rows: the scalar report merges
    # consecutive same-attribution pieces into segments and clips at the last
    # finite segment end — i.e. the START of the trailing equal-attribution
    # run, not of the last raw piece
    broken = np.zeros(B, bool)
    seen = np.zeros(B, bool)
    last_attr = np.full(B, -2, np.int64)
    run_start = np.zeros(B)
    for i in range(I - 1, -1, -1):
        mi = M[:, i]
        first = mi & ~seen
        last_attr = np.where(first, ATTR[:, i], last_attr)
        seen |= mi
        same = mi & ~broken & (ATTR[:, i] == last_attr)
        run_start = np.where(same, T[:, i], run_start)
        broken |= mi & (ATTR[:, i] != last_attr)
    fin_shares = np.where(np.isfinite(finish), finish,
                          np.where(seen, run_start, 0.0))
    span = np.clip(np.minimum(ends, fin_shares[:, None]) - T, 0.0, None)
    span = np.where(M, span, 0.0)
    for f in range(n_factors):
        out[:, f] = np.where(ATTR == f, span, 0.0).sum(1)
    return out[:, :n_factors]
