"""Level-fused lockstep engine: the numpy engine's event loop in float64 torch.

:mod:`.engine` advances every scenario one event per Python iteration in
numpy.  This module transcribes the same Algorithm-2 event loop — case for
case, tolerance for tolerance — into float64 PyTorch tensor ops on the
plan's device, and runs the whole workflow level by level.

Execution model (level fusion): the compiled plan topo-sorts the DAG into
**topology levels** (``CompiledWorkflow.levels``) — processes in one level
share no edges or gates, so their event loops are independent.  The engine
stacks every process of a level onto a leading process axis and runs ONE
lockstep loop per *level* over ``(Lp, B)`` state with fixed-shape
``(nbuf, Lp, B, R)`` record buffers.  Per-process specs (total progress,
tolerances, requirement tables, resource and ceiling slots) are padded to
the level maxima; padded resource slots never bind (infinite cap) and
padded ceiling slots sit far above any real ceiling.

The loop runs on the host: each iteration issues the body's tensor ops and
then reads one boolean back (is any scenario still active?).  The
differentiable path (:meth:`TorchSweepEngine.make_diff_run`, behind
``plan.optimize``) instead runs a fixed number of bodies per level and
reads nothing back until the caller asks for the overflow flag.  Static
(non-edge-fed) data ceilings are composed host-side at pack time
(:meth:`TorchSweepEngine.level_args`); only edge-fed ceilings, whose inner
function is an upstream progress computed in the same run, compose on the
device.

Layout is shared with :mod:`repro_torch.kernels.ppoly_eval`: every function
batch is a padded ``(B, P)`` tuple ``(starts, c0, c1[, c2])`` using the
kernels' ``PAD_START`` sentinel, so engine outputs hand straight to the
query kernels without re-packing.  The tuple ARITY is the degree signature:
3 = piecewise-linear, 4 = quadratic (ramped resource rates).

The numpy engine stays the reference backend: the test suite asserts the two
agree to float tolerance on makespans, finish times, progress curves and
bottleneck attribution (``share_seconds``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.ppoly import PPoly, TIME_TOL, VAL_RTOL
from repro_torch.kernels.ppoly_eval.ref import PAD_START

from .engine import BatchProcResult
from .plin import BPL, UnsupportedScenario, compose_scalar

__all__ = ["IterationLadderExhausted", "TorchSweepEngine", "LazyCeilings",
           "DEFAULT_ITER_CAP", "MAX_ITER_CAP", "shard_devices", "trace_report"]

_F64 = torch.float64
_aten = torch.ops.aten


class IterationLadderExhausted(UnsupportedScenario):
    """The adaptive iteration ladder hit ``MAX_ITER_CAP`` and gave up.

    A subclass of :class:`UnsupportedScenario`, so ``backend="auto"``
    callers fall back to the numpy reference engine and record the decline
    in ``Report.engine_fallback``.
    """


class LazyCeilings:
    """List-like ceilings materialized on first access.

    The sweep does not ship its (re-derivable) ceiling arrays back from the
    device — they are only read by the occasional ``Report.data_ceiling``
    query.  ``thunk`` recomputes them host-side (numpy ``compose_scalar``)
    on demand.
    """

    def __init__(self, thunk):
        self._thunk = thunk
        self._val: list | None = None

    def _get(self) -> list:
        if self._val is None:
            self._val = list(self._thunk())
            self._thunk = None
        return self._val

    def __iter__(self):
        return iter(self._get())

    def __getitem__(self, i):
        return self._get()[i]

    def __len__(self):
        return len(self._get())


_INF = float("inf")

#: value of a padded (inert) ceiling slot: far above any real ceiling, far
#: below the PAD_START sentinel so it can never read as padding
_PAD_CEIL = 9e29

#: initial lockstep iteration budget (events per scenario are typically a
#: handful); doubled on overflow up to MAX_ITER_CAP.  Kept small on purpose:
#: record buffers, progress pieces, and downstream ceiling compositions all
#: scale with the budget.
DEFAULT_ITER_CAP = 8
MAX_ITER_CAP = 1024


# ---------------------------------------------------------------------------
# batched piecewise-polynomial algebra on (starts, c0, c1[, c2]) tuples — the
# torch transcription of repro_torch.sweep.plin.BPL (identical semantics,
# float64).  Every helper dispatches on the tuple arity.
# ---------------------------------------------------------------------------

def _valid(s):
    return s < PAD_START * 0.5


def _piece_idx(s, t, tol):
    """Piece index per query: ``s (..., P)``, ``t (...)`` -> ``(...)``."""
    cmp = s <= (t[..., None] + tol)
    return (cmp.sum(-1) - 1).clamp_min(0)


def _gather(a, i):
    """``a[..., i]`` per leading index; leading dims broadcast (the torch
    gather does not broadcast, so both sides are expanded first)."""
    lead = torch.broadcast_shapes(a.shape[:-1], i.shape)
    return torch.gather(a.expand(lead + a.shape[-1:]), -1,
                        i.expand(lead)[..., None])[..., 0]


def _pick(a, k):
    """``a[k[...], ...]`` along the leading axis: ``a (n, ...)``, ``k (...)``."""
    return torch.gather(a, 0, k[None])[0]


def _locate(f, t):
    """Piece index AND next breakpoint after ``t`` from ONE comparison.

    ``s > t + TIME_TOL`` is exactly the complement of the right-eval piece
    test ``s <= t + TIME_TOL``, so the value/slope lookup and the next event
    breakpoint share a single ``(..., P)`` comparison.
    """
    s = f[0]
    cmp = s <= (t[..., None] + TIME_TOL)
    i = (cmp.sum(-1) - 1).clamp_min(0)
    nb = torch.where(_valid(s) & ~cmp, s, _INF).amin(-1)
    return i, nb


def _eval(f, t, tol):
    s, c0, c1 = f[:3]
    i = _piece_idx(s, t, tol)
    u = t - _gather(s, i)
    if len(f) == 4:
        return _gather(c0, i) + (_gather(c1, i) + _gather(f[3], i) * u) * u
    return _gather(c0, i) + _gather(c1, i) * u


def _eval_left(f, t):
    return _eval(f, t, -TIME_TOL)


def _eval_slope_right(f, t):
    """(value, slope) at ``t`` sharing one piece-index computation."""
    s, c0, c1 = f[:3]
    i = _piece_idx(s, t, TIME_TOL)
    sl = _gather(c1, i)
    u = t - _gather(s, i)
    if len(f) == 4:
        q = _gather(f[3], i)
        return _gather(c0, i) + (sl + q * u) * u, sl + 2.0 * q * u
    return _gather(c0, i) + sl * u, sl


def _eval_slope_quad_right(f, t):
    """(value, slope, quad) at ``t`` — the quadratic widening of
    :func:`_eval_slope_right` (one shared piece lookup)."""
    s, c0, c1 = f[:3]
    i = _piece_idx(s, t, TIME_TOL)
    sl = _gather(c1, i)
    u = t - _gather(s, i)
    if len(f) == 4:
        q = _gather(f[3], i)
        return _gather(c0, i) + (sl + q * u) * u, sl + 2.0 * q * u, q
    return _gather(c0, i) + sl * u, sl, torch.zeros_like(sl)


_SCALARS: dict = {}


def _scalar(like, v: float):
    """A 0-d tensor ``v`` of ``like``'s dtype on its device, made once per
    (device, dtype, value): an operand for ``torch.maximum`` /
    ``torch.minimum`` that costs no launch per call."""
    key = (like.device, like.dtype, v)
    if key not in _SCALARS:
        _SCALARS[key] = torch.full((), v, dtype=like.dtype, device=like.device)
    return _SCALARS[key]


def _first_pos_root(a, b, c, tol=TIME_TOL):
    """Smallest root ``> tol`` of ``a·u² + b·u + c`` (inf when none) — the
    torch twin of :func:`repro_torch.core.ppoly.first_pos_root` (stable
    q-branch).  The discriminant floor (1e-300) matches the reference
    engine; it moves values by at most 1e-150, far below every tolerance,
    and keeps the sqrt's gradient finite at a zero discriminant.  The floor
    is a ``torch.maximum`` against a tensor, whose gradient at an exact tie
    is split in half as in the reference (``clamp_min`` would pass it all)."""
    quadratic = a != 0.0
    lin = torch.where(b != 0.0, -c / torch.where(b != 0.0, b, 1.0), _INF)
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.maximum(disc, _scalar(disc, 1e-300)))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    r1 = torch.where(quadratic, q / torch.where(quadratic, a, 1.0), _INF)
    # c / q only where the quadratic branch is taken: with a == 0 and b == 0
    # the floored sqrt leaves q ~ 1e-150, and the divide's backward, c / q /
    # q, would overflow to inf and meet the unselected lane's zero gradient
    q_ok = (q != 0.0) & quadratic
    r2 = torch.where(q_ok, c / torch.where(q_ok, q, 1.0), _INF)
    quad = torch.minimum(torch.where(r1 > tol, r1, _INF),
                         torch.where(r2 > tol, r2, _INF))
    quad = torch.where(disc >= 0.0, quad, _INF)
    return torch.where(quadratic, quad, torch.where(lin > tol, lin, _INF))


def _catch_up(a, b, gap):
    """First time ``u > TIME_TOL`` at which a progress ``a·u² + b·u`` ahead
    of the ceiling's closes a ``gap = p - pd`` clamped to ``<= 0``.  The
    clamp is a ``torch.minimum`` against a tensor: at ``p == pd`` its
    gradient is split in half between the two sides, as in the reference
    (``clamp_max`` would pass it all to the gap)."""
    return _first_pos_root(a, b, torch.minimum(gap, _scalar(gap, 0.0)))


def _next_starts(s):
    """Each piece's successor start, ``PAD_START`` after the last piece."""
    return torch.cat([s[..., 1:], torch.full_like(s[..., :1], PAD_START)], -1)


def _piece_len(f):
    """Per-piece domain length (loop-invariant — computed before the loop)."""
    return _next_starts(f[0]) - f[0]


def _first_at_or_above(f, y, t_lo=None, plen=None):
    s, c0, c1 = f[:3]
    y_ = y[..., None]
    if plen is None:
        plen = _piece_len(f)
    tol = VAL_RTOL * y_.abs().clamp_min(1.0) + 1e-12
    cand = torch.where(c0 >= y_ - tol, s, _INF)
    if len(f) == 4:
        # exact quadratic crossing: pieces are monotone nondecreasing on
        # their valid domain, so the smallest positive root is the crossing
        u = _first_pos_root(f[3], c1, c0 - y_, tol=0.0)
        ok = (c0 < y_ - tol) & (u <= plen + TIME_TOL)
    else:
        u = (y_ - c0) / torch.where(c1 > 0, c1, 1.0)
        ok = (c1 > 0) & (c0 < y_ - tol) & (u <= plen + TIME_TOL)
    cand = torch.minimum(cand, torch.where(ok, s + u, _INF))
    cand = torch.where(_valid(s), cand, _INF)
    out = cand.amin(-1)
    if t_lo is not None:
        out = torch.where(torch.isfinite(out), torch.maximum(out, t_lo), out)
    return out


def _antiderivative(f, linear_rate: bool = False):
    s, c0, c1 = f[:3]
    nxt = _next_starts(s)
    plen = torch.where(nxt < PAD_START * 0.5, nxt - s, 0.0)
    if linear_rate:  # ramped rates: trapezoid areas, quadratic result
        areas = torch.where(_valid(s), (c0 + 0.5 * c1 * plen) * plen, 0.0)
    else:
        areas = torch.where(_valid(s), c0 * plen, 0.0)
    acc = torch.cat([torch.zeros_like(s[..., :1]),
                     torch.cumsum(areas, -1)[..., :-1]], -1)
    if linear_rate:
        return (s, acc, c0, 0.5 * c1)
    return (s, acc, c0)


def _insert_col(cols, cvals):
    """Insert one column (start + per-plane values) into row-sorted planes —
    a shifted-select, O(B*P), in place of a row sort."""
    S = cols[0]
    P = S.shape[1]
    pos = (S <= cvals[0][:, None]).sum(1)[:, None]
    j = torch.arange(P + 1, device=S.device)[None, :]

    def ins(X, xcol):
        below = torch.cat([X, X[:, -1:]], 1)        # X_j   (j < pos)
        above = torch.cat([X[:, :1], X], 1)         # X_{j-1} (j > pos)
        return torch.where(j < pos, below,
                           torch.where(j == pos, xcol[:, None], above))

    return tuple(ins(X, xc) for X, xc in zip(cols, cvals))


def _compose(outer, inner, B):
    """``outer(inner(t))`` for a static scalar pw-linear ``outer`` (numpy
    triple) and a batched monotone ``inner`` of degree <= 2 —
    plin.compose_scalar on the device.  A linear outer maps each inner piece
    affinely, so the result keeps the inner's arity.

    The inner pieces already carry their (value, slope[, quad]) at their own
    starts, so only the outer-breakpoint crossings — one ``(B,)`` column per
    outer piece — need evaluating, and each column is merged by positional
    insertion: no sort.
    """
    quad = len(inner) == 4
    planes = inner
    if len(outer[0]) == 1:  # single-piece outer: a pure affine transform
        S, V, SL = inner[:3]
        s0, a0, a1 = (float(x[0]) for x in outer)
        pad = S >= PAD_START * 0.5
        out = (S, torch.where(pad, 0.0, a0 + a1 * (V - s0)),
               torch.where(pad, 0.0, a1 * SL))
        if quad:
            out = out + (torch.where(pad, 0.0, a1 * inner[3]),)
        return out
    dev = inner[0].device
    o_s, o_c0, o_c1 = (torch.as_tensor(np.asarray(a, np.float64), device=dev)
                       for a in outer)
    for v in outer[0][1:]:  # python loop over the static outer breakpoints
        cross = _first_at_or_above(
            inner, torch.full((B,), float(v), dtype=_F64, device=dev))
        cs = torch.where(torch.isfinite(cross), cross, PAD_START)
        if quad:
            cv, csl, cqd = _eval_slope_quad_right(inner, cs)
            planes = _insert_col(planes, (cs, cv, csl, cqd))
        else:
            cv, csl = _eval_slope_right(inner, cs)
            planes = _insert_col(planes, (cs, cv, csl))
    S, V, SL = planes[:3]
    oi = (torch.searchsorted(o_s, (V + TIME_TOL).contiguous(), right=True)
          - 1).clamp_min(0)
    c0 = o_c0[oi] + o_c1[oi] * (V - o_s[oi])
    c1 = o_c1[oi] * SL
    pad = S >= PAD_START * 0.5
    out = (S, torch.where(pad, 0.0, c0), torch.where(pad, 0.0, c1))
    if quad:
        out = out + (torch.where(pad, 0.0, o_c1[oi] * planes[3]),)
    return out


# ---------------------------------------------------------------------------
# static workflow structure
# ---------------------------------------------------------------------------

def _ppoly_triple(fn: PPoly):
    if not fn.is_piecewise_linear:
        raise UnsupportedScenario(
            f"torch engine requires piecewise-linear functions (degree {fn.degree})")
    s = fn.starts.astype(np.float64)
    c0 = fn.coeffs[:, 0].astype(np.float64)
    c1 = (fn.coeffs[:, 1].astype(np.float64) if fn.coeffs.shape[1] > 1
          else np.zeros(len(s)))
    return s, c0, c1


@dataclass(frozen=True)
class _ProcSpec:
    name: str
    p_end: float
    data_names: tuple[str, ...]
    gate_names: tuple[str, ...]
    #: dep -> (src process, output-fn triple) for pipelined (edge-fed) deps
    edges: dict
    #: dep -> requirement triple for edge-fed deps (on-device composition)
    reqs: dict
    #: dep -> requirement PPoly for static deps (host-side pre-composition)
    req_fns: dict
    res_names: tuple[str, ...]
    #: per resource: (breakpoints, marginal slopes, jump magnitudes)
    res_tables: tuple


@dataclass(frozen=True, eq=False)
class _LevelSpec:
    """One topology level: the static, level-padded view of its processes."""

    procs: tuple[_ProcSpec, ...]
    nC: int                 # max ceiling slots over the level's processes
    Lr: int                 # max resource slots over the level's processes
    n_rb: int               # max requirement-table rows (padded with +inf)
    has_jumps: bool         # any burst (jump) requirement in the level
    static_ceils: bool      # True when NO process has edge-fed deps
    #: True when a LATER level composes against this level's progress —
    #: only then is the progress assembled right after the level; all other
    #: levels join one deferred stacked assembly at the end of the run
    progress_inline: bool
    p_end: np.ndarray       # (Lp, 1)
    ptol: np.ndarray        # (Lp, 1) progress tolerance (per-process scale)
    ftol: np.ndarray        # (Lp, 1) finish tolerance
    jtol: np.ndarray        # (Lp, 1) jump tolerance
    rbs: np.ndarray | None      # (Lr, Lp, 1, n_rb) requirement breakpoints
    rc1s: np.ndarray | None     # (Lr, Lp, 1, n_rb) marginal slopes
    jumpss: np.ndarray | None   # (Lr, Lp, 1, n_rb) burst jump magnitudes

    def tensors(self, device: torch.device) -> dict:
        """The level's constant arrays as float64 tensors on ``device``."""
        def put(a):
            return None if a is None else torch.as_tensor(a, dtype=_F64,
                                                          device=device)

        return {k: put(getattr(self, k))
                for k in ("p_end", "ptol", "ftol", "jtol", "rbs", "rc1s",
                          "jumpss")}


@dataclass(frozen=True, eq=False)
class _WorkflowSpec:
    procs: tuple[_ProcSpec, ...]        # topo order (for result unwrapping)
    levels: tuple[_LevelSpec, ...]

    @staticmethod
    def from_plan(plan) -> "_WorkflowSpec":
        wf = plan.workflow
        by_name: dict[str, _ProcSpec] = {}
        for name in plan.order:
            proc = wf.processes[name]
            edges = {dep: (src, _ppoly_triple(wf.processes[src].outputs[out]))
                     for (src, out, dep) in plan.edges_in[name]}
            reqs = {d: _ppoly_triple(dd.requirement)
                    for d, dd in proc.data.items() if d in edges}
            req_fns = {d: dd.requirement
                       for d, dd in proc.data.items() if d not in edges}
            tables = tuple((rb, rc1, jumps)
                           for (_l, rb, rc1, jumps) in plan.res_tables[name])
            by_name[name] = _ProcSpec(
                name=name, p_end=float(proc.total_progress),
                data_names=tuple(proc.data.keys()),
                gate_names=tuple(plan.gates.get(name, [])),
                edges=edges, reqs=reqs, req_fns=req_fns,
                res_names=tuple(l for (l, *_r) in plan.res_tables[name]),
                res_tables=tables)
        edge_srcs = {src for ps in by_name.values()
                     for (src, _fn) in ps.edges.values()}
        levels = []
        for names in plan.levels:
            lprocs = tuple(by_name[n] for n in names)
            Lp = len(lprocs)
            nC = max(max(len(ps.data_names), 1) for ps in lprocs)
            Lr = max(len(ps.res_names) for ps in lprocs)
            has_jumps = any(np.any(j > 0) for ps in lprocs
                            for (_rb, _c, j) in ps.res_tables)
            n_rb = max((len(rb) for ps in lprocs
                        for (rb, _c, _j) in ps.res_tables), default=1)
            if Lr:
                rbs = np.full((Lr, Lp, 1, n_rb), _INF)
                rc1s = np.zeros((Lr, Lp, 1, n_rb))
                jumpss = np.zeros((Lr, Lp, 1, n_rb))
                for pi, ps in enumerate(lprocs):
                    for li, (rb, rc1, jumps) in enumerate(ps.res_tables):
                        rbs[li, pi, 0, :len(rb)] = rb
                        rc1s[li, pi, 0, :len(rb)] = rc1
                        jumpss[li, pi, 0, :len(rb)] = jumps
            else:
                rbs = rc1s = jumpss = None
            p_end = np.array([[ps.p_end] for ps in lprocs])
            levels.append(_LevelSpec(
                procs=lprocs, nC=nC, Lr=Lr, n_rb=n_rb, has_jumps=has_jumps,
                static_ceils=all(not ps.edges for ps in lprocs),
                progress_inline=any(ps.name in edge_srcs for ps in lprocs),
                p_end=p_end,
                ptol=1e-9 * np.maximum(1.0, p_end),
                ftol=1e-9 * np.maximum(1.0, p_end),
                jtol=1e-12 * np.maximum(1.0, p_end),
                rbs=rbs, rc1s=rc1s, jumpss=jumpss))
        return _WorkflowSpec(tuple(by_name[n] for n in plan.order),
                             tuple(levels))


# ---------------------------------------------------------------------------
# one topology level: the Algorithm-2 lockstep loop over every process of
# the level (leading process axis Lp)
# ---------------------------------------------------------------------------

def _solve_level(ls: _LevelSpec, k: dict, C, IR, t0, B: int, iter_cap: int,
                 ramps: bool = False, fixed_iters: bool = False,
                 need_share: bool = True, mark=None):
    """Mirror of ``engine.solve_batch``'s event loop, stacked over the
    ``Lp`` processes of one topology level, with fixed-size record buffers
    (two slots per iteration when the level has bursts: burst-stall, then
    movement).

    State is ``(Lp, B)``; ceilings ``C`` come stacked as ``(nC, Lp, B, P)``
    and resource inputs ``IR`` as ``(Lr, Lp, B, P)``, so every
    per-iteration query is one op across the whole level.  ``k`` holds the
    level's constants on the device (:meth:`_LevelSpec.tensors`).

    ``ramps`` is the static degree switch: False keeps the piecewise-linear
    arithmetic; True widens the same ops to the quadratic class
    (time-varying caps, curved ceilings, quadratic motion) plus the two
    event families only that class has (governor change, tangency
    tie-break).

    The loop runs while some scenario is active and below its end, at most
    ``iter_cap`` times; the check reads one boolean back from the device per
    iteration.  ``overflow`` reports scenarios still running at the cap.

    ``fixed_iters`` runs exactly ``iter_cap`` bodies with no check, so the
    level reads nothing back from the device: the path autograd
    differentiates (:meth:`TorchSweepEngine.make_diff_run`).  Every state
    update is masked on ``act``, so a body past quiescence changes nothing,
    and its records are masked (``M = 0``) like the slots the early-stopping
    loop never writes, which neither the progress assembly nor the share
    aggregation reads.  ``overflow`` is then a device boolean.
    ``need_share=False`` skips the share aggregation, which the makespan
    never reads.

    ``mark`` (for :func:`trace_report` only) is called with ``"level"`` on
    entry, ``"iter"`` at the top of every loop body and ``"end"`` after the
    loop.
    """
    Lp = len(ls.procs)
    nC, Lr, n_rb = ls.nC, ls.Lr, ls.n_rb
    has_jumps = ls.has_jumps
    dev = t0.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=_F64, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=_F64, device=dev)

    p_end, ptol, ftol, jtol = k["p_end"], k["ptol"], k["ftol"], k["jtol"]
    spi = 2 if has_jumps else 1                         # record slots per iter
    R = spi * iter_cap
    nbuf = 6 if ramps else 5                            # T, C0, C1, A, M[, C2]
    if Lr:
        As = _antiderivative(IR, linear_rate=ramps) if has_jumps else None
        A_plen = _piece_len(As) if has_jumps else None  # loop-invariant
        rbs = k["rbs"]                                  # (Lr, Lp, 1, n_rb)
        rbs_full = rbs.expand(Lr, Lp, B, n_rb)
        rc1s = k["rc1s"].expand(Lr, Lp, B, n_rb)
        jumpss = k["jumpss"].expand(Lr, Lp, B, n_rb)
        ptol4 = ptol[None, :, :, None]
    slot_ids = torch.arange(n_rb, device=dev)

    t = t0.to(_F64)
    p = zeros(Lp, B)
    finish = full((Lp, B), _INF)
    active = torch.ones((Lp, B), dtype=torch.bool, device=dev)
    absorbed = (torch.zeros((max(Lr, 1), Lp, B, n_rb), dtype=torch.bool,
                            device=dev) if has_jumps else None)
    slots = []                  # the (nbuf, Lp, B) record of each slot

    if mark is not None:
        mark("level")
    it = 0
    while it < iter_cap and (fixed_iters
                             or bool((active & (p < p_end - ftol)).any())):
        if mark is not None:
            mark("iter")
        act = active & (p < p_end - ftol)

        # ---- ceilings at t: value/slope/next-break from ONE piece lookup ---
        tC = t.expand(nC, Lp, B)
        iC, nbC = _locate(C, tC)
        uC = tC - _gather(C[0], iC)
        slC = _gather(C[2], iC)
        if ramps:
            Q = _gather(C[3], iC)
            V = _gather(C[1], iC) + (slC + Q * uC) * uC             # (nC,Lp,B)
            S = slC + 2.0 * Q * uC
            if nC > 1:
                # value ties break on slope, then curvature: the ceiling that
                # is lower just after t governs (mirrors the numpy twin)
                vmin = V.amin(0)
                vtie = V <= vmin + VAL_RTOL * vmin.abs().clamp_min(1.0)
                St = torch.where(vtie, S, _INF)
                Smin = St.amin(0)
                stie = vtie & (St <= Smin + VAL_RTOL * Smin.abs().clamp_min(1.0))
                kstar = torch.where(stie, Q, _INF).argmin(0)
                pd, pdslope, pdq = _pick(V, kstar), _pick(S, kstar), _pick(Q, kstar)
            else:
                kstar = torch.zeros((Lp, B), dtype=torch.int64, device=dev)
                pd, pdslope, pdq = V[0], S[0], Q[0]
        else:
            V = _gather(C[1], iC) + slC * uC                        # (nC,Lp,B)
            S = slC
            if nC > 1:
                kstar = V.argmin(0)
                pd, pdslope = _pick(V, kstar), _pick(S, kstar)
            else:
                kstar = torch.zeros((Lp, B), dtype=torch.int64, device=dev)
                pd, pdslope = V[0], S[0]
        tb_ceil = nbC.amin(0)

        # ---- resource caps and next requirement breakpoints ----------------
        # the cap query and (when bursts exist) the antiderivative value
        # share the resource piece index: antiderivatives keep their rate's
        # piece starts, so one _locate serves r_now, tb_ir AND A(t)
        if Lr:
            tL = t.expand(Lr, Lp, B)
            iL, nbL = _locate(IR, tL)
            uL = tL - _gather(IR[0], iL)
            r_sl = _gather(IR[2], iL)
            r_now = _gather(IR[1], iL) + r_sl * uL
            tb_ir = nbL.amin(0)
            ri = ((rbs <= (p + ptol)[None, :, :, None]).sum(-1) - 1).clamp_min(0)
            cl = _gather(rc1s, ri)                                  # (Lr,Lp,B)
            caps = torch.where(cl > 0, r_now / torch.where(cl > 0, cl, 1.0), _INF)
            if ramps:
                caps1 = torch.where(cl > 0, r_sl / torch.where(cl > 0, cl, 1.0),
                                    0.0)
            pp = p[None, :, :, None]
            if has_jumps:
                cond_bp = ((rbs >= pp - ptol4) & ~absorbed
                           & ((jumpss > 0) | (rbs > pp + ptol4)))
            else:  # no jumps: nothing is ever absorbed, zero-jump rule only
                cond_bp = (rbs >= pp - ptol4) & (rbs > pp + ptol4)
            has = cond_bp.any(-1)
            pbidx = cond_bp.to(torch.int8).argmax(-1)     # first True (or 0)
            pb = torch.where(has, _gather(rbs_full, pbidx), _INF)
            if Lr > 1 and ramps:
                smin = caps.amin(0)
                # value ties break on the cap derivative (falling cap wins)
                smin_s = torch.where(torch.isfinite(smin), smin, 1.0)
                ctie = caps <= smin + VAL_RTOL * smin_s.abs().clamp_min(1.0)
                lstar = torch.where(ctie, caps1, _INF).argmin(0)
                smin1 = torch.where(torch.isfinite(smin), _pick(caps1, lstar),
                                    0.0)
            elif Lr > 1:
                smin = caps.amin(0)
                lstar = caps.argmin(0)
            else:
                smin = caps[0]
                lstar = torch.zeros((Lp, B), dtype=torch.int64, device=dev)
                if ramps:
                    smin1 = torch.where(torch.isfinite(smin), caps1[0], 0.0)
            if has_jumps:
                pjump = torch.where(has, _gather(jumpss, pbidx), 0.0)
        else:
            tb_ir = full((Lp, B), _INF)
            smin = full((Lp, B), _INF)
            smin1 = zeros(Lp, B)
            lstar = torch.zeros((Lp, B), dtype=torch.int64, device=dev)
        smin_fin = torch.isfinite(smin)

        # ---- unconstrained: jump instantly toward the data ceiling ---------
        uncon = act & ~smin_fin & (p < pd - jtol)
        if has_jumps:
            blk = torch.where((pjump > 0) & (pb > p[None] + jtol[None])
                              & (pb <= pd[None] + jtol[None]), pb, _INF)
            blk_pb = blk.amin(0)
            target = torch.where(torch.isfinite(blk_pb), blk_pb, pd)
            p = torch.where(uncon, target, p)
            fin_jump = uncon & ~torch.isfinite(blk_pb) & (p >= p_end - ftol)
        else:
            p = torch.where(uncon, pd, p)
            fin_jump = uncon & (p >= p_end - ftol)
        finish = torch.where(fin_jump, t, finish)
        active = active & ~fin_jump
        act = act & ~fin_jump

        # ---- burst-resource stall: absorb jumps pinned at p ----------------
        if has_jumps:
            pinned = act[None] & (pjump > 0) & ((pb - p[None]).abs()
                                                <= ptol[None])
            uA = tL - _gather(As[0], iL)        # same pieces as the rate
            a_now = _gather(As[1], iL) + _gather(As[2], iL) * uA
            if ramps:
                a_now = a_now + _gather(As[3], iL) * uA * uA
            need = a_now + pjump
            te = _first_at_or_above(As, need, tL, plen=A_plen)
            te = torch.where(pinned, te, -_INF)
            stall_end = te.amax(0)
            # ties keep the first resource (argmax returns the first max)
            stall_attr = nC + te.argmax(0)
            absorbed = absorbed | (pinned[..., None]
                                   & (slot_ids == pbidx[..., None]))
            stalled = act & (stall_end > -_INF)
            rec0 = [torch.where(stalled, t, 0.0), torch.where(stalled, p, 0.0),
                    zeros(Lp, B),
                    torch.where(stalled, stall_attr, -1).to(_F64),
                    stalled.to(_F64)]
            dead = stalled & ~torch.isfinite(stall_end)
            active = active & ~dead
            t = torch.where(stalled & torch.isfinite(stall_end), stall_end, t)
            act = act & ~stalled
        else:
            rec0 = None

        # ---- movement: data-limited ceiling following or min-slope ---------
        on_ceiling = p >= pd - ftol
        cap_ok = ~smin_fin | (
            pdslope <= smin + 1e-12 * torch.where(smin_fin, smin,
                                                  1.0).clamp_min(1.0))
        if ramps:
            # tangency tie-break (mirrors the numpy twin): at
            # cap == ceiling-slope the rate that is lower just after t
            # governs — a falling cap binds immediately
            smin_s = torch.where(smin_fin, smin, 1.0)
            eq = (pdslope - smin_s).abs() <= 1e-9 * smin_s.abs().clamp_min(1.0)
            falling = smin1 < 2.0 * pdq - 1e-12 * pdq.abs().clamp_min(1.0)
            cap_ok = cap_ok & ~(smin_fin & eq & falling)
        data_lim = on_ceiling & cap_ok
        slope = torch.where(data_lim, pdslope, torch.where(smin_fin, smin, 0.0))
        if ramps:
            qmov = torch.where(data_lim, pdq,
                               torch.where(smin_fin, 0.5 * smin1, 0.0))
        attr = torch.where(data_lim, kstar, nC + lstar)

        events = [tb_ceil[None], tb_ir[None]]
        if nC > 1:  # ceiling argmin crossover (impossible with one ceiling)
            if ramps:
                ux = _first_pos_root(Q - pdq[None], S - pdslope[None],
                                     V - pd[None])
            else:
                dv = V - pd[None]
                ds = pdslope[None] - S
                ux = torch.where(ds > 1e-300,
                                 dv / torch.where(ds > 1e-300, ds, 1.0), _INF)
                ux = torch.where(ux > TIME_TOL, ux, _INF)
            events.append(t[None] + ux)
        if Lr:
            pb_fin = torch.isfinite(pb)
            if ramps:
                upb = _first_pos_root(qmov[None], slope[None],
                                      torch.where(pb_fin, p[None] - pb, 1.0))
                upb = torch.where(pb_fin, upb, _INF)
            else:
                # pb is masked to 0 BEFORE the divide: an inf numerator in an
                # unselected lane would still poison the gradient (the
                # divide's backward meets a zero gradient: 0 * inf = nan)
                pbs = torch.where(pb_fin, pb, 0.0)
                upb = torch.where((slope[None] > 0) & pb_fin,
                                  (pbs - p[None]) / torch.where(
                                      slope[None] > 0, slope[None], 1.0),
                                  _INF)
                upb = torch.where(upb > TIME_TOL, upb, _INF)
            events.append(t[None] + upb)
        if ramps:
            # catch-up from EQUALITY is possible in the quadratic class (a
            # decelerating ceiling re-meets slower progress), so only
            # data-limited rows are exempt; the gap clamps to <= 0 so float
            # noise above the ceiling cannot schedule a bogus crossing
            ucatch = _catch_up(qmov - pdq, slope - pdslope, p - pd)
            ucatch = torch.where(~data_lim, ucatch, _INF)
        else:
            ucatch = torch.where(
                ~data_lim & (p < pd - jtol) & (slope > pdslope + 1e-300),
                (pd - p) / torch.where(slope > pdslope, slope - pdslope, 1.0),
                _INF)
            ucatch = torch.where(ucatch > TIME_TOL, ucatch, _INF)
        events.append((t + ucatch)[None])
        if ramps and Lr:
            # governor change: a time-varying cap undercuts the current rate
            # bound — the ceiling slope when data-limited, the minimum cap
            # when resource-limited (cap crossover); linear-in-time crossing
            base0 = torch.where(data_lim, pdslope, smin)
            base1 = torch.where(data_lim, 2.0 * pdq, smin1)
            db = caps1 - base1[None]
            caps_fin = torch.isfinite(caps)
            dc = torch.where(caps_fin, caps - base0[None], 1.0)
            ug = torch.where(db != 0.0, -dc / torch.where(db != 0.0, db, 1.0),
                             _INF)
            ug = torch.where((ug > TIME_TOL) & caps_fin
                             & torch.isfinite(base0)[None], ug, _INF)
            events.append(t[None] + ug)
        t_next = torch.cat(events).amin(0)

        if ramps:
            ufin = _first_pos_root(qmov, slope, p - p_end, tol=0.0)
            t_fin = t + ufin
        else:
            ufin = torch.where(slope > 0,
                               (p_end - p) / torch.where(slope > 0, slope, 1.0),
                               _INF)
            t_fin = torch.where(ufin > 0, t + ufin, t)

        # movement record captures the pre-advance state
        rec1 = [torch.where(act, t, 0.0), torch.where(act, p, 0.0),
                torch.where(act, slope, 0.0),
                torch.where(act, attr, -1).to(_F64), act.to(_F64)]
        if ramps:
            if rec0 is not None:
                rec0.append(zeros(Lp, B))
            rec1.append(torch.where(act, qmov, 0.0))

        done = act & torch.isfinite(t_fin) & (t_fin <= t_next + TIME_TOL)
        finish = torch.where(done, t_fin, finish)
        active = active & ~done
        cont = act & ~done
        stuck = cont & ~torch.isfinite(t_next)
        active = active & ~stuck
        adv = cont & ~stuck
        t_safe = torch.where(torch.isfinite(t_next), t_next, t)
        pd_left = _eval_left(C, t_safe.expand(nC, Lp, B)).amin(0)
        du = t_safe - t
        if ramps:
            p_new = torch.minimum(p + (slope + qmov * du) * du, pd_left)
        else:
            p_new = torch.minimum(p + slope * du, pd_left)
        p = torch.where(adv, torch.maximum(p, p_new), p)
        t = torch.where(adv, t_safe, t)

        # the iteration's record slots, stacked once after the loop (no
        # in-place writes into a buffer autograd tracks)
        if has_jumps:
            slots.append(torch.stack(rec0))
        slots.append(torch.stack(rec1))
        it += 1
    if mark is not None:
        mark("end")

    slots += [zeros(nbuf, Lp, B)] * (R - len(slots))   # slots never reached
    rec = torch.stack(slots, -1)
    late = active & (p >= p_end - ftol) & ~torch.isfinite(finish)
    finish = torch.where(late, t, finish)
    overflow = (active & (p < p_end - ftol)).any()
    if not fixed_iters:
        overflow = bool(overflow)
    share = (_aggregate_shares(rec[0], rec[3].to(torch.int64), rec[4] > 0.5,
                               finish, nC + Lr, R)
             if need_share else None)
    # progress assembly happens in the runner: levels whose progress feeds
    # no later level join ONE deferred stacked assembly pass at the end
    return {"finish": finish, "rec": rec, "share": share,
            "iterations": it, "overflow": overflow}


def _suffix_min(a):
    """Suffix cumulative minimum along the last axis."""
    return torch.flip(torch.cummin(torch.flip(a, [-1]), -1).values, [-1])


def _suffix_or(m):
    """Suffix cumulative OR along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(m, [-1]).to(torch.int32), -1),
                      [-1]) > 0


class _FillGather(torch.autograd.Function):
    """``torch.gather(a, -1, idx)`` whose backward sums over a one-hot mask
    instead of scattering.  The progress fill reads one source slot into
    several slots, and ``gather``'s backward adds those gradients with
    atomics on a card, in no fixed order; the masked sum keeps a gradient,
    and so an optimizer run, the same bits from run to run."""

    @staticmethod
    def forward(ctx, a, idx):
        ctx.save_for_backward(idx)
        ctx.width = a.shape[-1]
        return torch.gather(a, -1, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        hit = idx[..., None] == torch.arange(ctx.width, device=idx.device)
        return torch.where(hit, grad[..., None], 0.0).sum(-2), None


def _assemble_progress(T, C0, C1, M, t0, finish, p_end, R: int, C2=None):
    """engine._assemble_progress with a static piece budget ``P = R + 1``,
    generalized over leading batch dims (here ``(Lp, B)``).

    Instead of compacting valid pieces to the front, every invalid slot is
    backward-filled with the NEXT valid piece, producing a
    sorted-with-duplicates layout: piece-index queries count
    ``starts <= t`` and therefore land on the LAST duplicate, which is the
    real piece, so every BPL/kernel query reads identical values.  The
    terminal hold-at-``p_end`` piece is appended as column R; rows that
    never record and never finish anchor the domain at ``t0``.
    """
    lead = finish.shape
    dev = finish.device
    M = M & (T < finish[..., None] - TIME_TOL)
    has_fin = torch.isfinite(finish)
    pe = p_end.expand(lead)
    zcol = torch.zeros(lead + (1,), dtype=_F64, device=dev)
    S = torch.cat([T, torch.where(has_fin, finish, PAD_START)[..., None]], -1)
    C0x = torch.cat([C0, torch.where(has_fin, pe, 0.0)[..., None]], -1)
    C1x = torch.cat([C1, zcol], -1)
    Mx = torch.cat([M, has_fin[..., None]], -1)
    # "fill each slot from the nearest valid slot at/after it" as a suffix
    # cumulative-min over masked column indices
    P1 = R + 1
    idx = torch.where(Mx, torch.arange(P1, device=dev), P1)
    nxt = _suffix_min(idx)

    def grab(a, fill):
        col = torch.full(lead + (1,), fill, dtype=_F64, device=dev)
        return _FillGather.apply(torch.cat([a, col], -1), nxt)

    Sf = grab(S, PAD_START)
    C0f = grab(C0x, 0.0)
    C1f = grab(C1x, 0.0)
    empty = ~Mx.any(-1)
    Sf[..., 0] = torch.where(empty, t0, Sf[..., 0])   # Sf is a fresh tensor
    if C2 is not None:
        C2f = grab(torch.cat([C2, zcol], -1), 0.0)
        return (Sf, C0f, C1f, C2f)
    return (Sf, C0f, C1f)


def _aggregate_shares(T, ATTR, M, finish, n_factors: int, R: int):
    """engine._aggregate_shares with the backward column loops replaced by
    suffix cumulative reductions (record starts are non-decreasing),
    generalized over leading batch dims."""
    lead = finish.shape
    dev = finish.device
    if n_factors == 0:
        return torch.zeros(lead + (0,), dtype=_F64, device=dev)
    ar = torch.arange(R, device=dev)
    # piece ends: the next valid piece's start (INF when none — clipped by
    # the effective finish below)
    idx = torch.where(M, ar, R)
    nxt = _suffix_min(torch.cat(
        [idx[..., 1:], torch.full(lead + (1,), R, dtype=idx.dtype, device=dev)],
        -1))
    ends_src = torch.cat([torch.where(M, T, _INF),
                          torch.full(lead + (1,), _INF, dtype=_F64, device=dev)],
                         -1)
    ends = torch.where(M, torch.gather(ends_src, -1, nxt), 0.0)
    # effective finish for never-finishing rows: the START of the trailing
    # equal-attribution run of valid pieces (see the numpy twin)
    seen = M.any(-1)
    last_idx = torch.where(M, ar, -1).amax(-1)
    last_attr = _gather(ATTR, last_idx.clamp_min(0))
    bad = M & (ATTR != last_attr[..., None])
    in_run = M & ~_suffix_or(bad)
    run_start = torch.where(in_run, T, _INF).amin(-1)
    fin_shares = torch.where(torch.isfinite(finish), finish,
                             torch.where(seen & torch.isfinite(run_start),
                                         run_start, 0.0))
    span = (torch.minimum(ends, fin_shares[..., None]) - T).clamp_min(0.0)
    span = torch.where(M, span, 0.0)
    onehot = ATTR[..., None] == torch.arange(n_factors, device=dev)
    return (span[..., None] * onehot).sum(len(lead))


# ---------------------------------------------------------------------------
# whole-workflow runner + engine front end
# ---------------------------------------------------------------------------

def _inline_progress(ls: _LevelSpec, k: dict, t0, res: dict, ramps: bool,
                     progress_by: dict) -> None:
    """Assemble a level's progress right after it (a later level composes
    its ceilings against it) into ``progress_by``."""
    rec = res["rec"]
    prog = _assemble_progress(rec[0], rec[1], rec[2], rec[4] > 0.5, t0,
                              res["finish"], k["p_end"], rec.shape[-1],
                              C2=rec[5] if ramps else None)
    for pi, ps in enumerate(ls.procs):
        progress_by[ps.name] = tuple(a[pi] for a in prog)


def _bcast(fn, B: int):
    return tuple(a.expand(B, a.shape[-1]) for a in fn)


def _stack_level_ceils(per, nC: int, B: int, arity: int, dev):
    """Stack per-process ceiling-tuple lists into one ``(nC, Lp, B, Pmax)``
    tuple, padding missing slots with the inert far-above ceiling."""
    Pm = max(tr[0].shape[-1] for cl in per for tr in cl)

    def full(shape, v):
        return torch.full(shape, v, dtype=_F64, device=dev)

    def padded(tr):
        tr = tuple(tr)
        if len(tr) < arity:
            tr = tr + tuple(torch.zeros_like(tr[0])
                            for _ in range(arity - len(tr)))
        out = []
        for k, a in enumerate(tr):
            a = a.expand(B, a.shape[-1])
            extra = Pm - a.shape[-1]
            if extra:
                a = torch.cat([a, full((B, extra), PAD_START if k == 0 else 0.0)],
                              -1)
            out.append(a)
        return out

    pad_slot = None
    rows = []
    for cl in per:
        cl = [padded(tr) for tr in cl]
        while len(cl) < nC:
            if pad_slot is None:
                s = torch.cat([full((B, 1), 0.0), full((B, Pm - 1), PAD_START)],
                              -1)
                c0 = torch.cat([full((B, 1), _PAD_CEIL), full((B, Pm - 1), 0.0)],
                               -1)
                z = full((B, Pm), 0.0)
                pad_slot = [s, c0, z] + [z] * (arity - 3)
            cl.append(pad_slot)
        rows.append(cl)
    Lp = len(per)
    return tuple(
        torch.stack([torch.stack([rows[pi][ci][k] for pi in range(Lp)])
                     for ci in range(nC)])
        for k in range(arity))


_ZERO_FN = (np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 1)))


def _np_pad_stack(slots, arity: int):
    """Host-side stacking: ``slots[n][pi]`` numpy tuples ->
    ``(n, Lp, rows, Pmax)`` arrays with ``rows in (1, B)`` (1 only when
    every constituent is a single-row broadcast)."""
    Pm = max(tr[0].shape[-1] for row in slots for tr in row)
    rows_B = max(tr[0].shape[0] for row in slots for tr in row)
    out = []
    for k in range(arity):
        mats = []
        for row in slots:
            per = []
            for tr in row:
                a = (np.asarray(tr[k], np.float64) if k < len(tr)
                     else np.zeros_like(np.asarray(tr[0], np.float64)))
                if a.shape[0] != rows_B:
                    a = np.broadcast_to(a, (rows_B, a.shape[-1]))
                extra = Pm - a.shape[-1]
                if extra:
                    fill = PAD_START if k == 0 else 0.0
                    a = np.concatenate(
                        [a, np.full((a.shape[0], extra), fill)], -1)
                per.append(a)
            mats.append(np.stack(per))
        out.append(np.stack(mats))
    return tuple(out)


def _tree_map(fn, x):
    """Apply ``fn`` to every array leaf of the level-argument pytree."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def shard_devices(device, shards: int) -> list[torch.device]:
    """The device each of ``shards`` sub-batches of a sweep on ``device``
    runs on.  On a CUDA card shard i runs on ``cuda:i``, so ``shards`` may
    not exceed the visible cards (one shard stays on ``device``); on the CPU
    the host runs the sub-batches one after another, so any count works."""
    device = torch.device(device)
    if shards < 1:
        raise ValueError(f"shard count must be >= 1, got {shards}")
    if device.type == "cpu" or shards == 1:
        return [device] * shards
    n = torch.cuda.device_count()
    if shards > n:
        raise ValueError(f"shards={shards} but only {n} CUDA device(s) are "
                         "visible")
    return [torch.device("cuda", i) for i in range(shards)]


def _pad_rows(largs: list, B: int, Bp: int) -> list:
    """Every full-batch rows axis padded to ``Bp`` by replicating the last
    scenario (single-row broadcast arrays are left alone)."""
    def pad(a):
        a = np.asarray(a)
        if a.ndim < 2 or a.shape[-2] != B:
            return a
        return np.concatenate([a] + [a[..., -1:, :]] * (Bp - B), axis=-2)

    return _tree_map(pad, largs)


def _shard_rows(largs: list, Bp: int, lo: int, n: int) -> list:
    """Rows ``[lo, lo + n)`` of every full-batch (``Bp``-row) array."""
    def rows(a):
        a = np.asarray(a)
        if a.ndim < 2 or a.shape[-2] != Bp:
            return a
        return a[..., lo:lo + n, :]

    return _tree_map(rows, largs)


class TorchSweepEngine:
    """Level-fused lockstep solver for one :class:`CompiledWorkflow`, on the
    plan's device.

    ``solve`` takes the per-process input arrays a
    :class:`~repro_torch.analysis.pack.ScenarioPack` prepared
    (``pack.host_args``) — numpy ``(rows, P)`` tuples with ``rows in (1, B)``
    — stacks them by topology level host-side (:meth:`level_args`), moves
    them to the device once (:meth:`device_args`, memoized in the pack's
    cache), and returns the same :class:`~repro_torch.sweep.engine.BatchProcResult`
    mapping the numpy engine produces.
    """

    def __init__(self, plan, *, iter_cap: int = DEFAULT_ITER_CAP):
        self.spec = _WorkflowSpec.from_plan(plan)
        self.device = torch.device(plan.device)
        self.iter_cap = int(iter_cap)
        self._consts = [ls.tensors(self.device) for ls in self.spec.levels]
        #: the level constants on each device a shard has run on
        self._consts_on = {self.device: self._consts}
        #: per-(B, shards, ramps) iteration budgets proven by past solves, so
        #: re-sweeps skip the overflow ladder without one deep workload
        #: ratcheting the budget (and the record-buffer cost) for all shapes
        self._proven_caps: dict = {}
        #: keys of ``_proven_caps`` installed from an artifact's manifest
        self._adopted: set = set()
        #: solves whose iteration cap came from an adopted row
        self.warm_hits = 0
        #: every other solve: its cap was the default or one this process
        #: proved itself
        self.cold_solves = 0

    # -- one level's inputs -------------------------------------------------
    def _level_inputs(self, ls, la, B: int, arity: int, finish_by: dict,
                      progress_by: dict, dev: torch.device):
        """``(t0, C, IR)`` of one level on ``dev``: start times from the
        gates' finish times, the ceilings (edge-fed ones composed against
        upstream progress on the device) and the resource planes, each
        broadcast to ``(·, Lp, B, P)``."""
        Lp = len(ls.procs)
        rows = []
        for ps in ls.procs:
            t0p = torch.zeros(B, dtype=_F64, device=dev)
            for g in ps.gate_names:
                t0p = torch.maximum(t0p, finish_by[g])
            rows.append(t0p)
        t0 = torch.stack(rows)
        if la["C"] is not None:   # fully static level, pre-stacked
            C = tuple(a.expand(ls.nC, Lp, B, a.shape[-1]) for a in la["C"])
        else:
            per = []
            for pi, ps in enumerate(ls.procs):
                cl = []
                for dep in ps.data_names:
                    if dep in ps.edges:
                        src, out_fn = ps.edges[dep]
                        inner = _compose(out_fn, progress_by[src], B)
                        cl.append(_compose(ps.reqs[dep], inner, B))
                    else:
                        cl.append(_bcast(la["ceil"][f"{pi}.{dep}"], B))
                if not cl:
                    cl = [(torch.zeros((B, 1), dtype=_F64, device=dev),
                           torch.full((B, 1), ps.p_end, dtype=_F64,
                                      device=dev),
                           torch.zeros((B, 1), dtype=_F64, device=dev))]
                per.append(cl)
            C = _stack_level_ceils(per, ls.nC, B, arity, dev)
        IR = (tuple(a.expand(ls.Lr, Lp, B, a.shape[-1]) for a in la["IR"])
              if ls.Lr else None)
        return t0, C, IR

    # -- one sweep at a fixed iteration budget ------------------------------
    def _make_run(self, B: int, iter_cap: int, ramps: bool, mark=None,
                  device: torch.device | None = None):
        """One sweep of ``B`` rows on ``device`` (the engine's by default):
        ``run(largs)`` returns the device results, or None on overflow."""
        dev = self.device if device is None else device
        if dev not in self._consts_on:
            self._consts_on[dev] = [ls.tensors(dev) for ls in self.spec.levels]
        spec, consts = self.spec, self._consts_on[dev]
        arity = 4 if ramps else 3

        def run(largs):
            finish_by, progress_by, out = {}, {}, {}
            solved = []                 # (level, t0, result) in level order
            for ls, la, k in zip(spec.levels, largs, consts):
                t0, C, IR = self._level_inputs(ls, la, B, arity, finish_by,
                                               progress_by, dev)
                res = _solve_level(ls, k, C, IR, t0, B, iter_cap, ramps,
                                   mark=mark)
                if res["overflow"]:   # the ladder retries at a larger budget
                    return None
                solved.append((ls, t0, res))
                for pi, ps in enumerate(ls.procs):
                    finish_by[ps.name] = res["finish"][pi]
                if ls.progress_inline:  # a later level composes against it
                    _inline_progress(ls, k, t0, res, ramps, progress_by)

            # ---- deferred progress: ONE stacked assembly over the levels no
            # later level composes against
            deferred = [(ls, t0, res, k) for (ls, t0, res), k
                        in zip(solved, consts) if not ls.progress_inline]
            if deferred:
                Rd = max(res["rec"].shape[-1] for (_l, _t, res, _k) in deferred)

                def padR(a):
                    extra = Rd - a.shape[-1]
                    if not extra:
                        return a
                    return torch.cat(
                        [a, torch.zeros(a.shape[:-1] + (extra,), dtype=a.dtype,
                                        device=dev)], -1)

                def dcat(j):
                    return torch.cat([padR(res["rec"][j])
                                      for (_l, _t, res, _k) in deferred], 0)

                prog = _assemble_progress(
                    dcat(0), dcat(1), dcat(2), dcat(4) > 0.5,
                    torch.cat([t0 for (_l, t0, _r, _k) in deferred], 0),
                    torch.cat([res["finish"] for (_l, _t, res, _k) in deferred],
                              0),
                    torch.cat([k["p_end"] for (_l, _t, _r, k) in deferred], 0),
                    Rd, C2=dcat(5) if ramps else None)
                row = 0
                for ls, _t0, _res, _k in deferred:
                    for pi, ps in enumerate(ls.procs):
                        progress_by[ps.name] = tuple(a[row + pi] for a in prog)
                    row += len(ls.procs)

            for ls, _t0, res in solved:
                for pi, ps in enumerate(ls.procs):
                    K, L = len(ps.data_names), len(ps.res_names)
                    cols = list(range(K)) + list(range(ls.nC, ls.nC + L))
                    out[ps.name] = {
                        "finish": res["finish"][pi],
                        "progress": progress_by[ps.name],
                        "share": res["share"][pi][:, cols],
                        "iterations": res["iterations"],
                    }
            return out

        return run

    # -- differentiable makespan path ---------------------------------------
    def make_diff_run(self, B: int, iter_cap: int, ramps: bool,
                      apply_theta=None, mark=None):
        """A makespan that autograd differentiates, through the level-fused
        event loop — the engine half of ``plan.optimize()``.

        Returns ``run(largs, theta) -> (makespans (B,), overflow ())``, both
        tensors on the engine's device, built from the same level recursion
        as :meth:`_make_run` with two changes:

        * every level runs exactly ``iter_cap`` bodies (``fixed_iters`` in
          :func:`_solve_level`), reading nothing back, and skips the share
          aggregation the makespan never reads;
        * ``apply_theta(IR, level_index, theta)`` rescales or rebuilds the
          level's resource planes from the ``(B, K)`` ``theta`` batch (see
          :class:`repro_torch.analysis.pack.ThetaMap`), so every candidate
          and its gradient ride one ``(B,)`` sweep with no host re-packing.

        At generic ``theta`` the event order is locally constant and every
        event time is a closed form, so the gradient is the one central
        finite differences measure away from event-reorder points.
        ``overflow`` tells the caller to climb the iteration ladder (a
        doubled ``iter_cap``, up to :data:`MAX_ITER_CAP`).
        """
        spec, consts = self.spec, self._consts
        arity = 4 if ramps else 3

        def run(largs, theta):
            finish_by, progress_by = {}, {}
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
            makespan = torch.zeros(B, dtype=_F64, device=self.device)
            for li, (ls, la, k) in enumerate(zip(spec.levels, largs, consts)):
                t0, C, IR = self._level_inputs(ls, la, B, arity, finish_by,
                                               progress_by, self.device)
                if IR is not None and apply_theta is not None:
                    IR = apply_theta(IR, li, theta)
                res = _solve_level(ls, k, C, IR, t0, B, iter_cap, ramps,
                                   fixed_iters=True, need_share=False,
                                   mark=mark)
                overflow = overflow | res["overflow"]
                for pi, ps in enumerate(ls.procs):
                    finish_by[ps.name] = res["finish"][pi]
                makespan = torch.maximum(makespan, res["finish"].amax(0))
                if ls.progress_inline:  # a later level composes against it
                    _inline_progress(ls, k, t0, res, ramps, progress_by)
            return makespan, overflow

        return run

    # -- host-side argument marshalling ------------------------------------
    def level_args(self, args_np: dict, B: int, ramps: bool) -> list:
        """Group per-process packed inputs by topology level (host-side,
        numpy): resource inputs stack to ``(Lr, Lp, rows, P)``, and for
        edge-free levels the data ceilings are fully pre-composed
        (``compose_scalar``) and pre-stacked to ``(nC, Lp, rows, P)`` — so a
        sweep re-runs NO loop-invariant composition.  Levels with edge-fed
        deps keep their static slots pre-composed per process (``"ceil"``)
        and compose only the edges on the device.
        """
        arity = 4 if ramps else 3
        largs = []
        for ls in self.spec.levels:
            la: dict = {"C": None, "IR": None, "ceil": {}}
            if ls.Lr:
                slots = []
                for li in range(ls.Lr):
                    row = []
                    for ps in ls.procs:
                        if li < len(ps.res_names):
                            row.append(
                                args_np[ps.name]["res"][ps.res_names[li]])
                        else:
                            row.append(_ZERO_FN)
                    slots.append(row)
                la["IR"] = _np_pad_stack(slots, arity=3)
            static_slots: dict[tuple[int, str], tuple] = {}
            for pi, ps in enumerate(ls.procs):
                a = args_np[ps.name]
                for dep in ps.data_names:
                    if dep in ps.edges:
                        continue
                    if dep in a.get("ceil", {}):
                        static_slots[(pi, dep)] = a["ceil"][dep]
                    else:
                        tr = a["data"][dep]
                        inner = BPL(*(np.asarray(x, np.float64) for x in tr))
                        static_slots[(pi, dep)] = compose_scalar(
                            ps.req_fns[dep], inner).arrays()
            if ls.static_ceils:
                per = []
                for pi, ps in enumerate(ls.procs):
                    cl = [static_slots[(pi, dep)] for dep in ps.data_names]
                    if not cl:
                        cl = [(np.zeros((1, 1)), np.full((1, 1), ps.p_end),
                               np.zeros((1, 1)))]
                    while len(cl) < ls.nC:
                        cl.append((np.zeros((1, 1)),
                                   np.full((1, 1), _PAD_CEIL),
                                   np.zeros((1, 1))))
                    per.append(cl)
                la["C"] = _np_pad_stack([[per[pi][ci] for pi in range(len(per))]
                                         for ci in range(ls.nC)], arity=arity)
            else:
                la["ceil"] = {f"{pi}.{dep}": tr
                              for (pi, dep), tr in static_slots.items()}
            largs.append(la)
        return largs

    def device_args(self, largs: list, device: torch.device | None = None,
                    ) -> list:
        """Numpy level pytree -> float64 tensors on ``device`` (the
        engine's by default)."""
        dev = self.device if device is None else device
        return _tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                                   device=dev), largs)

    # -- the public solve ---------------------------------------------------
    def solve(self, args, B: int, *, shards: int = 1,
              cache: dict | None = None,
              scenario_ids: list[int] | None = None,
              ramps: bool = False,
              ) -> dict[str, BatchProcResult]:
        """Run the sweep; double the iteration budget on overflow up to
        ``MAX_ITER_CAP``.

        ``ramps`` is the static degree switch (see :func:`_solve_level`):
        pass True when any packed resource input has a non-zero slope or any
        packed function a quadratic plane — the pack computes this once
        (:attr:`ScenarioPack.ramps`).

        With ``shards > 1`` the scenario axis is padded up to a multiple of
        the shard count (padding rows replicate the last scenario, are
        solved redundantly, and are dropped) and split into ``shards``
        sub-batches, each run on its device of :func:`shard_devices` at one
        common iteration budget; the results are the unsharded sweep's, bit
        for bit.
        """
        shards = int(shards)
        ramps = bool(ramps)
        devices = shard_devices(self.device, shards)
        Bp = -(-B // shards) * shards
        Bs = Bp // shards
        key = ("dev", Bp, shards, str(self.device))
        if cache is not None and key in cache:
            dev_args = cache[key]
        else:
            if callable(args):
                args = args()
            largs = self.level_args(args, B, ramps)
            if Bp != B:
                largs = _pad_rows(largs, B, Bp)
            dev_args = [self.device_args(_shard_rows(largs, Bp, i * Bs, Bs), d)
                        for i, d in enumerate(devices)]
            if cache is not None:
                cache[key] = dev_args
        pkey = (Bp, shards, ramps)
        if pkey in self._adopted:
            self.warm_hits += 1
        else:
            self.cold_solves += 1
        first = pkey not in self._proven_caps
        cap = self._proven_caps.get(pkey, self.iter_cap)
        while True:
            outs = []
            for a, d in zip(dev_args, devices):
                out = self._make_run(Bs, cap, ramps, device=d)(a)
                if out is None:     # every shard retries at the same budget
                    break
                outs.append(out)
            if len(outs) == shards:
                break
            cap *= 2
            if cap > MAX_ITER_CAP:
                raise IterationLadderExhausted(
                    f"torch engine exceeded {MAX_ITER_CAP} lockstep iterations; "
                    "use the numpy backend for this workload")
        if first:
            # one-time down-ratchet: the record buffers, progress pieces and
            # share scans all scale with the iteration budget, so the FIRST
            # successful solve tightens the proven cap to the actual event
            # depth (next power of two); later deeper packs still double back
            # up through the overflow ladder
            actual = max((o[ps.name]["iterations"] for o in outs
                          for ps in self.spec.procs), default=1)
            cap = min(cap, 1 << max(actual - 1, 0).bit_length())
        self._proven_caps[pkey] = cap
        return self._wrap(outs, B, scenario_ids)

    def proven_caps_rows(self) -> list[tuple]:
        """Proven iteration budgets as rows (B, shards, ramps, cap)."""
        return [(int(B), int(sh), bool(r), int(cap))
                for (B, sh, r), cap in sorted(self._proven_caps.items())]

    def adopt_proven_caps(self, rows) -> None:
        """Install manifest cap rows so warm solves start at the proven
        budget (``first=False``: no second down-ratchet).  A cap this
        process already proved is kept."""
        for B, sh, r, cap in rows:
            key = (int(B), int(sh), bool(r))
            if key not in self._proven_caps:
                self._proven_caps[key] = int(cap)
                self._adopted.add(key)

    def _wrap(self, outs: list, B: int, scenario_ids: list[int] | None = None,
              ) -> dict[str, BatchProcResult]:
        """Host results of the runs' device ``outs`` (one per shard, in row
        order), without the padding rows."""
        def host(get):
            return np.concatenate([get(o).cpu().numpy() for o in outs])[:B]

        results: dict[str, BatchProcResult] = {}
        for ps in self.spec.procs:
            r = outs[0][ps.name]
            finish = host(lambda o: o[ps.name]["finish"])
            # gate-never-finishes: same error surface as the numpy engine;
            # t_start is re-derived from the gate finishes (not shipped back)
            t0 = np.zeros(B)
            for g in ps.gate_names:
                gf = results[g].finish
                if not np.all(np.isfinite(gf)):
                    bad = int(np.argmin(np.isfinite(gf)))
                    if scenario_ids is not None:  # caller's index, not local
                        bad = scenario_ids[bad]
                    raise ValueError(f"gate {g!r} of {ps.name!r} never "
                                     f"finishes (scenario {bad})")
                t0 = np.maximum(t0, gf)
            progress = BPL(*(host(lambda o, j=j: o[ps.name]["progress"][j])
                             for j in range(len(r["progress"]))))
            K, L = len(ps.data_names), len(ps.res_names)
            share = host(lambda o: o[ps.name]["share"])
            kinds = ["data"] * K + ["resource"] * L
            names = list(ps.data_names) + list(ps.res_names)
            if not K:
                kinds, names = ["data"] + kinds, ["<none>"] + names
                share = np.concatenate([np.zeros((B, 1)), share], 1)
            results[ps.name] = BatchProcResult(
                name=ps.name, p_end=ps.p_end, t_start=t0,
                finish=finish, progress=progress, ceilings=None,
                factor_kinds=kinds, factor_names=names, share_seconds=share,
                iterations=max(int(o[ps.name]["iterations"]) for o in outs))
        return results


# ---------------------------------------------------------------------------
# dispatch census of a re-sweep (the twin of the reference's jaxpr counts)
# ---------------------------------------------------------------------------

class _OpCensus(TorchDispatchMode):
    """Counts every aten op dispatched under it, the scalar reads
    (``aten._local_scalar_dense``: ``bool(t)``, ``t.item()``) and the copies
    from a device to the host; :meth:`mark` snapshots the counts."""

    def __init__(self):
        super().__init__()
        self.ops = self.scalar_reads = self.copies_to_host = 0
        self.marks: list[tuple[str, int, int]] = []

    def mark(self, kind: str) -> None:
        self.marks.append((kind, self.ops, self.scalar_reads))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func is _aten._local_scalar_dense.default:
            self.scalar_reads += 1
        elif func is _aten._to_copy.default:
            dst = kwargs.get("device")
            if (dst is not None and torch.device(dst).type == "cpu"
                    and args[0].device.type != "cpu"):
                self.copies_to_host += 1
        elif func is _aten.copy_.default:
            if args[0].device.type == "cpu" and args[1].device.type != "cpu":
                self.copies_to_host += 1
        return func(*args, **kwargs)

    def levels(self) -> list[dict]:
        """Per ``_solve_level`` call: its iterations and one loop body's ops
        and scalar reads (from the first body's mark to the next mark, so a
        host-looped body includes the guard that decides the next one)."""
        out, cur = [], None
        for i, (kind, ops, reads) in enumerate(self.marks):
            if kind == "level":
                cur = {"iterations": 0, "body_ops": 0, "body_reads": 0}
                out.append(cur)
            elif kind == "iter":
                cur["iterations"] += 1
                if cur["iterations"] == 1:
                    _k, ops2, reads2 = self.marks[i + 1]
                    cur["body_ops"] = ops2 - ops
                    cur["body_reads"] = reads2 - reads
        return out


def trace_report(plan, pack, *, iter_cap: int | None = None) -> dict:
    """Deterministic dispatch census of one warm re-sweep of ``pack``.

    The twin of ``repro.sweep.jax_engine.trace_report``: where the
    reference counts the ``while`` loops and jaxpr equations of its traced
    sweep, this counts what the host dispatches, under a
    :class:`~torch.utils._python_dispatch.TorchDispatchMode`, on the
    plan's device (the CPU too):

    * ``level_loops`` — lockstep loops run, one per topology level;
    * ``body_ops`` — aten ops of one iteration of each level's loop body,
      summed over the levels (``body_ops_by_level``), the guard included;
    * ``total_ops`` — every aten op of the sweep, the copy back included;
    * ``host_syncs`` — ``scalar_reads`` (one loop guard per iteration and
      one overflow flag per level) plus ``copies_to_host`` (none on the
      CPU, where a tensor already is on the host);
    * ``iterations`` — loop iterations per level; ``overflow`` — True when
      ``iter_cap`` was too small and the engine would climb its ladder.

    ``fixed_*`` keys give the same census for the fixed-trip form
    (:meth:`TorchSweepEngine.make_diff_run`, ``iter_cap`` bodies per level,
    nothing read back until its caller asks). ``iter_cap`` defaults to the
    proven cap of ``(B, ramps)``, else the engine's default budget, as the
    reference's does. The device arguments are built before counting: a
    warm sweep reuses them.
    """
    eng = getattr(plan, "_torch_engine", None) or TorchSweepEngine(plan)
    B, ramps = pack.B_batched, bool(pack.ramps)
    dev_args = eng.device_args(eng.level_args(pack.host_args(), B, ramps))
    cap = iter_cap or eng._proven_caps.get((B, 1, ramps), eng.iter_cap)

    with torch.no_grad(), _OpCensus() as c:
        out = eng._make_run(B, cap, ramps, mark=c.mark)(dev_args)
        if out is not None:
            eng._wrap([out], B)
    with torch.no_grad(), _OpCensus() as f:
        makespan, _overflow = eng.make_diff_run(B, cap, ramps,
                                                mark=f.mark)(dev_args, None)
    lv, flv = c.levels(), f.levels()
    return {
        "level_loops": len(lv),
        "body_ops": sum(x["body_ops"] for x in lv),
        "body_ops_by_level": [x["body_ops"] for x in lv],
        "total_ops": c.ops,
        "host_syncs": c.scalar_reads + c.copies_to_host,
        "scalar_reads": c.scalar_reads,
        "copies_to_host": c.copies_to_host,
        "iterations": [x["iterations"] for x in lv],
        "overflow": out is None,
        "iter_cap": int(cap),
        "fixed_level_loops": len(flv),
        "fixed_body_ops": sum(x["body_ops"] for x in flv),
        "fixed_body_ops_by_level": [x["body_ops"] for x in flv],
        "fixed_body_reads": sum(x["body_reads"] for x in flv),
        "fixed_total_ops": f.ops,
        "fixed_host_syncs": f.scalar_reads + f.copies_to_host,
        "fixed_iterations": [x["iterations"] for x in flv],
    }
