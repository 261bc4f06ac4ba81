"""Gradient-based allocation search — ``plan.optimize()``.

BottleMod's bottleneck function says which resource to relax; this module
finds the *best* allocation without a grid.  The fused sweep exposes the
makespan as a function autograd differentiates, of a flat parameter vector
``theta``
(:meth:`repro_torch.sweep.torch_engine.TorchSweepEngine.make_diff_run` +
:class:`repro_torch.analysis.pack.ThetaMap`), and a projected-gradient
search runs on top where **every optimizer step is one fused** ``(B,)``
**sweep** on ``plan.device``:

* one value-and-gradient sweep at the current iterates (all multi-start
  points ride the batch axis), then
* one value sweep over the whole step ladder — geometric line-search rungs
  plus a secant-on-the-kink candidate per start (the makespan is a piecewise
  ``max`` of smooth paths, so the minimum usually sits at a kink; the secant
  on the directional derivative finds it superlinearly where plain descent
  crawls).

Gradients are the implicit-function-theorem kind: at generic ``theta`` the
event order is locally constant and every event time is closed-form, so
``torch.autograd.grad`` through the fixed-trip event loop equals the
derivative central finite differences measure.

The risk-aware variant scores every candidate on the SAME Monte Carlo draws
(common random numbers, the bit-reproducible sampler of
:mod:`repro_torch.analysis.uncertainty`): pass
``objective=mc_quantile(spec, q=0.95, n=256)`` and the search minimizes the
p95 makespan instead of the point makespan, with the per-candidate quantile
computed on the device (``torch.quantile`` is differentiable).

Entry points::

    space = optimize.cap_space(["task1.cpu", "dl1.link"], lo=0.25, hi=4.0)
    opt = plan.optimize(space=space)                       # point makespan
    opt = plan.optimize(mc_quantile(spec, q=0.95), space)  # p95 makespan
    opt.theta, opt.value, opt.gain, opt.report, opt.evals
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.sweep.torch_engine import (MAX_ITER_CAP,
                                           IterationLadderExhausted,
                                           TorchSweepEngine, _tree_map)

from .pack import CapAxis, PwAxis, ThetaMap
from .scenarios import override, parse_key
from .uncertainty import sample_spec

__all__ = ["OptimizeReport", "Space", "cap_space", "mc_quantile",
           "run_optimize"]


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Space:
    """A box-constrained parameter space over theta axes.

    ``axes`` are :class:`~repro_torch.analysis.pack.CapAxis` /
    :class:`~repro_torch.analysis.pack.PwAxis` whose callables receive the FULL
    ``theta`` vector — several axes may read shared components (e.g. Fig. 7's
    single fraction feeding both download links).  ``lo``/``hi`` bound each
    of the ``K`` components; ``x0`` is the start point (default: box
    midpoint); ``names`` label components in reports.
    """

    axes: tuple
    lo: tuple
    hi: tuple
    x0: tuple | None = None
    names: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        for f in ("lo", "hi", "x0", "names"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))
        if len(self.lo) != len(self.hi):
            raise ValueError("Space lo/hi length mismatch")
        if self.x0 is not None and len(self.x0) != len(self.lo):
            raise ValueError("Space x0 length mismatch")
        if not self.axes:
            raise ValueError("Space needs at least one theta axis")
        if any(l >= h for l, h in zip(self.lo, self.hi)):
            raise ValueError("Space needs lo < hi per component")

    @property
    def K(self) -> int:
        return len(self.lo)

    def start(self) -> np.ndarray:
        if self.x0 is not None:
            return np.clip(np.asarray(self.x0, np.float64),
                           self.lo, self.hi)
        return (np.asarray(self.lo) + np.asarray(self.hi)) / 2.0


def cap_space(targets: Sequence[Any], *, lo: float | Sequence[float] = 0.25,
              hi: float | Sequence[float] = 4.0,
              x0: float | Sequence[float] | None = None) -> Space:
    """The common space: component ``k`` scales resource input ``targets[k]``
    (``"proc.res"`` strings or ``(proc, res)`` tuples) by ``theta[k]``.

    Scale factors compose multiplicatively with whatever the scenario rows
    carry — including Monte Carlo draws — so this space works under both the
    point and the :func:`mc_quantile` objective.
    """
    keys = [parse_key(t) for t in targets]
    K = len(keys)
    if not K:
        raise ValueError("cap_space needs at least one target")

    def vec(v, default):
        if v is None:
            v = default
        a = np.broadcast_to(np.asarray(v, np.float64), (K,))
        return tuple(float(x) for x in a)

    axes = [CapAxis(p, r, (lambda th, k=k: th[k]))
            for k, (p, r) in enumerate(keys)]
    return Space(axes=tuple(axes), lo=vec(lo, 0.25), hi=vec(hi, 4.0),
                 x0=None if x0 is None else vec(x0, 1.0),
                 names=tuple(f"{p}.{r}" for (p, r) in keys))


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class mc_quantile:
    """Risk-aware objective: minimize the ``q``-quantile makespan over ``n``
    draws of ``spec`` (a distribution-valued :func:`override`/:func:`grid`
    spec, as accepted by ``plan.mc``).

    Every candidate is scored on the SAME draws — one
    :func:`~repro_torch.analysis.uncertainty.sample_spec` call per optimize run,
    common random numbers — so candidate differences are never sampling
    noise, and the whole objective is bit-reproducible for a fixed ``seed``.
    """

    spec: Any
    q: float = 0.95
    n: int = 256
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {self.q}")
        if self.n < 2:
            raise ValueError("mc_quantile needs n >= 2 draws")


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclass
class OptimizeReport:
    """Result of one :func:`run_optimize` — optimum, provenance, and cost.

    ``evals`` counts candidate-point evaluations (the number a grid search
    would spend one scenario each on); ``sweeps`` counts fused sweep calls
    — the batched ladder packs ~10 evals per sweep.
    """

    theta: np.ndarray                   #: (K,) best parameters found
    value: float                        #: objective at ``theta``
    baseline: float                     #: objective at the start point
    gain: float                         #: ``baseline - value``
    converged: bool
    iters: int
    evals: int                          #: candidate points evaluated
    sweeps: int                         #: fused sweep calls
    objective: str                      #: human description of the objective
    trajectory: np.ndarray              #: (iters,) best value after each iter
    thetas: np.ndarray                  #: (iters, K) best iterate per iter
    report: Any                         #: full Report at the optimum
    space: Space = field(repr=False, default=None)

    def summary(self) -> str:
        names = (self.space.names if self.space and self.space.names
                 else tuple(f"theta[{k}]" for k in range(len(self.theta))))
        lines = [f"optimize: {self.objective}",
                 f"  value    {self.value:.6f}  (baseline {self.baseline:.6f},"
                 f" gain {self.gain:.6f})",
                 f"  evals    {self.evals} candidate points in {self.sweeps} "
                 f"fused sweeps, {self.iters} iterations"
                 f"{' (converged)' if self.converged else ''}"]
        for nm, v in zip(names, self.theta):
            lines.append(f"  {nm:<12s} = {v:.6g}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the differentiable objective wrapper
# ---------------------------------------------------------------------------

class _DiffObjective:
    """``theta -> per-candidate objective`` with gradients, on ``plan.device``.

    Owns the device-side pack tensors and the iteration-budget ladder
    (overflow reruns with a doubled cap, same policy as the regular solve).
    ``n`` draws per candidate ride the scenario axis: candidate ``m``
    occupies rows ``m*n .. (m+1)*n``.
    """

    def __init__(self, plan, tm: ThetaMap, pack, n: int, q: float | None):
        if pack.loop_idx:
            why = next(iter(pack.loop_reasons.values()), "unknown")
            raise ValueError(
                "plan.optimize needs a fully batched scenario pack; "
                f"{len(pack.loop_idx)} row(s) route to the scalar loop "
                f"({why})")
        if plan._torch_engine is None:
            plan._torch_engine = TorchSweepEngine(plan)
        self.eng = plan._torch_engine
        self.tm, self.pack, self.n, self.q = tm, pack, n, q
        self.cap = max([self.eng.iter_cap]
                       + list(self.eng._proven_caps.values()))
        self.evals = 0
        self.sweeps = 0
        self._dev: dict[int, Any] = {}

    def _device(self, M: int):
        if M not in self._dev:
            largs = self.eng.level_args(self.pack.host_args(),
                                        self.pack.B_batched, self.pack.ramps)
            if self.n > 1 and M > 1:
                # tile the draw block per candidate (host-side, once per M)
                def tile(a):
                    a = np.asarray(a)
                    if a.ndim >= 2 and a.shape[-2] == self.n:
                        return np.concatenate([a] * M, axis=-2)
                    return a
                largs = _tree_map(tile, largs)
            self._dev[M] = self.eng.device_args(largs)
        return self._dev[M]

    def _objective(self, theta_c: torch.Tensor):
        """``(values (M,), overflow)`` at the current cap, on the device."""
        M, n = theta_c.shape[0], self.n
        run = self.eng.make_diff_run(M * n, self.cap, self.pack.ramps,
                                     self.tm.apply)
        # each candidate's row for its n draws: a broadcast, whose backward
        # is a sum (repeat_interleave's adds with atomics on a card)
        rows = theta_c[:, None, :].expand(M, n, theta_c.shape[1]).reshape(
            M * n, -1)
        ms, ov = run(self._device(M), rows)
        v = (torch.quantile(ms.reshape(M, n), self.q, dim=1,
                            interpolation="linear") if n > 1 else ms)
        return v, ov

    def _ladder(self, call):
        """Run ``call()``; on overflow double the iteration budget and rerun
        (the fixed-trip loop must cover the deepest event chain)."""
        while True:
            out, ov = call()
            if not bool(ov):
                return out
            self.cap *= 2
            if self.cap > MAX_ITER_CAP:
                raise IterationLadderExhausted(
                    f"differentiable sweep exceeded {MAX_ITER_CAP} lockstep "
                    "iterations; use a grid sweep for this workload")

    def _theta(self, theta_c: np.ndarray, grad: bool) -> torch.Tensor:
        return torch.tensor(np.asarray(theta_c, np.float64), dtype=torch.float64,
                            device=self.eng.device, requires_grad=grad)

    def values(self, theta_c: np.ndarray) -> np.ndarray:
        """Objective at each candidate row of ``theta_c (M, K)``."""
        th = self._theta(theta_c, grad=False)

        def call():
            with torch.no_grad():
                return self._objective(th)
        v = self._ladder(call)
        self.sweeps += 1
        self.evals += th.shape[0]
        return v.cpu().numpy()

    def value_grad(self, theta_c: np.ndarray):
        """Objective and its gradient at each row: ``(M,), (M, K)``."""
        th = self._theta(theta_c, grad=True)

        def call():
            v, ov = self._objective(th)
            (g,) = torch.autograd.grad(v.sum(), th, materialize_grads=True)
            return (v.detach(), g), ov
        v, g = self._ladder(call)
        self.sweeps += 1
        self.evals += th.shape[0]
        return v.cpu().numpy(), g.cpu().numpy()


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _start_points(space: Space, starts: int) -> np.ndarray:
    """Deterministic multi-start grid: ``x0`` first, then points spread
    along the box diagonal (no RNG — runs are reproducible by construction)."""
    lo, hi = np.asarray(space.lo), np.asarray(space.hi)
    pts = [space.start()]
    for m in range(starts - 1):
        f = (m + 1.0) / starts
        pts.append(lo + f * (hi - lo))
    return np.stack(pts)


def run_optimize(plan, objective: Any = "makespan", space: Space | None = None,
                 *, constraints: Any = None, starts: int = 1, rungs: int = 8,
                 max_iters: int = 25, max_evals: int | None = None,
                 ftol: float = 1e-9, seed: int | None = None,
                 deadline_s: float | None = None) -> OptimizeReport:
    """Projected-gradient search over ``space`` (see module docstring).

    ``objective`` is ``"makespan"`` (point makespan of the base workflow) or
    an :class:`mc_quantile`.  ``constraints`` is an optional projection
    callable ``theta -> theta`` applied after every trial step (the box
    bounds are always enforced).  ``rungs`` sets the ladder width per start
    and iteration (geometric line-search points + the secant-on-kink slot);
    ``max_evals`` caps total candidate evaluations; ``ftol`` is the relative
    improvement under which two consecutive iterations mean convergence.
    ``seed`` overrides the :class:`mc_quantile` seed; ``deadline_s`` bounds
    wall time (raises :class:`TimeoutError` when exceeded).
    """
    if space is None:
        raise ValueError(
            "plan.optimize needs a Space — e.g. "
            "optimize.cap_space(['task1.cpu'], lo=0.25, hi=4.0)")
    if starts < 1 or rungs < 2:
        raise ValueError("optimize needs starts >= 1 and rungs >= 2")
    t_end = None if deadline_s is None else time.monotonic() + float(deadline_s)
    tm = ThetaMap(plan, space.axes)

    # -- objective -> scenario pack + reduction ----------------------------
    if isinstance(objective, mc_quantile):
        spec = objective.spec
        specs = spec if isinstance(spec, (list, tuple)) else [spec]
        tm.validate_spec_overlap(
            [k for s in specs for k in (*s.resources, *s.data)])
        obj_seed = objective.seed if seed is None else int(seed)
        samples = sample_spec(plan, spec, objective.n, seed=obj_seed)
        pack = plan.prepare(samples.scenarios)
        n, q = len(samples.scenarios), objective.q
        desc = (f"p{100 * objective.q:g} makespan over n={n} draws "
                f"(seed={obj_seed})")
    elif objective == "makespan":
        pack = plan.prepare([override(label="base")])
        n, q = 1, None
        desc = "makespan"
    else:
        raise ValueError(
            f"unknown objective {objective!r}: pass 'makespan' or "
            "optimize.mc_quantile(spec, q=..., n=...)")

    f = _DiffObjective(plan, tm, pack, n, q)
    lo, hi = np.asarray(space.lo), np.asarray(space.hi)

    def project(x):
        x = np.clip(x, lo, hi)
        if constraints is not None:
            x = np.clip(np.asarray(constraints(x), np.float64), lo, hi)
        return x

    M, K, S = starts, space.K, rungs
    X = np.stack([project(x) for x in _start_points(space, starts)])
    Xp = np.full((M, K), np.nan)        # previous iterate (secant memory)
    Gp = np.zeros((M, K))
    scale = np.zeros(M)                 # ladder top-rung step length
    best_v = np.full(M, np.inf)
    baseline = None
    traj, thetas_hist = [], []
    converged = False
    calm = 0
    it = 0

    for it in range(1, max_iters + 1):
        if t_end is not None and time.monotonic() > t_end:
            raise TimeoutError(
                f"plan.optimize exceeded deadline_s={deadline_s}")
        V, G = f.value_grad(X)
        bad = ~np.isfinite(V)
        V = np.where(bad, np.inf, V)
        G = np.where(np.isfinite(G), G, 0.0)
        if baseline is None:
            baseline = float(V[0])
        best_v = np.minimum(best_v, V)

        # -- candidate ladder: per start, S-1 geometric rungs + secant ------
        C = np.empty((M, S, K))
        for m in range(M):
            g = G[m]
            gn = float(np.linalg.norm(g))
            d = -g / gn if gn > 0 else np.zeros(K)
            # distance to the box wall along the descent direction
            with np.errstate(divide="ignore", invalid="ignore"):
                tw = np.where(d > 0, (hi - X[m]) / np.where(d > 0, d, 1.0),
                              np.where(d < 0, (lo - X[m]) / np.where(d < 0, d, 1.0),
                                       np.inf))
            wall = float(min(np.min(tw), np.inf))
            top = min(scale[m], wall) if scale[m] > 0 else wall
            if not np.isfinite(top) or top <= 0:
                top = float(np.max(hi - lo))
            for s in range(S - 1):
                C[m, s] = project(X[m] + (top * 2.0 ** -s) * d)
            # secant on the directional derivative: the makespan is a max of
            # smooth paths, so its minimum sits where the derivative flips
            # sign — the secant lands on that kink superlinearly
            cand = project(X[m] + (top * 2.0 ** -(S - 1)) * d)
            dp = X[m] - Xp[m]
            if np.all(np.isfinite(dp)) and np.any(dp != 0.0):
                a, b = float(Gp[m] @ dp), float(G[m] @ dp)
                if np.isfinite(a) and np.isfinite(b) and a * b < 0.0:
                    cand = project(Xp[m] + (a / (a - b)) * dp)
            C[m, S - 1] = cand

        VC = f.values(C.reshape(M * S, K)).reshape(M, S)
        VC = np.where(np.isfinite(VC), VC, np.inf)

        improved = 0.0
        for m in range(M):
            j = int(np.argmin(VC[m]))
            if VC[m, j] < V[m]:
                improved = max(improved,
                               (V[m] - VC[m, j]) / max(1.0, abs(V[m])))
                step = float(np.linalg.norm(C[m, j] - X[m]))
                Xp[m], Gp[m] = X[m], G[m]
                X[m] = C[m, j]
                best_v[m] = min(best_v[m], VC[m, j])
                # re-center the ladder on the accepted step (doubling head-
                # room); a tiny accepted step keeps shrinking the top rung
                scale[m] = max(step * 2.0, 1e-300)
            else:
                # nothing improved: refine below the finest rung tried
                base = scale[m] if scale[m] > 0 else float(np.max(hi - lo))
                scale[m] = base * 2.0 ** -(S - 1)
        mb = int(np.argmin(best_v))
        traj.append(float(best_v[mb]))
        thetas_hist.append(X[mb].copy())
        calm = calm + 1 if improved <= ftol else 0
        if calm >= 2:
            converged = True
            break
        if max_evals is not None and f.evals + M * (S + 1) > max_evals:
            break

    mb = int(np.argmin(best_v))
    x_best, v_best = X[mb], float(best_v[mb])
    scenario = tm.materialize(x_best, label="optimum")
    report = plan.sweep([scenario])
    f.evals += 1                        # the verification sweep is a real eval
    return OptimizeReport(
        theta=np.asarray(x_best, np.float64), value=v_best,
        baseline=float(baseline), gain=float(baseline) - v_best,
        converged=converged, iters=it, evals=f.evals, sweeps=f.sweeps + 1,
        objective=desc, trajectory=np.asarray(traj),
        thetas=np.asarray(thetas_hist), report=report, space=space)
