"""Uncertainty-aware analysis — Monte Carlo scenarios on the fused sweep axis.

BottleMod's inputs are derived from noisy monitoring data, so every input
function is really a *distribution* (Ponder predicts task requirements with
uncertainty; QoSFlow builds sensitivity models over workflow QoS — see
PAPERS.md).  This module turns a scenario spec whose values are
:class:`~repro_torch.analysis.scenarios.Dist` objects into B sampled
what-ifs and runs them all as ONE fused sweep — the batched ``(B,)`` axis of
the engine is exactly a Monte Carlo axis:

* :func:`sample_spec` — the deterministic sampler: a threefry2x32 key
  (:mod:`repro_torch.analysis.prng`, bit for bit the stream of
  ``jax.random``) is threaded per (group, axis); raw 32-bit streams are
  combined host-side into 53-bit uniforms and inverse-transformed in numpy
  float64, so a seeded run is bit-reproducible across runs and processes,
  and draws the reference package's scenarios exactly.
* :func:`run_mc` — ``plan.mc(spec, n, seed)``: sample, pack through the
  existing :class:`~repro_torch.analysis.pack.ScenarioPack` path, sweep
  fused on ``plan.device``, wrap in an :class:`MCReport`.
* :class:`MCReport` — makespan quantiles (``p50/p95/p99``), SLO queries
  (:meth:`MCReport.prob`), per-factor **bottleneck-attribution
  probabilities** ("dl2.link binds in 83 % of draws", derived from the
  sweep's per-scenario share records), and **sensitivity indices** (Spearman
  rank correlation + first-order variance decomposition) ranking which
  input's uncertainty dominates makespan variance — ``plan.gains()``
  generalized from derivatives-at-a-point to distributions.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.ppoly import PPoly
from repro_torch.sweep.batch import Scenario

from . import prng
from .report import Report
from .scenarios import (Dist, DistRamp, ScenarioSpec, override, parse_key,
                        speed_up_data)

__all__ = ["MCAttribution", "MCAxis", "MCReport", "MCSamples",
           "MCSensitivity", "mc_report_from_sweep", "run_mc", "sample_spec"]

#: default quantile levels reported by MCReport.quantiles()
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


# ---------------------------------------------------------------------------
# sampled axes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MCAxis:
    """One sampled input axis: a scale factor on an input function, or one
    :class:`DistRamp` slope slot."""

    proc: str
    name: str
    kind: str                    # "resource" | "data"
    dist: Dist
    slot: int | None = None      # DistRamp rate slot; None = scale factor
    slot_time: float | None = None

    @property
    def label(self) -> str:
        base = f"{self.proc}.{self.name}"
        if self.slot is None:
            return base
        return f"{base}[t={self.slot_time:g}]"


@dataclass
class MCSamples:
    """The materialized draw set: concrete scenarios + the factor arrays that
    produced them (the evidence the sensitivity indices correlate against)."""

    scenarios: list[Scenario]
    axes: list[MCAxis]
    values: dict[str, np.ndarray]        # axis label -> (n,) float64
    seed: int
    n: int
    group_of: np.ndarray                 # (n,) spec-group index
    group_labels: list[str]
    labels: list[str]                    # per-draw scenario labels


# ---------------------------------------------------------------------------
# deterministic sampling
# ---------------------------------------------------------------------------

def _uniform01(key: np.ndarray, n: int, cols: int) -> np.ndarray:
    """``(n, cols)`` uniforms in [0, 1) with full 53-bit resolution, built
    from two raw 32-bit :func:`prng.bits` streams combined in numpy."""
    hi = prng.bits(prng.fold_in(key, 0), (n, cols)).astype(np.uint64)
    lo = prng.bits(prng.fold_in(key, 1), (n, cols)).astype(np.uint64)
    mant = (hi << np.uint64(21)) | (lo >> np.uint64(11))    # 53 bits
    return mant.astype(np.float64) * (1.0 / float(1 << 53))


def _classify_key(plan: Any, proc: str, name: str) -> bool:
    """True when (proc, name) is a resource input; raises on unknown keys and
    edge-fed data deps (mirrors ``CompiledWorkflow._parse_overrides``)."""
    if proc not in plan.workflow.processes:
        raise ValueError(f"mc: unknown process {proc!r} "
                         f"(processes: {sorted(plan.workflow.processes)})")
    p = plan.workflow.processes[proc]
    if name in p.resources:
        return True
    if name in p.data:
        if (proc, name) in plan.edge_sources:
            raise ValueError(
                f"mc: data input {proc!r}/{name!r} is produced by "
                f"{plan.edge_sources[(proc, name)]!r}; put the uncertainty "
                "on that process's inputs instead")
        return False
    raise ValueError(
        f"mc: process {proc!r} has no input {name!r} "
        f"(resources: {sorted(p.resources)}, data: {sorted(p.data)})")


def _normalize_spec(spec: Any) -> list[ScenarioSpec]:
    if isinstance(spec, ScenarioSpec):
        return [spec]
    if isinstance(spec, Mapping):
        return [override(spec)]
    specs = list(spec)
    if not specs:
        raise ValueError("mc: spec list is empty")
    if not all(isinstance(s, ScenarioSpec) for s in specs):
        raise TypeError("mc: spec must be a ScenarioSpec, a mapping of "
                        "'process.input' keys, or a sequence of ScenarioSpecs "
                        "(e.g. from scenarios.grid)")
    return specs


def sample_spec(plan: Any, spec: Any, n: int, *args,
                seed: int = 0) -> MCSamples:
    """Sample ``n`` concrete scenarios from a distribution-valued spec.

    ``spec`` is a :class:`ScenarioSpec` (from ``scenarios.override`` /
    ``ramp_resource``) whose values may be :class:`Dist` / :class:`DistRamp`
    objects, a plain ``{"process.input": Dist | value}`` mapping, or a
    sequence of specs (e.g. a ``scenarios.grid`` over fixed choices with
    distribution axes inside) — draws are then stratified evenly across the
    specs in order.

    Everything is host-side and deterministic: the threefry key is folded
    per (spec-group, axis) and only raw bits are drawn from it, so the same
    seed gives bit-identical scenarios in every process.
    """
    if args:  # seed is keyword-only now (unified across the analysis surface)
        if len(args) > 1:
            raise TypeError(
                f"sample_spec() takes (plan, spec, n) and keyword arguments "
                f"({len(args) + 3} positional arguments given)")
        warnings.warn(
            "sample_spec(plan, spec, n, seed) with a positional seed is "
            "deprecated; pass seed as a keyword: sample_spec(..., seed=...)",
            DeprecationWarning, stacklevel=2)
        seed = args[0]
    if n < 1:
        raise ValueError(f"mc: need n >= 1 draws, got {n}")
    specs = _normalize_spec(spec)
    root = prng.PRNGKey(int(seed))

    G = len(specs)
    counts = [n // G + (1 if g < n % G else 0) for g in range(G)]
    group_of = np.repeat(np.arange(G), counts)
    group_labels = [sp.label or (f"mc-{g}" if G > 1 else "mc")
                    for g, sp in enumerate(specs)]

    all_axes: list[MCAxis] = []
    values: dict[str, np.ndarray] = {}
    scenarios_out: list[Scenario] = []
    labels: list[str] = []

    for g, (sp, ng) in enumerate(zip(specs, counts)):
        if ng == 0:
            continue
        gkey = prng.fold_in(root, g)
        # classify every entry once (resource keys may name data deps, as in
        # ScenarioSpec.resolve), then enumerate axes in sorted order so the
        # draw <-> axis binding is independent of dict insertion order
        entries: list[tuple[str, str, bool, Any]] = []
        for (proc, name), v in sp.resources.items():
            entries.append((proc, name, _classify_key(plan, proc, name), v))
        for (proc, name), v in sp.data.items():
            if _classify_key(plan, proc, name):
                raise ValueError(f"mc: {proc}.{name} is a resource input but "
                                 "was passed in data=")
            entries.append((proc, name, False, v))
        entries.sort(key=lambda e: (e[0], e[1], not e[2]))

        axes_g: list[tuple[MCAxis, np.ndarray]] = []
        fixed_fns: dict[tuple[str, str, bool], PPoly] = {}
        ramp_templates: dict[tuple[str, str], DistRamp] = {}
        axis_i = 0
        for proc, name, is_res, v in entries:
            key = (proc, name)
            if isinstance(v, DistRamp):
                if not is_res:
                    raise ValueError(
                        f"mc: {proc}.{name} — DistRamp values describe "
                        "resource rate ramps, not data inputs")
                ramp_templates[key] = v
                for slot in v.dist_slots():
                    ax = MCAxis(proc, name, "resource", v.rates[slot],
                                slot=slot, slot_time=v.times[slot])
                    u = _uniform01(prng.fold_in(gkey, axis_i), ng,
                                   ax.dist.n_uniforms)
                    # in-class guarantee: resource rates must be >= 0
                    axes_g.append((ax, np.maximum(ax.dist.sample(u), 0.0)))
                    axis_i += 1
            elif isinstance(v, Dist):
                ax = MCAxis(proc, name, "resource" if is_res else "data", v)
                u = _uniform01(prng.fold_in(gkey, axis_i), ng,
                               v.n_uniforms)
                axes_g.append((ax, v.sample(u)))
                axis_i += 1
            elif isinstance(v, PPoly):
                fixed_fns[(proc, name, is_res)] = v
            else:   # plain number: same resolution rule as ScenarioSpec
                base = _base_fn(plan, proc, name, is_res)
                fixed_fns[(proc, name, is_res)] = (
                    base * float(v) if is_res
                    else speed_up_data(base, float(v)))

        lo = int(np.searchsorted(group_of, g, side="left"))
        for ax, vals in axes_g:
            all_axes.append(ax)
            col = values.setdefault(ax.label, np.full(n, np.nan))
            col[lo:lo + ng] = vals

        # materialize one concrete Scenario per draw
        factor_axes = [(ax, vals) for ax, vals in axes_g if ax.slot is None]
        ramp_axes: dict[tuple[str, str], list[tuple[int, np.ndarray]]] = {}
        for ax, vals in axes_g:
            if ax.slot is not None:
                ramp_axes.setdefault((ax.proc, ax.name), []).append(
                    (ax.slot, vals))
        base_of = {(ax.proc, ax.name): _base_fn(plan, ax.proc, ax.name,
                                                ax.kind == "resource")
                   for ax, _ in factor_axes}
        for i in range(ng):
            res_in: dict[tuple[str, str], PPoly] = {}
            dat_in: dict[tuple[str, str], PPoly] = {}
            for (proc, name, is_res), fn in fixed_fns.items():
                (res_in if is_res else dat_in)[(proc, name)] = fn
            for ax, vals in factor_axes:
                base = base_of[(ax.proc, ax.name)]
                f = float(vals[i])
                if ax.kind == "resource":
                    res_in[(ax.proc, ax.name)] = base * f
                else:
                    if f <= 0.0:
                        raise ValueError(
                            f"mc: draw {i} sampled non-positive data "
                            f"speed-up {f:g} for {ax.label}; data-input "
                            "factor distributions must have positive support")
                    dat_in[(ax.proc, ax.name)] = speed_up_data(base, f)
            for (proc, name), slots in ramp_axes.items():
                tpl = ramp_templates[(proc, name)]
                rates = [r if not isinstance(r, Dist) else 0.0
                         for r in tpl.rates]
                for slot, vals in slots:
                    rates[slot] = float(vals[i])
                res_in[(proc, name)] = PPoly.pwlinear(list(tpl.times), rates)
            scenarios_out.append(Scenario(
                label=f"{group_labels[g]}#{i}",
                resource_inputs=res_in, data_inputs=dat_in))
            labels.append(f"{group_labels[g]}#{i}")

    return MCSamples(scenarios=scenarios_out, axes=all_axes, values=values,
                     seed=int(seed), n=n, group_of=group_of,
                     group_labels=group_labels, labels=labels)


def _base_fn(plan: Any, proc: str, name: str, is_res: bool) -> PPoly:
    table = plan.base_res if is_res else plan.base_data
    fn = table.get((proc, name))
    if fn is None:
        raise ValueError(
            f"mc: cannot scale {proc}.{name}: the base workflow defines no "
            f"such {'resource allocation' if is_res else 'data input'}")
    return fn


# ---------------------------------------------------------------------------
# statistics helpers (scipy-free)
# ---------------------------------------------------------------------------

def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties shared), like scipy.stats.rankdata."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), dtype=np.float64)
    ranks[order] = np.arange(len(x), dtype=np.float64)
    _, inv = np.unique(x, return_inverse=True)
    counts = np.bincount(inv)
    sums = np.bincount(inv, weights=ranks)
    return (sums / counts)[inv]


def _spearman(x: np.ndarray, y: np.ndarray) -> float:
    rx, ry = _rankdata(x), _rankdata(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return 0.0
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))


def _first_order_index(x: np.ndarray, y: np.ndarray,
                       max_bins: int = 32) -> float:
    """First-order variance share S1 = Var(E[Y|X]) / Var(Y), estimated by
    quantile-binning X (the classic correlation-ratio estimator; exact
    groups when X is discrete with few levels)."""
    var = float(y.var())
    if var == 0.0:
        return 0.0
    uniq = np.unique(x)
    bins = max(2, min(max_bins, len(x) // 64)) if len(x) >= 128 else 2
    if len(uniq) <= bins:
        _, groups = np.unique(x, return_inverse=True)
    else:
        edges = np.unique(np.quantile(x, np.linspace(0, 1, bins + 1)[1:-1]))
        groups = np.searchsorted(edges, x, side="right")
    counts = np.bincount(groups)
    means = np.bincount(groups, weights=y)[counts > 0] / counts[counts > 0]
    w = counts[counts > 0] / len(x)
    return float(np.sum(w * (means - y.mean()) ** 2) / var)


# ---------------------------------------------------------------------------
# the MC report
# ---------------------------------------------------------------------------

@dataclass
class MCAttribution:
    """Probability that one (process, factor) is the draw's bottleneck."""

    process: str
    kind: str
    name: str
    p_dominant: float       #: P[largest bottleneck share of the draw]
    p_active: float         #: P[factor binds at all (share > 0)]
    mean_seconds: float     #: mean bottleneck seconds across draws

    @property
    def label(self) -> str:
        return f"{self.process}.{self.name}"


@dataclass
class MCSensitivity:
    """How much one sampled axis' uncertainty drives makespan variance."""

    axis: str
    rho: float      #: Spearman rank correlation with makespan
    s1: float       #: first-order variance share (binned correlation ratio)


@dataclass
class MCReport:
    """Monte Carlo analysis: quantiles, SLO queries, attribution
    probabilities, sensitivity ranking (see module docstring).

    Wraps the fused sweep's :class:`~repro_torch.analysis.report.Report` (one row
    per draw, available as ``.report`` for drill-downs like ``timeline(i)``)
    plus the sampled factor arrays that produced it.
    """

    report: Report
    axes: list[MCAxis]
    samples: dict[str, np.ndarray]
    seed: int
    quantile_levels: tuple = DEFAULT_QUANTILES

    # -- shape ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.report.B

    @property
    def makespans(self) -> np.ndarray:
        return self.report.makespans

    @property
    def scenarios(self) -> list[Scenario] | None:
        return self.report.scenarios

    # -- quantiles + SLO queries --------------------------------------------
    def quantile(self, q: float) -> float:
        """Makespan quantile; draws that never finish count as +inf."""
        return float(np.quantile(self.makespans, q))

    def quantiles(self) -> dict[str, float]:
        return {f"p{100 * q:g}": self.quantile(q)
                for q in self.quantile_levels}

    @property
    def p50(self) -> float:
        return self.quantile(0.5)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def prob(self, makespan_le: float | None = None,
             makespan_gt: float | None = None) -> float:
        """SLO query: ``mc.prob(makespan_le=T)`` is P[makespan <= T]."""
        if (makespan_le is None) == (makespan_gt is None):
            raise ValueError("prob() takes exactly one of makespan_le= / "
                             "makespan_gt=")
        if makespan_le is not None:
            return float(np.mean(self.makespans <= makespan_le))
        return float(np.mean(self.makespans > makespan_gt))

    # -- bottleneck-attribution probabilities --------------------------------
    def attribution(self) -> list[MCAttribution]:
        """Per-factor bottleneck probabilities, sorted by ``p_dominant``.

        Derived from the sweep's per-scenario share records: a factor
        *dominates* a draw when it has the largest bottleneck-seconds share,
        and is *active* when its share is positive at all.
        """
        S = self.report.share_seconds
        n, F = S.shape
        if F == 0 or n == 0:
            return []
        dom = np.argmax(S, axis=1)
        has_any = S.max(axis=1) > 0.0
        p_dom = np.bincount(dom[has_any], minlength=F) / max(n, 1)
        p_act = (S > 0.0).mean(axis=0)
        mean_s = S.mean(axis=0)
        out = [MCAttribution(p, k, f, float(p_dom[j]), float(p_act[j]),
                             float(mean_s[j]))
               for j, (p, k, f) in enumerate(self.report.factors)]
        out.sort(key=lambda a: (-a.p_dominant, -a.mean_seconds))
        return out

    # -- sensitivity ranking -------------------------------------------------
    def sensitivity(self) -> list[MCSensitivity]:
        """Which axis' uncertainty dominates makespan variance, ranked by
        the first-order index (|rho| breaking ties).

        Draws with non-finite makespans (or outside an axis' spec group)
        are excluded from that axis' statistics.
        """
        y_all = self.makespans
        out = []
        for label, x_all in self.samples.items():
            mask = np.isfinite(x_all) & np.isfinite(y_all)
            if mask.sum() < 2:
                out.append(MCSensitivity(label, 0.0, 0.0))
                continue
            x, y = x_all[mask], y_all[mask]
            out.append(MCSensitivity(label, _spearman(x, y),
                                     _first_order_index(x, y)))
        out.sort(key=lambda s: (-s.s1, -abs(s.rho)))
        return out

    # -- function-class routing stats (demand measurement for the roadmap) ---
    @property
    def fallback_count(self) -> int:
        return len(self.report.fallback_indices)

    @property
    def fallback_rate(self) -> float:
        return self.fallback_count / max(self.n, 1)

    @property
    def degraded_count(self) -> int:
        """Draws the serving tier re-ran on the numpy reference twin after
        the compiled engine produced garbage (``backends == "degraded"``) —
        nonzero only for MC queries routed through ``AnalysisService``."""
        return len(self.report.degraded_indices)

    def routing(self) -> dict[str, int]:
        """Draw counts per engine backend (torch / batched / loop)."""
        counts: dict[str, int] = {}
        for b in self.report.backends:
            counts[b] = counts.get(b, 0) + 1
        return counts

    def fallback_reasons(self) -> dict[str, int]:
        """Off-class reason -> draw count (the offending degree/shape), the
        demand signal the roadmap's cubic/quartic-class item asks for."""
        out: dict[str, int] = {}
        for i in self.report.fallback_indices:
            r = (self.report.fallback_reasons or {}).get(
                i, "unclassified (engine-detected)")
            out[r] = out.get(r, 0) + 1
        return out

    # -- digest --------------------------------------------------------------
    def summary(self) -> str:
        lines = [f"monte carlo: {self.n} draw(s), seed={self.seed}, "
                 f"{len(self.axes)} sampled axis/axes"]
        qs = ", ".join(f"{k}={v:.6g}s" for k, v in self.quantiles().items())
        finite = self.makespans[np.isfinite(self.makespans)]
        if len(finite):
            qs += (f" (min={float(finite.min()):.6g}s, "
                   f"max={float(finite.max()):.6g}s)")
        lines.append(f"makespan: {qs}")
        n_inf = int((~np.isfinite(self.makespans)).sum())
        if n_inf:
            lines.append(f"{n_inf} draw(s) never finish")
        att = self.attribution()
        if att:
            tops = ", ".join(f"{a.label} in {a.p_dominant:.1%}"
                             for a in att[:3] if a.p_dominant > 0)
            lines.append(f"bottleneck attribution (dominant factor): {tops}")
        sens = self.sensitivity()
        if sens:
            tops = "; ".join(f"{s.axis} S1={s.s1:.2f} rho={s.rho:+.2f}"
                             for s in sens[:3])
            lines.append(f"sensitivity: {tops}")
        counts = self.routing()
        routed = ", ".join(f"{counts[b]} {b}" for b in
                           ("torch", "batched", "degraded") if b in counts)
        if self.fallback_count:
            reasons = "; ".join(f"{r} (x{c})" for r, c in
                                sorted(self.fallback_reasons().items(),
                                       key=lambda kv: -kv[1])[:3])
            lines.append(
                f"function-class routing: {routed or '0 batched'}; "
                f"{self.fallback_count}/{self.n} draw(s) "
                f"({self.fallback_rate:.2%}) off the batched quadratic class "
                f"-> scalar: {reasons}")
        else:
            lines.append(f"function-class routing: {routed}; "
                         "0 draws off the batched quadratic class")
        if self.degraded_count:
            lines.append(
                f"degraded: {self.degraded_count}/{self.n} draw(s) re-ran "
                "on the numpy reference engine (compiled engine garbage)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def mc_report_from_sweep(rep: Report, samples: MCSamples,
                         quantile_levels: Sequence[float] = DEFAULT_QUANTILES,
                         ) -> MCReport:
    """Wrap an already-run sweep of ``samples.scenarios`` into an
    :class:`MCReport` (also the numpy-oracle entry point for tests)."""
    if rep.B != samples.n:
        raise ValueError(f"report has {rep.B} rows for {samples.n} draws")
    return MCReport(report=rep, axes=samples.axes, samples=samples.values,
                    seed=samples.seed,
                    quantile_levels=tuple(quantile_levels))


def _warn_fallback_once(rep: Report, caught: list, n: int) -> None:
    """Re-emit non-fallback warnings; collapse the per-sweep fallback warning
    into exactly ONE aggregated message carrying the fallback *rate*."""
    for w in caught:
        if not (issubclass(w.category, UserWarning)
                and "outside the batched function class" in str(w.message)):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    fb = rep.fallback_indices
    if fb:
        reasons = sorted({(rep.fallback_reasons or {}).get(i, "engine-detected")
                          for i in fb})
        digest = "; ".join(reasons[:3]) + (" ..." if len(reasons) > 3 else "")
        warnings.warn(
            f"mc: {len(fb)}/{n} draw(s) ({len(fb) / n:.2%}) fell off the "
            f"batched function class to the scalar loop ({digest}); see "
            "MCReport.fallback_reasons() for the full shape/degree census",
            UserWarning, stacklevel=3)


def run_mc(plan: Any, spec: Any, n: int = 10_000, *, seed: int = 0,
           backend: str = "auto", shards: int | None = None,
           quantile_levels: Sequence[float] = DEFAULT_QUANTILES) -> MCReport:
    """Sample ``n`` draws of ``spec`` and analyze them as one fused sweep.

    The backing :meth:`CompiledWorkflow.sweep` call goes through the normal
    prepared-pack path (``backend="auto"`` routes the batched partition to
    the fused torch engine on ``plan.device``; ``"numpy"`` runs the host
    numpy twin); ``shards`` optionally splits the draw axis into
    sub-batches (:meth:`ScenarioPack.shard`).  Warnings: at most ONE
    fallback warning fires per call, carrying the aggregate off-class rate,
    however many draws fell back.
    """
    samples = sample_spec(plan, spec, n, seed=seed)
    pack = plan.prepare(samples.scenarios)
    if shards is not None:
        pack = pack.shard(int(shards))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = plan.sweep(pack, backend=backend)
    _warn_fallback_once(rep, caught, n)
    return mc_report_from_sweep(rep, samples, quantile_levels)
