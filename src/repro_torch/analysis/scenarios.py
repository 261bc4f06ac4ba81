"""Scenario-builder DSL — declarative what-if construction.

Replaces hand-rolled ``sweep.Scenario`` dict construction with three
builders that all produce :class:`ScenarioSpec` objects (accepted anywhere a
``Scenario`` is — ``CompiledWorkflow.sweep``, ``sweep.analyze``,
``ScenarioBatch``):

* :func:`override` — one scenario from explicit replacement functions,
* :func:`scale_resource` — one scenario per factor, scaling a *base*
  allocation (resolved lazily against the workflow being swept),
* :func:`grid` — the cartesian product over several override axes.

Keys name inputs as ``"process.resource"`` / ``"process.datadep"`` strings
(or explicit ``(process, name)`` tuples).  Values are either a replacement
:class:`~repro_torch.core.ppoly.PPoly` input function or a plain number, meaning
*scale the workflow's base function by this factor* — for resource-rate
inputs a rate multiplier, for external data inputs a time-axis speed-up
(``I(t) -> I(factor * t)``, i.e. the data arrives ``factor``x faster).

**Distributions.**  Anywhere a scale factor is accepted, a :class:`Dist`
(:func:`lognormal` / :func:`uniform` / :func:`triangular` /
:func:`discrete`, also exported as :mod:`repro_torch.analysis.dist`) may stand in
for the number, turning the spec into *uncertainty intent*: ``plan.mc(spec,
n=10_000)`` samples every distribution axis per draw and analyzes all draws
as one fused sweep (:mod:`repro_torch.analysis.uncertainty`).  Ramp slopes may be
distributions too (:func:`ramp_resource` with ``Dist`` rates produces a
:class:`DistRamp`).  Specs carrying distributions cannot be resolved into a
single scenario — ``resolve()`` raises and points at ``plan.mc``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence, Union

import numpy as np

from repro_torch.core.ppoly import PPoly
from repro_torch.core.workflow import Workflow
from repro_torch.sweep.batch import Scenario

__all__ = ["Dist", "DistRamp", "ScenarioSpec", "discrete", "grid",
           "lognormal", "override", "parse_key", "ramp_resource",
           "scale_resource", "speed_up_data", "triangular", "uniform"]

#: a replacement input function, a number meaning "scale the base", or a
#: distribution over such scale factors (Monte Carlo specs — plan.mc)
OverrideValue = Union[PPoly, float, int, "Dist", "DistRamp"]
#: "process.name" string or (process, name) tuple
OverrideKey = Union[str, tuple[str, str]]


def parse_key(k: OverrideKey) -> tuple[str, str]:
    """Normalize an override key (``"proc.input"`` or tuple) to a tuple —
    shared by the DSL builders, ``CompiledWorkflow.whatif``, and
    ``ScenarioPack.override``."""
    if isinstance(k, tuple):
        proc, name = k
        return str(proc), str(name)
    if k.count(".") != 1:
        raise ValueError(
            f"override key {k!r} must be 'process.input' (one dot) or a "
            "(process, input) tuple")
    proc, name = k.split(".")
    return proc, name


_key = parse_key  # internal alias used by the builders below


def speed_up_data(fn: PPoly, factor: float) -> PPoly:
    """``I(t) -> I(factor * t)``: the same data arrives ``factor``x faster."""
    if factor <= 0.0:
        raise ValueError("data speed-up factor must be > 0")
    t0 = float(fn.starts[0]) / factor
    return PPoly.compose(fn, PPoly.linear(t0 * factor, factor, start=t0))


# ---------------------------------------------------------------------------
# distribution DSL — uncertainty intent over scale factors (plan.mc)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Dist:
    """A distribution over scale factors — the Monte Carlo override value.

    Subclasses implement the *inverse transform* from uniform draws:
    :meth:`sample` receives an ``(n, n_uniforms)`` array of uniforms in
    ``[0, 1)`` (derived deterministically from a seed by the Monte Carlo
    sampler, which a later slice of this package adds) and returns ``(n,)``
    float64 factors.  Keeping the transform host-side numpy makes a seeded
    run bit-reproducible regardless of device count.
    """

    #: uniform columns one draw consumes (2 for Box-Muller-based normals)
    n_uniforms = 1

    def sample(self, u: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def support(self) -> tuple[float, float]:
        """(lo, hi) bounds of the factor (inf allowed) — used for validation
        messages only."""
        return (-math.inf, math.inf)


@dataclass(frozen=True)
class LogNormal(Dist):
    """``median * exp(sigma * Z)`` — the canonical noisy-monitoring factor:
    strictly positive, right-skewed, median-parameterized so ``median=1``
    jitters around the base input."""

    median: float = 1.0
    sigma: float = 0.25
    n_uniforms = 2

    def __post_init__(self) -> None:
        if self.median <= 0.0:
            raise ValueError(f"lognormal median must be > 0, got {self.median}")
        if self.sigma < 0.0:
            raise ValueError(f"lognormal sigma must be >= 0, got {self.sigma}")

    def sample(self, u: np.ndarray) -> np.ndarray:
        # Box-Muller: exact standard normal from two uniforms, no scipy.
        # Clip u1 away from 0 so log() stays finite (p < 1e-300 tail).
        u1 = np.clip(u[:, 0], 1e-300, None)
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u[:, 1])
        return self.median * np.exp(self.sigma * z)

    def support(self) -> tuple[float, float]:
        return (0.0, math.inf)


@dataclass(frozen=True)
class Uniform(Dist):
    """Uniform factor on ``[lo, hi)``."""

    lo: float
    hi: float

    def __post_init__(self) -> None:
        if not self.hi > self.lo:
            raise ValueError(f"uniform needs hi > lo, got [{self.lo}, {self.hi})")

    def sample(self, u: np.ndarray) -> np.ndarray:
        return self.lo + (self.hi - self.lo) * u[:, 0]

    def support(self) -> tuple[float, float]:
        return (self.lo, self.hi)


@dataclass(frozen=True)
class Triangular(Dist):
    """Triangular factor on ``[lo, hi]`` with mode ``mode`` — the classic
    three-point estimate (pessimistic / most-likely / optimistic)."""

    lo: float
    mode: float
    hi: float

    def __post_init__(self) -> None:
        if not self.lo <= self.mode <= self.hi or not self.lo < self.hi:
            raise ValueError(
                f"triangular needs lo <= mode <= hi with lo < hi, got "
                f"({self.lo}, {self.mode}, {self.hi})")

    def sample(self, u: np.ndarray) -> np.ndarray:
        lo, m, hi = self.lo, self.mode, self.hi
        fc = (m - lo) / (hi - lo)
        left = lo + np.sqrt(u[:, 0] * (hi - lo) * (m - lo))
        right = hi - np.sqrt((1.0 - u[:, 0]) * (hi - lo) * (hi - m))
        return np.where(u[:, 0] < fc, left, right)

    def support(self) -> tuple[float, float]:
        return (self.lo, self.hi)


@dataclass(frozen=True)
class Discrete(Dist):
    """Categorical factor: ``values`` with probabilities ``probs``
    (uniform when omitted) — e.g. "the link is up at 1x, degraded at 0.3x,
    or down to 0.05x"."""

    values: tuple
    probs: tuple

    def sample(self, u: np.ndarray) -> np.ndarray:
        edges = np.cumsum(np.asarray(self.probs, dtype=np.float64))
        idx = np.searchsorted(edges / edges[-1], u[:, 0], side="right")
        return np.asarray(self.values, dtype=np.float64)[
            np.minimum(idx, len(self.values) - 1)]

    def support(self) -> tuple[float, float]:
        return (float(min(self.values)), float(max(self.values)))


def lognormal(median: float = 1.0, sigma: float = 0.25) -> LogNormal:
    """Lognormal scale factor with the given median and log-space sigma."""
    return LogNormal(median=float(median), sigma=float(sigma))


def uniform(lo: float, hi: float) -> Uniform:
    """Uniform scale factor on ``[lo, hi)``."""
    return Uniform(lo=float(lo), hi=float(hi))


def triangular(lo: float, mode: float, hi: float) -> Triangular:
    """Triangular scale factor (three-point estimate)."""
    return Triangular(lo=float(lo), mode=float(mode), hi=float(hi))


def discrete(values: Sequence[float],
             probs: Sequence[float] | None = None) -> Discrete:
    """Categorical scale factor over explicit values (uniform by default)."""
    vals = tuple(float(v) for v in values)
    if not vals:
        raise ValueError("discrete needs at least one value")
    if probs is None:
        p = tuple(1.0 / len(vals) for _ in vals)
    else:
        p = tuple(float(x) for x in probs)
        if len(p) != len(vals):
            raise ValueError(f"discrete got {len(vals)} values but "
                             f"{len(p)} probs")
        if any(x < 0.0 for x in p) or sum(p) <= 0.0:
            raise ValueError("discrete probs must be non-negative and sum > 0")
    return Discrete(values=vals, probs=p)


@dataclass(frozen=True)
class DistRamp:
    """A piecewise-linear resource ramp whose rates may be distributions.

    Produced by :func:`ramp_resource` when any rate is a :class:`Dist`; each
    ``Dist`` slot becomes its own sampled axis in ``plan.mc`` and every draw
    materializes one concrete ``PPoly.pwlinear(times, rates)``.  Sampled
    rates are clipped at 0 so every draw stays inside the batched function
    class (non-negative piecewise-linear resource rates).
    """

    times: tuple
    rates: tuple  # floats and/or Dist entries

    def dist_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.rates) if isinstance(r, Dist)]


def _has_dist(v: object) -> bool:
    return isinstance(v, (Dist, DistRamp))


# ---------------------------------------------------------------------------
# scenario specs
# ---------------------------------------------------------------------------

@dataclass
class ScenarioSpec:
    """A scenario as *intent*: overrides that may reference the base workflow.

    Values that are plain numbers are resolved against the workflow's base
    input functions at sweep time (``resolve``); explicit :class:`PPoly`
    values are used as-is.  ``ScenarioBatch`` and ``CompiledWorkflow.sweep``
    resolve specs automatically.
    """

    label: str = ""
    resources: dict[tuple[str, str], OverrideValue] = field(default_factory=dict)
    data: dict[tuple[str, str], OverrideValue] = field(default_factory=dict)

    @property
    def has_distributions(self) -> bool:
        """True when any override value is a :class:`Dist` / :class:`DistRamp`
        — the spec is Monte Carlo intent and only ``plan.mc`` can run it."""
        return any(_has_dist(v) for v in self.resources.values()) or \
            any(_has_dist(v) for v in self.data.values())

    def resolve(self, workflow: Workflow | None) -> Scenario:
        if self.has_distributions:
            keys = [f"{p}.{n}" for (p, n), v in
                    list(self.resources.items()) + list(self.data.items())
                    if _has_dist(v)]
            raise ValueError(
                f"scenario spec {self.label!r} carries distribution-valued "
                f"overrides ({', '.join(keys)}); a single what-if cannot "
                "sample them — run it through plan.mc(spec, n=...) / "
                "AnalysisService.submit_mc instead")
        res: dict[tuple[str, str], PPoly] = {}
        dat: dict[tuple[str, str], PPoly] = {}
        for (proc, name), v in self.resources.items():
            # keys from grid()/override() may name a data dep — reclassify
            # against the workflow's process definitions when available
            if (workflow is not None and proc in workflow.processes
                    and name not in workflow.processes[proc].resources
                    and name in workflow.processes[proc].data):
                if isinstance(v, PPoly):
                    dat[(proc, name)] = v
                else:
                    dat[(proc, name)] = speed_up_data(
                        self._base(workflow, proc, name, "data"), float(v))
                continue
            if isinstance(v, PPoly):
                res[(proc, name)] = v
                continue
            base = self._base(workflow, proc, name, "resource")
            res[(proc, name)] = base * float(v)
        for (proc, name), v in self.data.items():
            if isinstance(v, PPoly):
                dat[(proc, name)] = v
                continue
            base = self._base(workflow, proc, name, "data")
            dat[(proc, name)] = speed_up_data(base, float(v))
        return Scenario(label=self.label, resource_inputs=res, data_inputs=dat)

    @staticmethod
    def _base(workflow: Workflow | None, proc: str, name: str, kind: str) -> PPoly:
        if workflow is None:
            raise ValueError(
                f"scenario scales {proc}.{name} by a factor but no base "
                "workflow is available to resolve it against")
        table = (workflow.resource_alloc if kind == "resource"
                 else workflow.external_data)
        fn = table.get(proc, {}).get(name)
        if fn is None:
            raise ValueError(
                f"cannot scale {kind} input {proc!r}/{name!r}: the base "
                f"workflow defines no such input function")
        return fn


def override(resources: Mapping[OverrideKey, OverrideValue] | None = None,
             data: Mapping[OverrideKey, OverrideValue] | None = None,
             label: str = "") -> ScenarioSpec:
    """One scenario from explicit per-input overrides.

    >>> scenarios.override({"dl1.link": PPoly.constant(2e6),
    ...                     "task1.cpu": 2.0},           # 2x the base rate
    ...                    label="fast-link")
    """
    return ScenarioSpec(
        label=label,
        resources={_key(k): v for k, v in (resources or {}).items()},
        data={_key(k): v for k, v in (data or {}).items()})


def scale_resource(proc: str, res: str, factors: Iterable[float],
                   label_fmt: str = "{proc}.{res}x{factor:g}") -> list[ScenarioSpec]:
    """One scenario per factor, scaling the base allocation of one resource.

    The paper's "what do I gain if I give this bottleneck more resource"
    question as a sweep axis (Sect. 8).
    """
    return [ScenarioSpec(label=label_fmt.format(proc=proc, res=res, factor=f),
                         resources={(proc, res): float(f)})
            for f in factors]


def ramp_resource(proc: str, res: str, times: Sequence[float],
                  rates: Sequence[float], label: str = "") -> ScenarioSpec:
    """One scenario replacing a resource allocation with the continuous
    piecewise-linear interpolation through ``(times, rates)`` — the shape of
    monitoring-derived rate series (cf. low-level I/O monitoring feeds).

    Piecewise-linear resource inputs are INSIDE the batched function class
    (linear rate × linear requirement → quadratic progress pieces, solved in
    closed form), so ramp scenarios sweep on the torch/numpy fast paths with
    zero scalar fallbacks.  Rates must be non-negative — a negative rate
    leaves the model class and would fall back to the scalar loop.

    Rates may also be :class:`Dist` objects (uncertain slopes): the spec
    then carries a :class:`DistRamp` and runs through ``plan.mc``, which
    samples every ``Dist`` slot per draw (clipped at 0 to stay in class).

    >>> scenarios.ramp_resource("dl1", "link", [0.0, 60.0], [2e6, 0.5e6])
    >>> scenarios.ramp_resource("dl1", "link", [0.0, 60.0],
    ...                         [dist.lognormal(2e6, 0.3), 0.5e6])
    """
    if len(times) != len(rates):
        raise ValueError(f"ramp_resource needs one rate per time "
                         f"({len(times)} times, {len(rates)} rates)")
    if any(isinstance(r, Dist) for r in rates):
        entries = tuple(r if isinstance(r, Dist) else float(r) for r in rates)
        fixed = [r for r in entries if not isinstance(r, Dist)]
        if any(r < 0.0 for r in fixed):
            raise ValueError("ramp_resource rates must be non-negative "
                             f"(got {min(fixed)})")
        return ScenarioSpec(
            label=label or f"{proc}.{res}~ramp~mc",
            resources={(proc, res): DistRamp(times=tuple(float(t) for t in times),
                                             rates=entries)})
    rates = [float(r) for r in rates]
    if any(r < 0.0 for r in rates):
        raise ValueError("ramp_resource rates must be non-negative "
                         f"(got {min(rates)})")
    fn = PPoly.pwlinear(list(times), rates)
    return ScenarioSpec(label=label or f"{proc}.{res}~ramp",
                        resources={(proc, res): fn})


def grid(axes: Mapping[OverrideKey, Sequence[OverrideValue]],
         label_sep: str = ",") -> list[ScenarioSpec]:
    """Cartesian product over override axes — ``prod(len(axis))`` scenarios.

    >>> scenarios.grid({"dl1.link": [0.5, 1.0, 2.0],
    ...                 "task1.cpu": [1.0, 4.0]})        # 6 scenarios
    """
    keys = [_key(k) for k in axes]
    if not keys:
        raise ValueError("grid needs at least one axis")
    out: list[ScenarioSpec] = []
    for combo in itertools.product(*axes.values()):
        parts: list[str] = []
        res: dict[tuple[str, str], OverrideValue] = {}
        for (proc, name), v in zip(keys, combo):
            res[(proc, name)] = v
            if isinstance(v, (int, float)):
                tag = f"{float(v):g}"
            elif _has_dist(v):
                tag = f"~{type(v).__name__}"
            else:
                tag = f"<{type(v).__name__}>"
            parts.append(f"{proc}.{name}={tag}")
        out.append(ScenarioSpec(label=label_sep.join(parts), resources=res))
    return out
