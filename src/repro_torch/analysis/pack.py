"""Prepared scenario packs — resolve/validate/pack a sweep ONCE, re-sweep many.

``plan.sweep(list)`` spends most of its time *outside* the solver: resolving
:class:`~repro_torch.analysis.scenarios.ScenarioSpec` factors against the base
workflow, auditing the batched function class per scenario, and packing the
override functions into padded ``(B, P)`` arrays.  A :class:`ScenarioPack`
(from :meth:`CompiledWorkflow.prepare`) performs all of that exactly once and
hands ``plan.sweep(pack)`` a solver-ready handle:

* the resolved :class:`~repro_torch.sweep.batch.Scenario` deltas (private copies —
  mutating the caller's list or scenarios after ``prepare`` cannot leak in),
* the batched/loop routing decision per scenario,
* the padded override arrays, base-input single-row broadcasts, and
  pre-composed data ceilings in the ``kernels/ppoly_eval`` layout.

Re-sweep entry points::

    pack = plan.prepare(scenarios)          # resolve+classify+pack: once
    plan.sweep(pack)                        # level-fused torch engine
    plan.sweep(pack, backend="numpy")       # bit-identical to plan.sweep(list)
    pack2 = pack.override({"dl1.link": 2.0})    # delta re-pack of ONE input
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.ppoly import PPoly
from repro_torch.sweep.batch import Scenario, ScenarioBatch
from repro_torch.sweep.plin import BPL, UnsupportedScenario, is_batchable_resource

__all__ = ["ScenarioPack"]


def _copy_scenario(sc: Scenario) -> Scenario:
    return Scenario(label=sc.label, resource_inputs=dict(sc.resource_inputs),
                    data_inputs=dict(sc.data_inputs))


@dataclass
class ScenarioPack:
    """A reusable, solver-ready sweep (see module docstring).

    ``proc_args`` maps each process to its packed inputs for the batched
    partition: ``{"res": {resource: BPL}, "data": {dep: BPL},
    "ceil": {dep: BPL}}`` with ``BPL.B in (1, len(bat_idx))`` — single-row
    entries are zero-copy broadcasts of the plan's base packing.
    """

    plan: Any = field(repr=False)
    labels: list[str]
    scenarios: list[Scenario] = field(repr=False)
    bat_idx: list[int]
    loop_idx: list[int]
    reason: str | None
    proc_args: dict[str, dict[str, dict[str, BPL]]] = field(repr=False)
    #: per loop-routed scenario index: WHY it fell off the batched class
    #: (the offending input with its degree/shape) — surfaces in
    #: ``Report.fallback_reasons`` / ``MCReport.fallback_reasons()``
    loop_reasons: dict[int, str] = field(default_factory=dict, repr=False)
    #: static degree signature of the packed batch: True when any resource
    #: input ramps (non-zero slope) or any packed function carries a
    #: quadratic plane — selects the torch engine's widened quadratic arithmetic
    ramps: bool = False
    #: per-(B, device) device-tensor memo used by the torch engine so
    #: repeated re-sweeps of one pack skip even the host->device transfer
    _cache: dict[Any, Any] = field(default_factory=dict, repr=False,
                                   compare=False)

    # ------------------------------------------------------------------
    def host_args(self) -> dict:
        """Materialize (and memoize) the packed per-process input arrays.

        This is the numpy pytree the torch engine's level packer consumes
        (``{process: {"res"|"data"|"ceil": {name: (starts, c0, c1[, c2])}}}``);
        the engine groups it by topology level (padding per-process specs
        onto a leading process axis) and composes every static data ceiling
        host-side, so nothing loop-invariant is re-dispatched per re-sweep.
        Memoized in the pack's cache alongside the device arrays —
        ``override()`` re-packs start from a fresh cache.
        """
        key = ("host",)
        if key not in self._cache:
            self._cache[key] = {
                name: {grp: {k: bpl.arrays() for k, bpl in grp_args.items()}
                       for grp, grp_args in proc_args.items()}
                for name, proc_args in self.proc_args.items()}
        return self._cache[key]

    # ------------------------------------------------------------------
    def state_digest(self) -> str:
        """SHA-256 over everything that determines this pack's sweep output.

        Covers the labels, the batched/loop routing, every packed host
        array, and every scenario input function — so two packs with equal
        digests produce bit-identical sweeps.  This is the equality witness
        crash recovery uses: ``svc.recover(track_id)`` replays the journal
        and asserts the rebuilt pack digests identically to the live one
        (see :mod:`repro_torch.analysis.journal`).
        """
        h = hashlib.sha256()

        def feed(x: Any) -> None:
            if isinstance(x, (tuple, list)):
                h.update(b"(%d" % len(x))
                for v in x:
                    feed(v)
                h.update(b")")
            elif isinstance(x, dict):
                h.update(b"{%d" % len(x))
                for k in sorted(x, key=repr):
                    feed(repr(k))
                    feed(x[k])
                h.update(b"}")
            elif isinstance(x, np.ndarray):
                h.update(f"a{x.shape}{x.dtype}".encode())
                h.update(np.ascontiguousarray(x).tobytes())
            elif isinstance(x, PPoly):
                h.update(b"P")
                feed((x.starts, x.coeffs))
            elif isinstance(x, str):
                h.update(b"s")
                h.update(x.encode())
            elif isinstance(x, (bool, int, float, np.generic)):
                h.update(f"n{float(x)!r}".encode())
            elif x is None:
                h.update(b"N")
            else:
                h.update(f"o{x!r}".encode())

        feed(self.labels)
        feed(self.bat_idx)
        feed(self.loop_idx)
        feed(self.ramps)
        feed(self.host_args())
        for sc in self.scenarios:
            feed(sc.label)
            feed(sc.resource_inputs)
            feed(sc.data_inputs)
        return h.hexdigest()

    # ------------------------------------------------------------------
    @property
    def B(self) -> int:
        return len(self.scenarios)

    @property
    def B_batched(self) -> int:
        return len(self.bat_idx)

    # ------------------------------------------------------------------
    @staticmethod
    def build(plan: Any, scenario_list: Sequence[Any], *,
              classify: bool = True) -> "ScenarioPack":
        """Resolve, classify, and pack ``scenario_list`` against ``plan``."""
        batch = ScenarioBatch(plan.workflow, list(scenario_list))
        scenarios = [_copy_scenario(sc) for sc in batch.scenarios]
        labels = batch.labels()
        B = len(scenarios)
        if classify:
            reasons = [plan._classify(sc) for sc in scenarios]
            bat_idx = [i for i, r in enumerate(reasons) if r is None]
            loop_idx = [i for i, r in enumerate(reasons) if r is not None]
            reason = next((r for r in reasons if r is not None), None)
            loop_reasons = {i: r for i, r in enumerate(reasons)
                            if r is not None}
        else:
            bat_idx, loop_idx, reason = [], list(range(B)), None
            loop_reasons = {}
        proc_args: dict[str, dict[str, dict[str, BPL]]] = {}
        if bat_idx:
            try:
                proc_args = _pack_proc_args(plan, [scenarios[i] for i in bat_idx])
            except UnsupportedScenario as e:
                # defensive: packing found an out-of-class construct the
                # static audit missed — route everything to the scalar loop
                for i in bat_idx:
                    loop_reasons.setdefault(i, str(e))
                loop_idx = sorted(loop_idx + bat_idx)
                bat_idx, proc_args = [], {}
                reason = reason or str(e)
        return ScenarioPack(plan=plan, labels=labels, scenarios=scenarios,
                            bat_idx=bat_idx, loop_idx=loop_idx, reason=reason,
                            proc_args=proc_args, loop_reasons=loop_reasons,
                            ramps=_compute_ramps(proc_args))

    # ------------------------------------------------------------------
    def subset(self, indices: Sequence[int]) -> "ScenarioPack":
        """A row-subset copy: the selected scenarios only, no re-resolution.

        Slices the packed override arrays (single-row base-input broadcasts
        pass through untouched) and remaps the batched/loop routing — the
        pack-level inverse of :meth:`Report.subset`.  The serving tier's
        degradation guard uses this to re-run just the garbage rows on the
        numpy reference engine at slice cost instead of re-preparing.
        """
        idx = [int(i) for i in indices]
        if any(i < 0 or i >= self.B for i in idx):
            raise ValueError(f"subset: scenario index out of range "
                             f"(B={self.B}, got {idx})")
        bat_pos = {i: p for p, i in enumerate(self.bat_idx)}
        new_bat: list[int] = []
        new_loop: list[int] = []
        sel_rows: list[int] = []   # rows of the packed (B_batched, P) arrays
        loop_reasons: dict[int, str] = {}
        for j, i in enumerate(idx):
            if i in bat_pos:
                new_bat.append(j)
                sel_rows.append(bat_pos[i])
            else:
                new_loop.append(j)
                if i in self.loop_reasons:
                    loop_reasons[j] = self.loop_reasons[i]
        proc_args: dict[str, dict[str, dict[str, BPL]]] = {}
        if new_bat:
            proc_args = {
                name: {grp: {k: bpl.row_subset(sel_rows)
                             for k, bpl in grp_args.items()}
                       for grp, grp_args in args.items()}
                for name, args in self.proc_args.items()}
        return ScenarioPack(plan=self.plan,
                            labels=[self.labels[i] for i in idx],
                            scenarios=[self.scenarios[i] for i in idx],
                            bat_idx=new_bat, loop_idx=new_loop,
                            reason=next(iter(loop_reasons.values()), None),
                            proc_args=proc_args, loop_reasons=loop_reasons,
                            ramps=self.ramps)

    # ------------------------------------------------------------------
    def override(self, inputs: Mapping[Any, Any]) -> "ScenarioPack":
        """Delta re-pack: replace ONLY the named inputs, reuse everything else.

        Keys are ``"process.input"`` strings or ``(process, input)`` tuples;
        values are a single :class:`PPoly` (applied to every scenario), a
        sequence of B PPolys, a number (scale the *base* input, resources as
        a rate multiplier, data as a time-axis speed-up), or a sequence of B
        numbers.  The replacement functions must stay inside the batched
        function class — re-``prepare`` for anything richer.
        """
        from .scenarios import parse_key, speed_up_data

        plan = self.plan
        scenarios = [_copy_scenario(sc) for sc in self.scenarios]
        proc_args = {name: {grp: dict(d) for grp, d in args.items()}
                     for name, args in self.proc_args.items()}
        for rawkey, value in inputs.items():
            proc, name = parse_key(rawkey)
            if proc not in plan.workflow.processes:
                raise ValueError(f"override: unknown process {proc!r}")
            p = plan.workflow.processes[proc]
            is_res = name in p.resources
            if not is_res and name not in p.data:
                raise ValueError(
                    f"override: process {proc!r} has no input {name!r} "
                    f"(resources: {sorted(p.resources)}, data: {sorted(p.data)})")
            key = (proc, name)
            if not is_res and key in plan.edge_sources:
                raise ValueError(
                    f"override: data input {proc!r}/{name!r} is produced by "
                    f"{plan.edge_sources[key]!r} and cannot be overridden")
            base = (plan.base_res[key] if is_res else plan.base_data[key])
            fns = _resolve_override_fns(value, base, self.B, is_res,
                                        speed_up_data)
            for i, sc in enumerate(scenarios):
                (sc.resource_inputs if is_res else sc.data_inputs)[key] = fns[i]
            # only replacements aimed at BATCHED scenarios must stay inside
            # the batched function class — loop-routed scenarios run the
            # scalar solver, which accepts any PPoly
            for i in self.bat_idx:
                fn = fns[i]
                bad = (not is_batchable_resource(fn)) if is_res \
                    else (not fn.is_piecewise_quadratic)
                if bad:
                    raise UnsupportedScenario(
                        f"override for {proc}.{name} (scenario {i}) leaves "
                        "the batched function class (resources: non-negative "
                        "piecewise-linear rates; data: degree <= 2); use "
                        "plan.prepare() on the new scenario list instead")
            if self.bat_idx:
                packed = BPL.from_ppolys([fns[i] for i in self.bat_idx])
                grp = proc_args.setdefault(proc, {"res": {}, "data": {}, "ceil": {}})
                if is_res:
                    grp["res"][name] = packed
                else:
                    grp["ceil"].pop(name, None)
                    grp["data"][name] = packed
        return ScenarioPack(plan=plan, labels=self.labels, scenarios=scenarios,
                            bat_idx=self.bat_idx, loop_idx=self.loop_idx,
                            reason=self.reason, proc_args=proc_args,
                            loop_reasons=dict(self.loop_reasons),
                            ramps=_compute_ramps(proc_args))


def _compute_ramps(proc_args: dict[str, dict[str, dict[str, BPL]]]) -> bool:
    """True when the packed batch needs the torch engine's quadratic class."""
    for args in proc_args.values():
        for bpl in args.get("res", {}).values():
            if bpl.max_degree() >= 1:
                return True
        for grp in ("data", "ceil"):
            for bpl in args.get(grp, {}).values():
                if bpl.max_degree() >= 2:
                    return True
    return False


def _resolve_override_fns(value, base: PPoly, B: int, is_res: bool,
                          speed_up_data) -> list[PPoly]:
    def one(v) -> PPoly:
        if isinstance(v, PPoly):
            return v
        return base * float(v) if is_res else speed_up_data(base, float(v))

    # np.isscalar is False for 0-d arrays (np.array(2.0)) and unreliable
    # across numpy scalar kinds — monitoring feeds hand us exactly those
    is_scalar = (np.isscalar(value) or isinstance(value, np.generic)
                 or (isinstance(value, np.ndarray) and value.ndim == 0))
    if isinstance(value, PPoly) or is_scalar:
        fn = one(value)
        return [fn] * B
    fns = [one(v) for v in value]
    if len(fns) != B:
        raise ValueError(
            f"override sequence has {len(fns)} entries for B={B} scenarios")
    return fns


def _pack_proc_args(plan: Any, bats: list[Scenario],
                    ) -> dict[str, dict[str, dict[str, BPL]]]:
    """The per-call packing previously done inside the sweep, hoisted out.

    Must mirror the numpy runner's expectations exactly — the bit-identity
    of ``plan.sweep(pack)`` vs ``plan.sweep(list)`` on the numpy backend is
    asserted by the test suite.
    """
    out: dict[str, dict[str, dict[str, BPL]]] = {}
    for name in plan.order:
        proc = plan.workflow.processes[name]
        args: dict[str, dict[str, BPL]] = {"res": {}, "data": {}, "ceil": {}}
        edge_deps = {dep for (_s, _o, dep) in plan.edges_in[name]}
        for dep in proc.data:
            if dep in edge_deps:
                continue  # pipelined: composed from upstream progress in-solve
            key = (name, dep)
            over = [sc.data_inputs.get(key) for sc in bats]
            if any(o is not None for o in over):
                fns = [o if o is not None else plan.base_data[key]
                       for o in over]
                args["data"][dep] = BPL.from_ppolys(fns)
            elif key in plan._base_ceil_row:
                args["ceil"][dep] = plan._base_ceil_row[key]
            else:
                args["data"][dep] = BPL.from_ppolys([plan.base_data[key]])
        for r in proc.resources:
            key = (name, r)
            over = [sc.resource_inputs.get(key) for sc in bats]
            if any(o is not None for o in over):
                fns = [o if o is not None else plan.base_res[key]
                       for o in over]
                args["res"][r] = BPL.from_ppolys(fns)
            else:
                args["res"][r] = plan._base_res_row[key]
        out[name] = args
    return out
