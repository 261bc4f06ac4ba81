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
    plan.sweep(pack.shard(4))               # scenario axis in 4 sub-batches

``shard(n)`` pads the batch to a multiple of ``n`` inside the engine;
results are identical to the unsharded sweep for any B.  On a CUDA plan
shard i runs on ``cuda:i``; on a CPU plan the host runs the sub-batches one
after another.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.ppoly import PPoly
from repro_torch.kernels.ppoly_eval.ref import PAD_START
from repro_torch.sweep.batch import Scenario, ScenarioBatch
from repro_torch.sweep.plin import BPL, UnsupportedScenario, is_batchable_resource
from repro_torch.sweep.torch_engine import shard_devices

__all__ = ["CapAxis", "PwAxis", "ScenarioPack", "ThetaMap"]


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
    shards: int = 1
    #: static degree signature of the packed batch: True when any resource
    #: input ramps (non-zero slope) or any packed function carries a
    #: quadratic plane — selects the torch engine's widened quadratic arithmetic
    ramps: bool = False
    #: per-(B, shards, device) device-tensor memo used by the torch engine
    #: so repeated re-sweeps of one pack skip even the host->device transfer
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
        feed(self.shards)
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
    def shard(self, n: int | None = None) -> "ScenarioPack":
        """A copy of this pack whose batched partition runs in ``n``
        sub-batches (default: every visible CUDA card for a plan on the
        card, 1 on the CPU).

        The engine pads the scenario axis up to a multiple of ``n`` (padding
        rows replicate the last scenario and are dropped), so any B works;
        results are identical to the unsharded sweep.  On a CUDA plan shard
        i runs on ``cuda:i``, so ``n`` may not exceed the visible cards; on
        a CPU plan the host runs the sub-batches one after another, the
        twin of XLA's forced host devices, so any ``n >= 1`` works.
        """
        device = torch.device(self.plan.device)
        if n is None:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
        n = int(n)
        shard_devices(device, n)        # validates n against the devices
        return ScenarioPack(plan=self.plan, labels=self.labels,
                            scenarios=self.scenarios, bat_idx=self.bat_idx,
                            loop_idx=self.loop_idx, reason=self.reason,
                            proc_args=self.proc_args, shards=n,
                            loop_reasons=self.loop_reasons, ramps=self.ramps,
                            # sharded sweeps key device arrays by shard
                            # count, so the memo is safe (and warm) to share
                            _cache=self._cache)

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
                            shards=self.shards, ramps=self.ramps)

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
                            shards=self.shards,
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


# ---------------------------------------------------------------------------
# parameterized overrides: a flat theta vector mapped onto resource caps and
# ramp slopes on the device — the pack axis behind plan.optimize() (no host
# re-packing between candidate evaluations)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CapAxis:
    """Multiplies one resource input's packed planes by ``scale(theta)``.

    ``scale`` maps one theta row (a ``(K,)`` float64 tensor) to a scalar
    tensor with torch ops (plain arithmetic and ``torch`` calls); it is
    batched over the candidates with ``torch.func.vmap`` inside the sweep.
    The factor composes multiplicatively with whatever the pack rows
    already carry — including Monte Carlo draws, which is what keeps common
    random numbers intact under ``optimize(objective=mc_quantile(...))``.
    """

    proc: str
    res: str
    scale: Any  # Callable[[theta (K,)], scalar]


@dataclass(frozen=True)
class PwAxis:
    """Rebuilds one resource input as a theta-dependent piecewise-linear
    function: ``build(theta) -> (starts, c0, c1)``, each of length
    ``pieces`` (torch ops on one ``(K,)`` row, batched with
    ``torch.func.vmap``; make constants with ``theta.new_zeros`` and the
    like so they land on theta's device), with ``c0``/``c1`` the
    value/slope of each piece in LOCAL coordinates ``u = t - start`` — the
    packed-array convention of :class:`repro_torch.sweep.plin.BPL`.

    Breakpoints may depend on ``theta`` — the engine locates pieces by value
    on the device, so gradients flow through moving knots too (e.g. the
    Fig. 7 reallocation instant ``V / (theta * L)``).  Unlike
    :class:`CapAxis` this REPLACES the slot's packed rows, so it cannot
    compose with Monte Carlo draws on the same input
    (:meth:`ThetaMap.validate_spec_overlap`).
    """

    proc: str
    res: str
    pieces: int
    build: Any  # Callable[[theta (K,)], (starts, c0, c1)]


def _set_slot(a, ri: int, pi: int, row):
    """``a`` with its ``[ri, pi]`` plane replaced by ``row`` — out of place,
    so autograd sees the edit: ``a (Lr, Lp, B, P)``, ``row (B, P)``."""
    hit = torch.zeros(a.shape[:2], dtype=torch.bool, device=a.device)
    hit[ri, pi] = True
    return torch.where(hit[:, :, None, None], row, a)


class ThetaMap:
    """Resolved theta axes of one plan: slot coordinates + the applier
    handed to :meth:`repro_torch.sweep.torch_engine.TorchSweepEngine.make_diff_run`.

    Each axis targets one resource input ``proc.res``; resolution maps it to
    its engine coordinates ``(level, slot, process-in-level)`` once, host-
    side.  :meth:`apply` then edits the broadcast ``(Lr, Lp, B, P)`` input
    planes on the device — a multiply for :class:`CapAxis`, a row rebuild
    (widening the piece axis if needed) for :class:`PwAxis` — so a whole
    optimizer step (multi-start × line-search candidates) is one sweep.
    """

    def __init__(self, plan: Any, axes: Sequence[CapAxis | PwAxis]):
        self.plan = plan
        self.axes = tuple(axes)
        self._by_level: dict[int, list[tuple[int, int, Any]]] = {}
        seen: set[tuple[str, str]] = set()
        for ax in self.axes:
            key = (ax.proc, ax.res)
            if key in seen:
                raise ValueError(
                    f"theta axes target {ax.proc}.{ax.res} more than once; "
                    "fold the parameterization into one axis")
            seen.add(key)
            li, pi, ri = self._locate(plan, ax.proc, ax.res)
            self._by_level.setdefault(li, []).append((ri, pi, ax))

    @staticmethod
    def _locate(plan: Any, proc: str, res: str) -> tuple[int, int, int]:
        for li, names in enumerate(plan.levels):
            if proc in names:
                res_names = [lbl for (lbl, *_rest) in plan.res_tables[proc]]
                if res not in res_names:
                    raise KeyError(
                        f"process {proc!r} has no resource {res!r} "
                        f"(has: {', '.join(res_names) or 'none'})")
                return li, list(names).index(proc), res_names.index(res)
        raise KeyError(f"unknown process {proc!r} "
                       f"(workflow has: {', '.join(plan.order)})")

    def validate_spec_overlap(self, keys: Sequence[tuple[str, str]]) -> None:
        """Reject :class:`PwAxis` targets that a Monte Carlo spec also
        perturbs — the rebuild would silently overwrite the draws (a
        :class:`CapAxis` composes multiplicatively and is fine)."""
        perturbed = set(keys)
        for ax in self.axes:
            if isinstance(ax, PwAxis) and (ax.proc, ax.res) in perturbed:
                raise ValueError(
                    f"theta axis rebuilds {ax.proc}.{ax.res}, which the MC "
                    "spec also perturbs; use a cap (scale) axis so the "
                    "draws survive, or move the distribution elsewhere")

    def apply(self, IR: tuple, li: int, theta: torch.Tensor) -> tuple:
        """Edit one level's broadcast resource planes for ``theta``.

        ``IR`` is the ``(starts, c0, c1[, c2])`` tuple of ``(Lr, Lp, B, P)``
        tensors, ``theta`` the ``(B, K)`` candidate batch (row i
        parameterizes scenario row i).  Every edit is out of place, so
        autograd differentiates through it.
        """
        ents = self._by_level.get(li)
        if not ents:
            return IR
        s, *vals = IR                     # vals = [c0, c1] or [c0, c1, c2]
        B = theta.shape[0]
        for ri, pi, ax in ents:
            if isinstance(ax, CapAxis):
                m = torch.func.vmap(ax.scale)(theta)                # (B,)
                vals = [_set_slot(v, ri, pi, v[ri, pi] * m[:, None])
                        for v in vals]
                continue
            ss, v0, v1 = (a.reshape(B, -1)
                          for a in torch.func.vmap(ax.build)(theta))  # (B, Pa)
            Pa, P = ss.shape[-1], s.shape[-1]
            if Pa > P:  # widen every slot of the level; pads never bind
                def wide(a, fill):
                    return torch.cat(
                        [a, a.new_full(a.shape[:-1] + (Pa - P,), fill)], -1)

                s = wide(s, PAD_START)
                vals = [wide(v, 0.0) for v in vals]
                P = Pa
            elif Pa < P:
                ss = torch.cat([ss, ss.new_full((B, P - Pa), PAD_START)], -1)
                v0 = torch.cat([v0, v0.new_zeros((B, P - Pa))], -1)
                v1 = torch.cat([v1, v1.new_zeros((B, P - Pa))], -1)
            s = _set_slot(s, ri, pi, ss)
            vals[0] = _set_slot(vals[0], ri, pi, v0)
            vals[1] = _set_slot(vals[1], ri, pi, v1)
            if len(vals) > 2:             # quadratic plane: rebuilt rows are
                vals[2] = _set_slot(vals[2], ri, pi, v1.new_zeros((B, P)))
        return (s, *vals)

    def materialize(self, theta: np.ndarray, label: str | None = None) -> Any:
        """The HOST-side twin of :meth:`apply`: one concrete scenario spec
        at ``theta``, for the full-report sweep of an accepted optimum (and
        for finite-difference validation against the regular engine)."""
        from .scenarios import override

        th = np.asarray(theta, np.float64)
        row = torch.as_tensor(th)
        res: dict[tuple[str, str], PPoly] = {}
        for ax in self.axes:
            if isinstance(ax, CapAxis):
                base = self.plan.base_res[(ax.proc, ax.res)]
                res[(ax.proc, ax.res)] = base * float(ax.scale(row))
            else:
                ss, v0, v1 = (np.asarray(a, np.float64).reshape(-1)
                              for a in ax.build(row))
                res[(ax.proc, ax.res)] = PPoly(
                    ss, [np.array([v0[i], v1[i]]) for i in range(len(ss))])
        lab = label if label is not None else (
            "theta[" + ", ".join(f"{v:.6g}" for v in th) + "]")
        return override(resources=res, label=lab)
