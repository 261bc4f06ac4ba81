"""The unified analysis result — one `Report` for scalar and batched queries.

Every query on a :class:`~repro_torch.analysis.plan.CompiledWorkflow` —
``solve()``, ``sweep(...)``, ``whatif(...)`` — returns a :class:`Report`
with the same accessors:

* ``makespan`` — float (scalar queries) or ``(B,)`` array (sweeps),
* ``finish(name)`` / ``finish[name]`` — per-process finish times,
* ``timeline(i)`` — the ``(t0, t1, process, kind, name)`` bottleneck timeline,
* ``shares(i)`` — per-factor bottleneck shares sorted by seconds,
* ``top_k(k)`` — scenario ranking by makespan.

Batched reports additionally expose the curve queries, which run as CUDA
kernels on the plan's device (:meth:`Report.sample_progress`,
:meth:`Report.data_ceiling`, :meth:`Report.kernel_finish_times`), and record
the backend every scenario actually ran on (``backends`` — ``"torch"`` /
``"batched"`` fast paths vs ``"loop"`` scalar fallback).

A curve query moves little besides its result: the piece tables of a
process go to the device once per Report and stay there (a Report is not
changed after it is built; :meth:`Report.subset` and
:func:`concat_reports` build new ones, without the tables), the query
points go as one ``(T,)`` row that the device broadcasts to every scenario,
and each result comes back by one copy to the host.  The values
are those of the same ops on the same float32 inputs packed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np
import torch

if TYPE_CHECKING:  # imported lazily at runtime to keep the package acyclic
    from repro_torch.core.solver import ProgressResult
    from repro_torch.sweep.batch import Scenario
    from repro_torch.sweep.engine import BatchProcResult

    from .plan import CompiledWorkflow

__all__ = ["BottleneckRow", "FinishTimes", "Report", "concat_reports",
           "report_from_scalar"]


@dataclass
class BottleneckRow:
    """One (process, limiting factor) share of one scenario — mirrors
    :class:`repro_torch.core.bottleneck.BottleneckShare`."""

    process: str
    kind: str
    name: str
    seconds: float
    fraction: float


class FinishTimes(dict[str, np.ndarray]):
    """Per-process finish times: a mapping AND the unified accessor.

    ``report.finish["dl1"]`` returns the raw ``(B,)`` array (back-compat
    with the original ``SweepResult.finish`` dict); ``report.finish("dl1")``
    returns a float for scalar reports and the array for sweeps.
    """

    scalar: bool = False

    def __call__(self, name: str) -> Any:
        arr = self[name]
        return float(arr[0]) if self.scalar else arr


@dataclass
class Report:
    """Unified analysis of one scenario (scalar) or B scenarios (sweep)."""

    labels: list[str]
    order: list[str]
    makespans: np.ndarray                      # (B,)
    finish: FinishTimes                        # per process (B,)
    factors: list[tuple[str, str, str]]        # (process, kind, name)
    share_seconds: np.ndarray                  # (B, n_factors)
    share_fractions: np.ndarray                # (B, n_factors) of proc runtime
    backends: list[str]                        # per scenario: batched|loop|scalar
    proc_results: dict[str, BatchProcResult] | None = None
    scalar_results: dict[str, ProgressResult] | None = None
    plan: CompiledWorkflow | None = field(default=None, repr=False, compare=False)
    scenarios: list[Scenario] | None = field(default=None, repr=False, compare=False)
    #: scenario index -> why it fell off the batched function class (with
    #: the offending input's degree/shape); None when nothing fell back
    fallback_reasons: dict[int, str] | None = field(
        default=None, repr=False, compare=False)
    #: why the torch engine declined the batched partition mid-sweep
    #: (e.g. iteration-ladder exhaustion) and the numpy engine ran it
    #: instead; None when the requested engine ran
    engine_fallback: str | None = field(default=None, repr=False,
                                        compare=False)
    _drill_cache: dict[int, dict[str, ProgressResult]] = field(
        default_factory=dict, repr=False, compare=False)
    #: (kind, process) -> the curve queries' (starts, coeffs) on the device
    _tables_cache: dict[tuple[str, str], tuple[torch.Tensor, torch.Tensor]] = \
        field(default_factory=dict, repr=False, compare=False)

    # -- shape / mode -------------------------------------------------------
    @property
    def B(self) -> int:
        return len(self.makespans)

    @property
    def is_scalar(self) -> bool:
        """True for reports of a single scalar query (solve / whatif)."""
        return self.backends == ["scalar"]

    @property
    def backend(self) -> str:
        """Aggregate backend: ``torch`` / ``batched`` / ``loop`` / ``scalar``
        / ``mixed``."""
        kinds = set(self.backends)
        return self.backends[0] if len(kinds) == 1 else "mixed"

    @property
    def fallback_indices(self) -> list[int]:
        """Scenario indices that fell back to the scalar ``loop`` backend."""
        if self.is_scalar:
            return []
        return [i for i, b in enumerate(self.backends) if b == "loop"]

    @property
    def degraded_indices(self) -> list[int]:
        """Scenario indices the serving tier re-ran on the numpy reference
        twin after the compiled engine produced garbage (see
        ``AnalysisService`` "Engine degradation")."""
        return [i for i, b in enumerate(self.backends) if b == "degraded"]

    @property
    def nonfinite_indices(self) -> list[int]:
        """Rows whose makespan or any finish time is non-finite.

        Note an ``inf`` makespan is a *legitimate* model output (the
        scenario never finishes under its inputs); ``nan`` never is — see
        :attr:`nan_indices` for the garbage-only set.
        """
        bad = ~np.isfinite(self.makespans)
        for arr in self.finish.values():
            bad = bad | ~np.isfinite(arr)
        return [int(i) for i in np.nonzero(bad)[0]]

    @property
    def nan_indices(self) -> list[int]:
        """Rows whose makespan or any finish time is NaN — unambiguous
        engine garbage (a healthy engine returns finite times or ``inf``,
        never NaN); the analysis service's non-finite guard keys on this."""
        bad = np.isnan(self.makespans)
        for arr in self.finish.values():
            bad = bad | np.isnan(arr)
        return [int(i) for i in np.nonzero(bad)[0]]

    def subset(self, indices: "Iterable[int]") -> "Report":
        """A row-subset copy of a batched report.

        Used by the analysis service to hand each coalesced client exactly
        its own scenarios out of one fused sweep.  Shares the factor axis
        with the parent; drops the engine-level ``proc_results`` (drill-down
        queries re-solve through ``plan``/``scenarios``, which are kept).
        """
        if self.is_scalar:
            raise ValueError("subset() applies to batched (sweep) reports")
        idx = np.asarray(list(indices), dtype=int)
        return Report(
            labels=[self.labels[i] for i in idx],
            order=list(self.order),
            makespans=self.makespans[idx],
            finish=FinishTimes({n: a[idx] for n, a in self.finish.items()}),
            factors=list(self.factors),
            share_seconds=self.share_seconds[idx],
            share_fractions=self.share_fractions[idx],
            backends=[self.backends[i] for i in idx],
            plan=self.plan,
            scenarios=([self.scenarios[i] for i in idx]
                       if self.scenarios is not None else None),
            fallback_reasons=({j: self.fallback_reasons[int(i)]
                               for j, i in enumerate(idx)
                               if int(i) in self.fallback_reasons}
                              if self.fallback_reasons else None) or None,
            engine_fallback=self.engine_fallback)

    def summary(self) -> str:
        """Human-readable digest: backend routing (surfacing the
        scalar-fallback rate), makespan spread, and the best scenario."""
        if self.is_scalar:
            return (f"scalar analysis '{self.labels[0]}': "
                    f"makespan={float(self.makespans[0]):.6g}s, "
                    f"{len(self.factors)} bottleneck factor(s)")
        counts: dict[str, int] = {}
        for b in self.backends:
            counts[b] = counts.get(b, 0) + 1
        routing = ", ".join(f"{counts[b]} {b}" for b in
                            ("torch", "batched", "degraded", "loop")
                            if b in counts)
        lines = [f"sweep of {self.B} scenario(s) [{routing}]"]
        deg = self.degraded_indices
        if deg:
            lines.append(
                f"degraded: {len(deg)}/{self.B} scenario(s) re-ran on the "
                "numpy reference engine after the compiled engine "
                "misbehaved" + (f" ({self.engine_fallback})"
                                if self.engine_fallback else ""))
        fb = self.fallback_indices
        if fb:
            shown = ", ".join(str(i) for i in fb[:10])
            more = f", ... (+{len(fb) - 10} more)" if len(fb) > 10 else ""
            lines.append(
                f"scalar fallback: {len(fb)}/{self.B} scenario(s) "
                f"({len(fb) / self.B:.2%}) ran on the loop backend "
                f"(indices [{shown}{more}])")
            if self.fallback_reasons:
                census: dict[str, int] = {}
                for i in fb:
                    r = self.fallback_reasons.get(i)
                    if r is not None:
                        census[r] = census.get(r, 0) + 1
                for r, c in sorted(census.items(), key=lambda kv: -kv[1])[:3]:
                    lines.append(f"  - {r} (x{c})")
        finite = self.makespans[np.isfinite(self.makespans)]
        if len(finite):
            i, label, ms = self.top_k(1)[0]
            lines.append(f"makespan: best={ms:.6g}s (scenario {i}: {label!r}), "
                         f"median={float(np.median(finite)):.6g}s, "
                         f"worst={float(finite.max()):.6g}s")
        n_inf = int((~np.isfinite(self.makespans)).sum())
        if n_inf:
            lines.append(f"{n_inf} scenario(s) never finish")
        return "\n".join(lines)

    @property
    def makespan(self) -> Any:
        """Workflow makespan: float for scalar reports, ``(B,)`` for sweeps."""
        return float(self.makespans[0]) if self.is_scalar else self.makespans

    # -- rankings ----------------------------------------------------------
    def top_k(self, k: int = 5) -> list[tuple[int, str, float]]:
        """The k best scenarios: ``(index, label, makespan)`` ascending."""
        idx = np.argsort(self.makespans, kind="stable")[:k]
        return [(int(i), self.labels[int(i)], float(self.makespans[int(i)]))
                for i in idx]

    def best(self) -> int:
        return int(np.argmin(self.makespans))

    # -- attribution --------------------------------------------------------
    def bottleneck_report(self, i: int = 0) -> list[BottleneckRow]:
        """Per-scenario factor shares, sorted by seconds (same contract as
        the scalar :func:`repro_torch.core.bottleneck.bottleneck_report`)."""
        rows = [BottleneckRow(p, kind, name, float(self.share_seconds[i, j]),
                              float(self.share_fractions[i, j]))
                for j, (p, kind, name) in enumerate(self.factors)
                if self.share_seconds[i, j] > 0.0]
        rows.sort(key=lambda r: -r.seconds)
        return rows

    def shares(self, i: int | None = None) -> list[BottleneckRow]:
        """Bottleneck shares of scenario ``i`` (default: the best scenario;
        scalar reports have exactly one)."""
        if i is None:
            i = 0 if self.is_scalar else self.best()
        return self.bottleneck_report(int(i))

    def timeline(self, i: int | None = None) -> list[tuple[float, float, str, str, str]]:
        """Flattened ``(t0, t1, process, kind, name)`` bottleneck timeline of
        scenario ``i`` (default: the best scenario).

        Scalar reports read their exact solver segments; batched reports
        drill down by re-solving the one requested scenario with the exact
        scalar solver (cached) — the sweep engine keeps only aggregated
        shares, not per-scenario segments.
        """
        results = self._segments_for(0 if self.is_scalar else
                                     (self.best() if i is None else int(i)))
        out: list[tuple[float, float, str, str, str]] = []
        for pname in self.order:
            r = results[pname]
            for s in r.segments:
                t1 = min(s.t_end, r.finish_time)
                if t1 > s.t_start:
                    out.append((s.t_start, t1, pname, s.kind, s.name))
        out.sort()
        return out

    def _segments_for(self, i: int) -> dict[str, ProgressResult]:
        if self.is_scalar:
            assert self.scalar_results is not None
            return self.scalar_results
        if i in self._drill_cache:
            return self._drill_cache[i]
        if self.plan is None or self.scenarios is None:
            raise ValueError(
                "timeline() on a sweep report needs the originating compiled "
                "plan; re-run the sweep through CompiledWorkflow.sweep()")
        sc = self.scenarios[i]
        results = self.plan.scalar_results(sc.resource_inputs, sc.data_inputs)
        self._drill_cache[i] = results
        return results

    # -- batched curve queries (CUDA kernels on the plan's device) ----------
    def _proc(self, name: str) -> BatchProcResult:
        if self.proc_results is None:
            raise ValueError(
                "curve queries need the fully-batched backend (this report "
                f"ran {self.backend!r})")
        return self.proc_results[name]

    def _device(self) -> Any:
        if self.plan is None:
            raise ValueError("curve queries need the originating plan")
        return self.plan.device

    def _host_tables(self, kind: str, proc: str) -> tuple[np.ndarray, np.ndarray]:
        """The float32 ``(starts, coeffs)`` of a curve query, packed on the
        host: ``kind="progress"`` gives the (B, P) / (B, P, K) progress
        functions; ``kind="ceilings"`` the data ceilings padded to
        (B, F, P) / (B, F, P, K), an absent piece at ``PAD_START``."""
        from repro_torch.kernels.ppoly_eval import PAD_START

        r = self._proc(proc)
        if kind == "progress":
            return r.progress.kernel_args()
        packs = [c.kernel_args() for c in r.ceilings]
        P = max(s.shape[1] for s, _ in packs)
        F = len(packs)
        K = max(c.shape[-1] for _, c in packs)  # 3 for quadratic ceilings
        starts = np.full((self.B, F, P), PAD_START, np.float32)
        coeffs = np.zeros((self.B, F, P, K), np.float32)
        for f, (s, c) in enumerate(packs):
            starts[:, f, :s.shape[1]] = s
            coeffs[:, f, :s.shape[1], :c.shape[-1]] = c
        return starts, coeffs

    def _tables(self, kind: str, proc: str) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_host_tables` on the plan's device, copied there at the
        first call and kept for the Report's lifetime."""
        key = (kind, proc)
        if key not in self._tables_cache:
            dev = self._device()
            self._tables_cache[key] = tuple(
                torch.as_tensor(a, device=dev)
                for a in self._host_tables(kind, proc))
        return self._tables_cache[key]

    def _levels(self, ts: np.ndarray) -> torch.Tensor:
        """The query points ``ts`` as float32, sent to the device as one
        (T,) row and broadcast there to a (B, T) view."""
        row = torch.as_tensor(np.asarray(ts, np.float32), device=self._device())
        return row.expand(self.B, len(ts))

    def sample_progress(self, proc: str, ts: np.ndarray) -> np.ndarray:
        """``P(t)`` for every scenario at ``ts``: (B, T) float32, evaluated by
        the batched ``ppoly_eval`` kernel."""
        from repro_torch.kernels.ppoly_eval import ppoly_eval

        starts, coeffs = self._tables("progress", proc)
        return ppoly_eval(starts, coeffs, self._levels(ts)).cpu().numpy()

    def data_ceiling(self, proc: str,
                     ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``P_D(t) = min_k R_Dk(I_Dk(t))`` with argmin attribution for every
        scenario at ``ts`` — one ``ppoly_min_eval`` kernel call.

        Returns ``(vals (B,T) float32, argmin (B,T) int32)`` where the argmin
        indexes the process's data deps in declaration order.
        """
        from repro_torch.kernels.ppoly_eval import ppoly_min_eval

        starts, coeffs = self._tables("ceilings", proc)
        vals, arg = ppoly_min_eval(starts, coeffs, self._levels(ts))
        return vals.cpu().numpy(), arg.cpu().numpy()

    def kernel_finish_times(self, proc: str) -> np.ndarray:
        """Finish times re-derived on the device: batched first-crossing of
        each scenario's progress function with ``p_end`` (float32)."""
        from repro_torch.kernels.ppoly_eval import ppoly_first_crossing

        starts, coeffs = self._tables("progress", proc)
        y = torch.full((self.B, 1), self._proc(proc).p_end, dtype=torch.float32,
                       device=starts.device)
        out = ppoly_first_crossing(starts, coeffs, y).cpu().numpy()[:, 0]
        return np.where(out >= 1e29, np.inf, out.astype(np.float64))


def scalar_shares(results: dict[str, ProgressResult], order: Iterable[str],
                  ) -> tuple[list[tuple[str, str, str]], list[float], list[float]]:
    """Factor keys + (seconds, fraction) shares of one scalar solve."""
    from repro_torch.core.bottleneck import aggregate_segments

    keys: list[tuple[str, str, str]] = []
    secs: list[float] = []
    fracs: list[float] = []
    for name in order:
        r = results[name]
        acc, total = aggregate_segments(r.segments, r.t_start, r.finish_time)
        for (kind, fname), s in acc.items():
            keys.append((name, kind, fname))
            secs.append(s)
            fracs.append(s / total)
    return keys, secs, fracs


def concat_reports(reports: "Iterable[Report]") -> Report:
    """Row-concatenate batched reports of one workflow onto a union factor
    axis — the inverse of :meth:`Report.subset`.

    Used by ``AnalysisService.submit_mc`` to stitch a large Monte Carlo draw
    set back together after the coalescing worker swept it in ``max_batch``
    chunks.  Factor columns are matched by ``(process, kind, name)`` key —
    chunks that never saw a factor contribute zero share for it — and
    per-scenario fallback reasons are re-indexed onto the combined axis.
    """
    reps = list(reports)
    if not reps:
        raise ValueError("concat_reports: need at least one report")
    if len(reps) == 1:
        return reps[0]
    if any(r.is_scalar for r in reps):
        raise ValueError("concat_reports applies to batched (sweep) reports")
    order = reps[0].order
    for r in reps[1:]:
        if r.order != order:
            raise ValueError(
                "concat_reports: reports analyze different workflows "
                f"({r.order} vs {order})")
    factors: list[tuple[str, str, str]] = []
    fac_index: dict[tuple[str, str, str], int] = {}
    for r in reps:
        for key in r.factors:
            if key not in fac_index:
                fac_index[key] = len(factors)
                factors.append(key)
    B = sum(r.B for r in reps)
    secs = np.zeros((B, len(factors)))
    fracs = np.zeros((B, len(factors)))
    have_sc = all(r.scenarios is not None for r in reps)
    scenarios: list[Scenario] = []
    fallback_reasons: dict[int, str] = {}
    off = 0
    for r in reps:
        cols = [fac_index[k] for k in r.factors]
        if cols:
            secs[off:off + r.B, cols] = r.share_seconds
            fracs[off:off + r.B, cols] = r.share_fractions
        for i, why in (r.fallback_reasons or {}).items():
            fallback_reasons[off + int(i)] = why
        if have_sc:
            scenarios.extend(r.scenarios)  # type: ignore[arg-type]
        off += r.B
    plan = reps[0].plan
    if any(r.plan is not plan for r in reps):
        plan = None
    return Report(
        labels=[lab for r in reps for lab in r.labels],
        order=list(order),
        makespans=np.concatenate([r.makespans for r in reps]),
        finish=FinishTimes({n: np.concatenate([r.finish[n] for r in reps])
                            for n in order}),
        factors=factors, share_seconds=secs, share_fractions=fracs,
        backends=[b for r in reps for b in r.backends],
        plan=plan, scenarios=scenarios if have_sc else None,
        fallback_reasons=fallback_reasons or None,
        engine_fallback=next(
            (r.engine_fallback for r in reps if r.engine_fallback), None))


def report_from_scalar(results: dict[str, ProgressResult], order: list[str],
                       label: str, plan: CompiledWorkflow | None = None) -> Report:
    """Wrap one exact scalar solve into the unified :class:`Report`."""
    makespan = max((results[n].finish_time for n in order), default=0.0)
    finish = FinishTimes({n: np.array([results[n].finish_time]) for n in order})
    finish.scalar = True
    keys, secs, fracs = scalar_shares(results, order)
    return Report(
        labels=[label], order=list(order), makespans=np.array([makespan]),
        finish=finish, factors=keys,
        share_seconds=np.asarray(secs, np.float64)[None, :],
        share_fractions=np.asarray(fracs, np.float64)[None, :],
        backends=["scalar"], scalar_results=results, plan=plan)
