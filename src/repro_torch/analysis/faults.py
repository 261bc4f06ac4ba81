"""Deterministic fault injection for the analysis service.

The fault-tolerance guarantees of :class:`~repro_torch.analysis.serve.AnalysisService`
(worker supervision, deadlines, load shedding, retries, numpy degradation)
are only honest if every failure mode is *exercised*, not just coded for.
A :class:`FaultPlan` is the forcing function: the service consults it at
four deterministic points of its worker loop —

* **admission** (:meth:`FaultPlan.corrupt_request`): replace the Nth
  accepted request's scenarios with a malformed override (unknown process),
  exercising the poisoned-query isolation + bounded-retry path,
* **drain start** (:meth:`FaultPlan.on_drain`): sleep ``delay_s`` (drive
  requests past their deadline) and/or raise on the Nth drain
  (``kill_worker_at`` — the supervisor must catch it, fail the in-flight
  futures with a typed ``ServiceCrashed``, and restart the loop),
* **before each sweep** (:meth:`FaultPlan.before_sweep`): raise on the Nth
  fused sweep call (``fail_sweep`` — a transient engine error the retry
  machinery must absorb),
* **after each sweep** (:meth:`FaultPlan.after_sweep`): overwrite the given
  rows of the sweep output with NaN (``nan_rows`` — compiled-engine garbage
  the non-finite guard must catch and re-run on the numpy reference twin).

The durability layer adds three more, consulted by
:class:`~repro_torch.analysis.artifacts.ArtifactStore` and
:class:`~repro_torch.analysis.journal.Journal`: ``corrupt_artifact`` (XOR-flip
bytes of the Nth artifact write — load must reject it and compile cold),
``stale_artifact_version`` (stamp the Nth write with a future format — load
must refuse it typed), and ``torn_journal_write`` (persist only a prefix of
the Nth journal record and die — recovery must truncate and replay).

Counters are plain ints advanced only by the single worker thread (and
``corrupt_request`` under the service lock), so a plan's firing order is
bit-deterministic for a given request sequence: no wall-clock randomness,
no races.  Plans are single-use — build a fresh one per service.

::

    plan = FaultPlan(kill_worker_at=1)           # first drain dies
    svc = AnalysisService(workflow, faults=plan)

    FaultPlan(nan_rows=(0, 3), nan_sweep=None)   # poison rows of EVERY sweep
    FaultPlan(delay_s=0.05)                      # first drain sleeps 50 ms
    FaultPlan(fail_sweep=1)                      # first sweep call raises
    FaultPlan(malformed_request=2)               # 2nd request goes malformed
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:
    from .report import Report

__all__ = ["FaultInjected", "FaultPlan", "malformed_spec"]


class FaultInjected(RuntimeError):
    """An error raised on purpose by a :class:`FaultPlan` hook."""


def malformed_spec():
    """A scenario spec whose override targets a process that cannot exist —
    the canonical malformed client request (fails at resolution time)."""
    from .scenarios import ScenarioSpec

    return ScenarioSpec(label="malformed-override",
                        resources={("__fault_injected__", "cpu"): 2.0})


@dataclass
class FaultPlan:
    """A deterministic failure schedule for one service (module docstring).

    All indices are 1-based counts of the event they name (drains, sweep
    calls, accepted requests); ``None`` disables that fault.
    """

    #: raise :class:`FaultInjected` at the start of this drain — the worker
    #: dies outside every per-request guard, so only the supervisor saves it
    kill_worker_at: int | None = None
    #: sleep this long at the start of a drain (before deadline checks)
    delay_s: float = 0.0
    #: how many drains the delay applies to (deterministic, not "while set")
    delay_drains: int = 1
    #: raise :class:`FaultInjected` on this fused sweep call (1-based) —
    #: a transient engine failure; retries see a healthy engine afterwards
    fail_sweep: int | None = None
    #: overwrite these rows of the sweep output (makespan + every per-process
    #: finish) with NaN — simulated compiled-engine garbage
    nan_rows: Sequence[int] | None = None
    #: which sweep call ``nan_rows`` poisons; ``None`` poisons every sweep
    nan_sweep: int | None = 1
    #: replace this accepted request's scenarios with ``malformed_spec()``
    malformed_request: int | None = None
    #: XOR-flip bytes of this artifact-store write (1-based) — bit rot the
    #: loader's digest verification must reject, degrading to a cold compile
    corrupt_artifact: int | None = None
    #: stamp this artifact-store write with a bogus future format version —
    #: the loader must refuse it with a typed error, never half-parse it
    stale_artifact_version: int | None = None
    #: persist only a torn prefix of this journal append (1-based) and raise
    #: as if the writer died mid-write — recovery must truncate and replay
    torn_journal_write: int | None = None

    _drains: int = field(default=0, repr=False)
    _sweeps: int = field(default=0, repr=False)

    # -- hooks (called by AnalysisService) ---------------------------------
    def on_drain(self) -> None:
        """Worker drain started: maybe delay, maybe kill the worker."""
        self._drains += 1
        if self.delay_s > 0.0 and self._drains <= self.delay_drains:
            time.sleep(self.delay_s)
        if self.kill_worker_at is not None and \
                self._drains == self.kill_worker_at:
            raise FaultInjected(
                f"fault injection: kill-worker (drain {self._drains})")

    def before_sweep(self) -> None:
        """A fused sweep is about to run: maybe fail it."""
        self._sweeps += 1
        if self.fail_sweep is not None and self._sweeps == self.fail_sweep:
            raise FaultInjected(
                f"fault injection: fail-sweep (sweep call {self._sweeps})")

    def after_sweep(self, rep: "Report") -> "Report":
        """A fused sweep returned: maybe poison rows of its output."""
        if self.nan_rows and (self.nan_sweep is None
                              or self._sweeps == self.nan_sweep):
            rows = [i for i in self.nan_rows if 0 <= i < rep.B]
            if rows:
                rep.makespans[rows] = np.nan
                for n in rep.order:
                    rep.finish[n][rows] = np.nan
        return rep

    def corrupt_request(self, request_index: int, scenarios: list) -> list:
        """Request ``request_index`` (1-based) was accepted: maybe replace
        its scenarios with a malformed override."""
        if self.malformed_request is not None and \
                request_index == self.malformed_request:
            return [malformed_spec()]
        return scenarios

    # -- durability hooks (called by ArtifactStore / Journal) --------------
    def artifact_format(self, write_index: int, fmt: int) -> int:
        """Artifact write ``write_index`` (1-based) is being stamped: maybe
        stamp a bogus future format version instead."""
        if self.stale_artifact_version is not None and \
                write_index == self.stale_artifact_version:
            return 999
        return fmt

    def mutate_artifact(self, write_index: int, data: bytes) -> bytes:
        """Artifact write ``write_index`` is about to hit disk: maybe
        XOR-flip a byte span in its middle (simulated bit rot; the write
        itself still completes atomically)."""
        if self.corrupt_artifact is not None and \
                write_index == self.corrupt_artifact:
            mid = len(data) // 2
            span = data[mid:mid + 64]
            data = data[:mid] + bytes(b ^ 0xFF for b in span) \
                + data[mid + len(span):]
        return data

    def tear_journal(self, record_index: int) -> bool:
        """Journal append ``record_index`` (1-based) is about to be written:
        True means persist only a torn prefix and die (the
        :class:`~repro_torch.analysis.journal.Journal` raises after fsyncing the
        partial record)."""
        return self.torn_journal_write is not None and \
            record_index == self.torn_journal_write
