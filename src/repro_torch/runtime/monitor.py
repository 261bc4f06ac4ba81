"""Progress monitor & straggler detection — paper Sect. 3.3 applied live.

BottleMod's pitch is cheap *online* re-analysis: "it can be repeatedly
executed online with an updated state from monitoring" (Sect. 7).  The
monitor keeps the predicted progress function from the step model and the
measured step durations; any step (or host) running slower than
``threshold ×`` the robust baseline is flagged as a straggler, and the
expected-vs-actual progress gap is recomputed with the paper's machinery
(the measured progress is itself a piecewise-linear ``PPoly``, so every
Sect. 3.3 metric applies to it directly).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core import PPoly


@dataclass
class StragglerEvent:
    step: int
    duration_s: float
    baseline_s: float
    ratio: float
    wall_time: float


@dataclass
class ProgressMonitor:
    predicted_step_s: float | None = None
    window: int = 32
    threshold: float = 2.0
    durations: list = field(default_factory=list)
    events: list = field(default_factory=list)
    _t_start: float | None = None
    _t_last: float | None = None

    def start(self):
        self._t_start = self._t_last = time.perf_counter()
        return self

    def record_step(self, step: int) -> StragglerEvent | None:
        now = time.perf_counter()
        if self._t_last is None:
            # auto-start: online re-analysis loops feed the monitor without
            # ever calling start(); the first record opens the clock and
            # measures nothing (there is no interval yet)
            self._t_start = self._t_last = now
            return None
        dur = now - self._t_last
        self._t_last = now
        self.durations.append(dur)
        base = self.baseline()
        if base is not None and dur > self.threshold * base and len(self.durations) > 5:
            ev = StragglerEvent(step=step, duration_s=dur, baseline_s=base,
                                ratio=dur / base, wall_time=now - self._t_start)
            self.events.append(ev)
            return ev
        return None

    def baseline(self) -> float | None:
        if self.predicted_step_s is not None and len(self.durations) < 5:
            return self.predicted_step_s
        if not self.durations:
            return None
        w = self.durations[-self.window:]
        return float(np.median(w))

    # -- BottleMod-style progress functions ------------------------------------
    def measured_progress(self) -> PPoly:
        """Measured steps-vs-time as a piecewise-linear progress function."""
        ts = np.concatenate([[0.0], np.cumsum(self.durations)])
        return PPoly.pwlinear(ts, np.arange(len(ts), dtype=float))

    def progress_gap(self, predicted: PPoly, at_t: float) -> float:
        """Predicted-minus-measured progress (steps) at wall time ``at_t``."""
        return float(predicted(at_t) - self.measured_progress()(at_t))
