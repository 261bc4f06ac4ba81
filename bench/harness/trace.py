"""The traced slice of a run: ``torch.profiler`` over a few calls after the
measured window, reduced to the device's busy time, its idle gaps named by
what the host was doing, and the device operations with their times, which
the per-layer metrics read (``bench/metrics``)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

WINDOW = "bench.traced_window"
#: device operations' names are cut to this length in the breakdown
NAME_CHARS = 160


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: (name, seconds) of every device operation in the traced window
    device_events: list[tuple[str, float]] = field(default_factory=list)
    #: (what the host was doing, seconds) of every idle gap
    gaps: list[tuple[str, float]] = field(default_factory=list)

    def top_ops(self, n: int = 10) -> list[list]:
        return _top(self.device_events, n)

    def top_gaps(self, n: int = 10) -> list[list]:
        return _top(self.gaps, n)

    def kernel_seconds(self, names: tuple[str, ...]) -> tuple[int, float]:
        """(launches, seconds) of the device operations whose name holds
        any of ``names``."""
        hits = [s for n, s in self.device_events if any(k in n for k in names)]
        return len(hits), sum(hits)


def _top(pairs: list[tuple[str, float]], n: int) -> list[list]:
    total: dict[str, float] = defaultdict(float)
    for name, s in pairs:
        total[name] += s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def traced(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` (which ends in ``sync``) under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            sync()
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """Busy time as the union of the device intervals inside the window
    span (whose length, on the profiler's clock, is the traced window);
    gaps between them, each named by the innermost host operation running
    at its middle. ``window_s`` stands in only if the span is missing."""
    host, dev, span = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name == WINDOW:
            # the annotation is mirrored on the device's timeline: no work
            if e.device_type.name != "CUDA":
                span = (a, b)
        elif e.device_type.name == "CUDA":
            dev.append((a, b, e.name[:NAME_CHARS]))
        else:
            host.append((a, b, e.name))
    if span is None:
        return Trace(window_s, 0.0)
    dev = sorted((max(a, span[0]), min(b, span[1]), n) for a, b, n in dev
                 if b > span[0] and a < span[1])
    busy_us, gaps, cursor = 0.0, [], span[0]
    for a, b, _ in dev:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy_us += b - max(a, cursor)
            cursor = b
    if span[1] > cursor:
        gaps.append((cursor, span[1]))
    name_at = _innermost(host)
    named = [(name_at((a + b) / 2), (b - a) * 1e-6) for a, b in gaps]
    return Trace((span[1] - span[0]) * 1e-6, busy_us * 1e-6,
                 [(n, (b - a) * 1e-6) for a, b, n in dev], named)


def _innermost(host: list[tuple[float, float, str]]):
    """t -> the name of the latest-starting host operation that covers t.
    Operations sorted by start; a running maximum of their ends stops the
    backward scan once no earlier operation reaches t."""
    host = sorted(host)
    starts = [h[0] for h in host]
    reach, top = [], float("-inf")
    for _, b, _ in host:
        top = max(top, b)
        reach.append(top)

    def name_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if host[i][1] >= t:
                return host[i][2]
            i -= 1
        return "host: outside any op"

    return name_at
