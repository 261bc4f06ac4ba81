"""Spans inside the model step, on the profiler's clock.

    with span("attn", h.device):
        ...
        count(kv_read=S, kv_valid=n)         # from the code that reads them

A span records only while ``torch.profiler`` is on (torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``) or inside a
:func:`recording` block; otherwise :func:`span` reads that flag and one
module value and returns a shared no-op object.

A recorded span keeps its name, its parent's index and its root's (every
span of one ``prefill`` call or one ``decode_step`` shares its root's
index), its host start and end from ``time.time_ns()``, the counts that
:func:`count` added while it was the innermost open span and, where it was
given a CUDA device, a pair of timing events recorded on the current stream
(taken from a pool; read only by :func:`finished`, never waited for inside
a span). ``time.time_ns()`` is the profiler's clock: a stamp less
``kineto_results.trace_start_ns()`` falls inside the span's own interval on
the profiler's timeline.

Under the profiler a span also enters ``_RecordFunctionFast(name)``: a host
event on the profiler's timeline, which the profiler does not mirror onto
the device's (``record_function`` makes a user annotation, which it does
mirror, so a span made that way would count as device work in a trace's
busy time). A torch build without it still records the span in memory.

The records sit in a ring of :data:`CAPACITY`; :func:`finished` reads them
with their durations and self times, :func:`clear` empties the ring.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _profiler

try:
    _Fast = torch._C._profiler._RecordFunctionFast
except AttributeError:
    _Fast = None

#: records kept; the oldest is dropped first
CAPACITY = 1 << 16

_recording = 0                                   # open ``recording()`` blocks
_ring: list = [None] * CAPACITY
_index = itertools.count()
_local = threading.local()                       # each thread's open spans
_pool: dict[int, list] = {}                      # CUDA device -> free event pairs


@dataclass(frozen=True)
class SpanRecord:
    """A finished span as :func:`finished` reads it."""
    index: int
    name: str
    parent: int | None
    root: int
    start_ns: int                                # host clock (``time.time_ns``)
    end_ns: int
    counts: dict
    ms: float                                    # device ms on CUDA, else host ms
    self_ms: float                               # ``ms`` less the children's union
    on_device: bool


class _Off:
    """What :func:`span` returns while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span, then its record in the ring."""
    __slots__ = ("index", "name", "parent", "root", "t0", "t1", "counts", "device",
                 "events", "stream", "fast", "stack")

    def __init__(self, name: str, device):
        self.name, self.device, self.counts = name, device, {}
        self.t0 = self.t1 = self.events = self.stream = self.fast = None
        self.stack = _stack()

    def __enter__(self):
        stack = self.stack
        up = stack[-1] if stack else None
        self.index = next(_index)
        self.parent = None if up is None else up.index
        self.root = self.index if up is None else up.root
        if _Fast is not None and _profiler._is_profiler_enabled:
            self.fast = _Fast(self.name)
            self.fast.__enter__()
        self.t0 = time.time_ns()
        if self.device is not None and self.device.type == "cuda":
            # a model step runs on one stream: a span inside a timed one
            # takes its stream instead of looking the current one up again
            self.stream = (up.stream if up is not None and up.stream is not None
                           else torch.cuda.current_stream(self.device))
            self.events = _take(self.stream.device_index)
            self.events[0].record(self.stream)
        stack.append(self)
        _keep(self)

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.t1 = time.time_ns()
        self.stack.pop()
        self.stack = None
        if self.fast is not None:
            self.fast.__exit__(None, None, None)
            self.fast = None
        return False


def span(name: str, device=None):
    """A context manager around one piece of the model step: a no-op unless
    the profiler is on or a :func:`recording` block is open. ``device`` (a
    ``torch.device``) adds the device's time on CUDA; give it only where a
    reader wants that time, since the events cost host time."""
    if _profiler._is_profiler_enabled or _recording:
        return _Span(name, device)
    return _OFF


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span's, from the code that does
    the counted work; nothing while spans are off or none is open."""
    if _profiler._is_profiler_enabled or _recording:
        stack = _stack()
        if stack:
            mine = stack[-1].counts
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v


@contextlib.contextmanager
def recording():
    """Record spans inside the block whether or not the profiler is on."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _take(device: int) -> tuple:
    pool = _pool.setdefault(device, [])
    if pool:
        return pool.pop()
    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))


def _give_back(rec: _Span) -> None:
    # an open span's events may still be recorded into: those are dropped
    if rec.events is not None and rec.t1 is not None:
        _pool.setdefault(rec.stream.device_index, []).append(rec.events)


def _keep(rec: _Span) -> None:
    slot = rec.index % CAPACITY
    old = _ring[slot]
    if old is not None:
        _give_back(old)
    _ring[slot] = rec


def clear() -> None:
    """Drop every record (the event pairs go back to the pool)."""
    for i, rec in enumerate(_ring):
        if rec is not None:
            _give_back(rec)
            _ring[i] = None


def finished(last_roots: int | None = None, root: str | None = None) -> list[SpanRecord]:
    """The finished records of the last ``last_roots`` root spans (all if
    None), and of their descendants, in the order they started; with
    ``root``, only roots of that name count. A span is timed on the device
    (``ms`` from its CUDA events, relative to its root's start event) where
    it and its root have events, else on the host clock; its self time is
    its duration less the union of its children's intervals on the same
    clock."""
    recs = sorted((r for r in _ring if r is not None and r.t1 is not None),
                  key=lambda r: r.index)
    by_index = {r.index: r for r in recs}
    roots = [r.index for r in recs if r.parent is None and (root is None or r.name == root)]
    if last_roots is not None:
        roots = roots[max(len(roots) - last_roots, 0):]
    keep = set(roots)
    chosen = [r for r in recs if r.root in keep]
    span_of = {}                                 # index -> (a, b, on the device)
    for r in chosen:
        top = by_index[r.root]
        if r.events is not None and top.events is not None:
            r.events[1].synchronize()
            t = top.events[0]
            span_of[r.index] = (t.elapsed_time(r.events[0]), t.elapsed_time(r.events[1]), True)
        else:
            span_of[r.index] = ((r.t0 - top.t0) * 1e-6, (r.t1 - top.t0) * 1e-6, False)
    children: dict[int, list] = {}
    for r in chosen:
        if r.parent is not None:
            children.setdefault(r.parent, []).append(span_of[r.index])
    out = []
    for r in chosen:
        a, b, dev = span_of[r.index]
        kids = [(max(x, a), min(y, b)) for x, y, d in children.get(r.index, ()) if d == dev]
        out.append(SpanRecord(r.index, r.name, r.parent, r.root, r.t0, r.t1, dict(r.counts),
                              b - a, (b - a) - _union(kids), dev))
    return out


def _union(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by ``intervals``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
