"""Chunk-level discrete-event simulator — the "measured system" stand-in.

The paper validates BottleMod against (a) a real two-VM ffmpeg testbed
(Fig. 7) and (b) the WRENCH/SimGrid discrete-event simulator (Sect. 6).
Neither is available offline, so this module provides both roles:

* **ground truth**: it simulates the *mechanistic* behaviour of the
  evaluation workflow — byte streams move in 64 KiB chunks through
  rate-capped links and CPU-limited pipeline stages, including effects the
  simple BottleMod task models ignore (e.g. task 1's decode CPU overlapping
  its download).
* **performance rival**: like WRENCH/SimGrid it processes one event per
  chunk transfer, so its runtime grows linearly with the simulated data
  volume, while BottleMod's event-driven solver only visits piece
  boundaries.  Reproducing the paper's Sect. 6 scaling argument only needs
  those two runtime curves.

The simulator is deliberately minimal: entities expose ``pull`` semantics on
chunk granularity and an event queue orders chunk completions.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

_INF = float("inf")
CHUNK = 64 * 1024  # 64 KiB — ≈ SimGrid flow granularity


@dataclass
class RateSchedule:
    """Piecewise-constant rate (bytes/s or cpu-s/s) over absolute time."""

    times: list[float]   # segment start times, times[0] == 0
    rates: list[float]

    def rate_at(self, t: float) -> float:
        r = self.rates[0]
        for ts, rr in zip(self.times, self.rates):
            if ts <= t + 1e-12:
                r = rr
            else:
                break
        return r

    def time_to_consume(self, t: float, amount: float) -> float:
        """Finish time for ``amount`` units starting at ``t``."""
        remaining = amount
        cur = t
        idx = 0
        while idx < len(self.times) and self.times[idx] <= cur + 1e-12:
            idx += 1
        while True:
            rate = self.rate_at(cur)
            seg_end = self.times[idx] if idx < len(self.times) else _INF
            if rate <= 0:
                if seg_end is _INF:
                    return _INF
                cur = seg_end
                idx += 1
                continue
            dt = remaining / rate
            if cur + dt <= seg_end + 1e-12:
                return cur + dt
            remaining -= (seg_end - cur) * rate
            cur = seg_end
            idx += 1


class Entity:
    """Base: produces chunks for consumers; pulls chunks from a producer."""

    def __init__(self, name: str, out_size: float):
        self.name = name
        self.out_size = float(out_size)
        self.produced = 0.0
        self.consumers: list["Entity"] = []
        self.finish_time: float | None = None

    # producer side -----------------------------------------------------------
    def push_available(self, sim: "Simulator", t: float, amount: float):
        for c in self.consumers:
            c.on_input(sim, t, amount)

    # consumer side -------------------------------------------------------------
    def on_input(self, sim: "Simulator", t: float, available_total: float):
        raise NotImplementedError

    def start(self, sim: "Simulator"):
        pass


class Source(Entity):
    """Data fully available at t=0 (the video file on the webserver)."""

    def start(self, sim: "Simulator"):
        self.produced = self.out_size
        self.finish_time = 0.0
        self.push_available(sim, 0.0, self.out_size)


class Transfer(Entity):
    """Rate-capped transfer (wget through an nft 'limit rate' cap)."""

    def __init__(self, name: str, size: float, schedule: RateSchedule):
        super().__init__(name, size)
        self.schedule = schedule
        self.available = 0.0
        self.next_evt: float | None = None

    def on_input(self, sim, t, available_total):
        self.available = max(self.available, available_total)
        self._maybe_schedule(sim, t)

    def _maybe_schedule(self, sim, t):
        if self.next_evt is not None or self.produced >= self.out_size:
            return
        if self.available > self.produced:
            chunk = min(CHUNK, self.out_size - self.produced, self.available - self.produced)
            done = self.schedule.time_to_consume(t, chunk)
            self.next_evt = done
            sim.schedule(done, self, chunk)

    def on_event(self, sim, t, chunk):
        self.next_evt = None
        self.produced += chunk
        if self.produced >= self.out_size - 0.5:
            self.produced = self.out_size
            self.finish_time = t
            sim.on_finish(self, t)
        self.push_available(sim, t, self.produced)
        self._maybe_schedule(sim, t)


class Stage(Entity):
    """CPU-limited pipeline stage (an ffmpeg task).

    * ``read_cpu_per_byte``: CPU-seconds consumed per *input* byte while
      reading/decoding (overlaps with upstream arrival).
    * ``gated``: if True (reverse), output starts only after ALL input is
      read (the encode phase); otherwise output streams proportionally to
      input progress.
    * ``write_cpu_per_byte``: CPU-seconds per *output* byte.
    """

    def __init__(self, name: str, in_size: float, out_size: float, *,
                 read_cpu_per_byte: float, write_cpu_per_byte: float,
                 gated: bool, cpu: RateSchedule, start_gate: list["Entity"] | None = None):
        super().__init__(name, out_size)
        self.in_size = float(in_size)
        self.read_cpu_pb = read_cpu_per_byte
        self.write_cpu_pb = write_cpu_per_byte
        self.gated = gated
        self.cpu = cpu
        self.read_done = 0.0
        self.available = 0.0
        self.next_evt: float | None = None
        self.started = start_gate is None or not start_gate
        self.start_gate = start_gate or []

    def on_input(self, sim, t, available_total):
        self.available = max(self.available, available_total)
        self._maybe_schedule(sim, t)

    def on_gate_open(self, sim, t):
        self.started = True
        # gate semantics: all upstream producers finished, so the full input
        # is on disk (multiple producers would otherwise collide on `max`)
        self.available = self.in_size
        self._maybe_schedule(sim, t)

    def _phase(self):
        if self.read_done < self.in_size:
            return "read"
        return "write"

    def _maybe_schedule(self, sim, t):
        if not self.started or self.next_evt is not None or self.finish_time is not None:
            return
        if self._phase() == "read":
            if self.available > self.read_done:
                chunk = min(CHUNK, self.in_size - self.read_done, self.available - self.read_done)
                cpu_need = chunk * self.read_cpu_pb
                done = self.cpu.time_to_consume(t, cpu_need) if cpu_need > 0 else t
                self.next_evt = max(done, t)
                sim.schedule(self.next_evt, self, ("read", chunk))
        else:
            if self.produced < self.out_size:
                chunk = min(CHUNK, self.out_size - self.produced)
                cpu_need = chunk * self.write_cpu_pb
                done = self.cpu.time_to_consume(t, cpu_need) if cpu_need > 0 else t
                self.next_evt = max(done, t)
                sim.schedule(self.next_evt, self, ("write", chunk))

    def on_event(self, sim, t, payload):
        kind, chunk = payload
        self.next_evt = None
        if kind == "read":
            self.read_done += chunk
            if self.read_done >= self.in_size - 0.5:
                self.read_done = self.in_size
            if not self.gated:
                # streaming: output tracks input proportionally (copy-through)
                frac = self.read_done / self.in_size
                self.produced = frac * self.out_size
                self.push_available(sim, t, self.produced)
                if self.read_done >= self.in_size:
                    self.finish_time = t
                    sim.on_finish(self, t)
        else:
            self.produced += chunk
            self.push_available(sim, t, self.produced)
            if self.produced >= self.out_size - 0.5:
                self.produced = self.out_size
                self.finish_time = t
                sim.on_finish(self, t)
        self._maybe_schedule(sim, t)


class Simulator:
    """Event queue over entities; counts events for the Sect. 6 comparison."""

    def __init__(self):
        self.entities: list[Entity] = []
        self.q: list = []
        self.counter = itertools.count()
        self.n_events = 0
        self.now = 0.0
        self.finish_hooks: list = []

    def add(self, e: Entity) -> Entity:
        self.entities.append(e)
        return e

    def pipe(self, src: Entity, dst: Entity):
        src.consumers.append(dst)

    def schedule(self, t: float, entity, payload):
        heapq.heappush(self.q, (t, next(self.counter), entity, payload))

    def on_finish(self, entity: Entity, t: float):
        for e in self.entities:
            if isinstance(e, Stage) and not e.started and entity in e.start_gate:
                if all(g.finish_time is not None for g in e.start_gate):
                    e.on_gate_open(self, t)
        for hook in self.finish_hooks:
            hook(entity, t)

    def run(self) -> float:
        for e in self.entities:
            e.start(self)
        while self.q:
            t, _, entity, payload = heapq.heappop(self.q)
            self.now = t
            self.n_events += 1
            entity.on_event(self, t, payload)
        return self.now
