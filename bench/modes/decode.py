"""Greedy batch decode over a long cache: ``batch`` sequences decode one
token a step through ``decode_step``; each step's tokens go to the host
(``argmax``, then a copy) and are fed back, as ``launch/serve.py`` does.

Set-up builds the program's cache of ``context`` positions per layer
(``init_cache``) and fills its first ``prefix`` positions with seeded keys
and values, inputs given to the program and the reference alike, which
stand in for a prefill that writes the cache. Round ``r`` decodes from
position ``prefix`` with seeded start tokens until the cache's end, then
round ``r + 1`` starts again at ``prefix``; no step passes the cache's end.

Each step is timed on the device's clock (CUDA events) from its start to
its tokens in host memory. Cell keys: ``batch``, ``context``, ``prefix``,
``sample`` (sequences checked), ``trace_steps``,
``limits.max_token_gap``.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from ..harness import traffic
from ..harness.core import Outcome, Run, dtype_of, log, model_for, since
from ..harness.seeds import derive, spread_rows
from ..harness.trace import traced
from ..harness.weights import make_weights
from ..work import lm


class _Clock:
    """Per-step times: CUDA events on the card, the host clock elsewhere
    (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, begun) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            self.marks.append((begun, e))
        else:
            self.marks.append((begun, time.perf_counter()))

    def ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def fill_cache(r: Run, cache: dict) -> None:
    """Positions 0 .. prefix - 1 of every layer from the seed; the rest is
    the program's zeros."""
    k, v = cache["pos0"]["k"], cache["pos0"]["v"]     # (layers, B, Hk, ctx, Dh)
    shape = (*k.shape[1:3], r.cell["prefix"], k.shape[4])
    for layer in range(k.shape[0]):
        for which, t in (("k", k), ("v", v)):
            t[layer, :, :, :shape[2]] = traffic.prefix_kv(r.seed, layer, which, shape,
                                                          t.dtype, r.device)


def run(r: Run) -> Outcome:
    c, m = r.cell, r.m
    B, ctx, P0 = c["batch"], c["context"], c["prefix"]
    V = m["vocab_size"]
    log(r, "start")
    weights = make_weights(r.family, m, r.seed, r.device, dtype_of(m))
    T, cfg, model = model_for(r, weights)
    r.sync()
    log(r, "weights made")
    cuda = r.device.type == "cuda"
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, ctx, r.device)
        fill_cache(r, cache)
        host = torch.empty((B, 1), dtype=torch.long, pin_memory=cuda)
        state = {"pos": P0, "round": 0,
                 "tok": traffic.start_tokens(r.seed, 0, B, V).to(r.device)}
        served: list[torch.Tensor] = []            # round 0's tokens, on the host
        enqueue: list[float] = []
        clock = _Clock(r.device)

        def step(keep: bool) -> None:
            begun = clock.start()
            h0 = time.perf_counter()
            logits, _ = T.decode_step(model, cfg, cache, {"tokens": state["tok"]},
                                      state["pos"])
            enqueue.append(time.perf_counter() - h0)
            tok = torch.argmax(logits, dim=-1)[:, None]
            host.copy_(tok, non_blocking=cuda)
            clock.stop(begun)
            if keep and state["round"] == 0:
                served.append(host[:, 0].clone())
            state["tok"] = tok
            state["pos"] += 1
            if state["pos"] == ctx:
                state["round"] += 1
                state["pos"] = P0
                state["tok"] = traffic.start_tokens(r.seed, state["round"], B, V).to(r.device)

        step(keep=False)                           # warm-up at the cell's one shape
        state.update(pos=P0, tok=traffic.start_tokens(r.seed, 0, B, V).to(r.device))
        clock.marks.clear()
        enqueue.clear()
        r.sync()
        setup_s = since(r.t0)
        log(r, "cache filled, warmed up; window opens")
        setup_peak = r.peak_bytes()
        r.reset_peak()
        positions = []
        t0 = time.perf_counter()
        while not positions or time.perf_counter() - t0 < r.seconds:
            positions.append(state["pos"])
            step(keep=True)
        window_s = since(t0)
        window_peak = r.peak_bytes()
        step_ms = clock.ms()
        host_ms = [s * 1e3 for s in enqueue]
        trace, traced_pos = None, []
        if r.trace:
            def slice_() -> None:
                for _ in range(c["trace_steps"]):
                    traced_pos.append(state["pos"])
                    step(keep=False)
            trace = traced(slice_, r.sync)
        peak = max(setup_peak, window_peak, r.peak_bytes())
    del model, cache
    r.free()
    log(r, f"window closed after {len(positions)} steps; reference")

    steps = len(positions)
    layer = {"window_s": window_s, "steps": steps,
             "flops": sum(lm.decode_step(r.family, m, B, p) for p in positions),
             "peak_window_bytes": window_peak, "host_ms": host_ms,
             "traced_positions": traced_pos, "batch": B}
    gap, ctl = check(r, weights, served)
    log(r, "reference done")
    return Outcome(setup_s=setup_s,
                   end_to_end={"tokens_per_s": steps * B / window_s,
                               "step_p95_ms": statistics.quantiles(
                                   step_ms, n=20, method="inclusive")[18]},
                   attempted=steps * B, failed=0, memory_peak_bytes=peak,
                   checks={"max_token_gap": (gap, c["limits"]["max_token_gap"])},
                   layer=layer, trace=trace,
                   control={"max_token_gap": ctl} if ctl is not None else {})


def check(r: Run, weights: dict, served: list[torch.Tensor], block: int = 256):
    """For ``sample`` sequences of round 0 drawn from the seed, spread over
    the batch (one from each of ``sample`` contiguous strata): the widest
    gap by which a served token's float32 reference logit lies below the
    reference's best at its position, over every served token. With
    ``r.control`` also the gap of the token the fp8 control puts first."""
    ref = r.family
    c, m = r.cell, r.m
    B, P0 = c["batch"], c["prefix"]
    rng = random.Random(derive(r.seed, "sample"))
    rows = torch.tensor(sorted(set(spread_rows(rng, B, c["sample"]))))
    out = torch.stack(served, dim=1)[rows]                      # (n, steps) served
    start = traffic.start_tokens(r.seed, 0, B, m["vocab_size"])[rows]
    fed = torch.cat([start, out[:, :-1]], dim=1).to(r.device)  # tokens fed per step
    shape = (B, m["n_kv_heads"], P0, m["head_dim"])

    def prefix(layer: int):
        return tuple(traffic.prefix_kv(r.seed, layer, w, shape, dtype_of(m),
                                       r.device)[rows.to(r.device)] for w in ("k", "v"))

    h = ref.hidden(weights, m, fed, pos0=P0, prefix=prefix)
    low = ref.hidden(weights, m, fed, pos0=P0, prefix=prefix, precision="fp8") \
        if r.control else None
    out = out.to(r.device)
    gap, ctl = 0.0, 0.0
    for a in range(0, fed.shape[1], block):
        want = ref.logits(weights, h[:, a:a + block])
        best = want.max(dim=-1).values
        at = want.gather(-1, out[:, a:a + block, None])[..., 0]
        gap = max(gap, float((best - at).max()))
        if low is not None:
            first = ref.logits(weights, low[:, a:a + block], precision="fp8").argmax(-1)
            ctl = max(ctl, float((best - want.gather(-1, first[..., None])[..., 0]).max()))
    return gap, (ctl if low is not None else None)
