"""Batch prefill: one caller runs back-to-back ``prefill`` calls on batches
of seeded prompts and takes each call's last-position logits to the host,
as a batch-prefill worker returns them.

Cell keys: ``batch``, ``seq`` (prompt length), ``pool`` (distinct batches
drawn; call ``i`` takes batch ``i % pool``), ``sample`` (answers checked:
at least ``batch``, so that every row of the batch is checked),
``trace_calls`` (calls in the traced slice), ``limits.max_logit_err``.
"""

from __future__ import annotations

import random
import time

import torch

from ..harness import traffic
from ..harness.core import Outcome, Run, dtype_of, log, model_for, since
from ..harness.seeds import derive, spread_rows
from ..harness.trace import traced
from ..harness.weights import make_weights
from ..work import lm


def run(r: Run) -> Outcome:
    c, m = r.cell, r.m
    B, S = c["batch"], c["seq"]
    log(r, "start")
    weights = make_weights(r.family, m, r.seed, r.device, dtype_of(m))
    T, cfg, model = model_for(r, weights)
    pool = traffic.prompts(r.seed, c["pool"], B, S, m["vocab_size"], r.device)
    r.sync()
    log(r, "weights and prompts made")

    def call(i: int) -> torch.Tensor:
        return T.prefill(model, cfg, {"tokens": pool[i % c["pool"]]}).cpu()

    with torch.inference_mode():
        call(0)                                   # warm-up: the cell's one shape
        r.sync()
        setup_s = since(r.t0)
        log(r, "warmed up; window opens")
        setup_peak = r.peak_bytes()
        r.reset_peak()
        outs = []
        t0 = time.perf_counter()
        while not outs or time.perf_counter() - t0 < r.seconds:
            outs.append(call(len(outs)))
        window_s = since(t0)
        window_peak = r.peak_bytes()
        trace = None
        if r.trace:
            n = len(outs)
            trace = traced(lambda: [call(n + j) for j in range(c["trace_calls"])], r.sync)
        peak = max(setup_peak, window_peak, r.peak_bytes())
    del model
    r.free()
    log(r, f"window closed after {len(outs)} calls; reference")

    calls = len(outs)
    tokens = calls * B * S
    layer = {"window_s": window_s, "calls": calls,
             "flops": calls * lm.prefill_call(r.family, m, B, S),
             "peak_window_bytes": window_peak,
             "traced_calls": c["trace_calls"], "batch": B, "seq": S}
    err, ctl = check(r, weights, pool, outs)
    log(r, "reference done")
    return Outcome(setup_s=setup_s,
                   end_to_end={"tokens_per_s": tokens / window_s},
                   attempted=calls * B, failed=0, memory_peak_bytes=peak,
                   checks={"max_logit_err": (err, c["limits"]["max_logit_err"])},
                   layer=layer, trace=trace,
                   control={"max_logit_err": ctl} if ctl is not None else {})


def check(r: Run, weights: dict, pool: torch.Tensor, outs: list[torch.Tensor]):
    """The widest gap between a sampled answer's logits and the float32
    reference's, over ``sample`` (call, row) pairs drawn from the seed: the
    rows spread over the batch (every row once ``sample`` reaches the
    batch), each from a call of the window drawn at random; with
    ``r.control`` also the fp8 control's gap on the same prompts."""
    ref = r.family
    rng = random.Random(derive(r.seed, "sample"))
    picks = [(rng.randrange(len(outs)), b)
             for b in spread_rows(rng, r.cell["batch"], r.cell["sample"])]
    tokens = torch.stack([pool[i % r.cell["pool"], b] for i, b in picks])
    got = torch.stack([outs[i][b] for i, b in picks]).float().to(r.device)
    want = ref.logits(weights, ref.hidden(weights, r.m, tokens, last_only=True))
    err = float((got - want).abs().max())
    ctl = None
    if r.control:
        low = ref.logits(weights, ref.hidden(weights, r.m, tokens, precision="fp8",
                                             last_only=True), precision="fp8")
        ctl = float((low - want).abs().max())
    return err, ctl
