"""The per-layer metrics that read the program's spans
(``repro_torch.runtime.spans``): ``decode.attn_ms``, ``decode.kv_useful``,
``prefill.norm_share`` and ``prefill.head_share``.

On the CPU at smoke size each reads a finite number on its own cells and
None on the others, ``decode.attn_ms`` takes each step's shortest ``attn``
span, two traced drives of different cells in one process do not mix
their spans, and a program without the spans module leaves each silent.
The card test runs the decode cell's model and batch under the profiler:
no device event carries a span's name, the spans' device times are
positive and nest, and the spans move a step's device busy time by less
than 1 %.
"""

from __future__ import annotations

import builtins
import math
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, smoke_cell

from bench import run as R

SPEC = R.load_json(ROOT / "BENCHMARK.json")
METRICS = {p["name"]: p for p in SPEC["per_layer"]
           if p["name"] in ("decode.attn_ms", "decode.kv_useful", "prefill.norm_share",
                            "prefill.head_share")}
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAMES = ("prefill", "decode_step", "norm", "logits", "attn")


def traced_drive(workload: str, seed: int = 2**31 + 77):
    """(the result line, the context the metrics read) of a smoke-size
    ``--trace 1`` drive on the CPU."""
    spec, cell, config = smoke_cell(workload)
    res, out = R.drive(spec, workload, cell, config, seed, 0.3, True,
                       torch.device("cpu"), time.perf_counter())
    ctx = SimpleNamespace(m=config["model"], cell=cell, layer=out.layer, trace=out.trace)
    return res, ctx


def test_the_four_metrics_are_declared():
    assert set(METRICS) == {"decode.attn_ms", "decode.kv_useful", "prefill.norm_share",
                            "prefill.head_share"}
    for p in METRICS.values():
        assert p["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_reads_its_own_cells_and_none_elsewhere(workload):
    res, ctx = traced_drive(workload)
    assert res["correct"]
    for name, p in METRICS.items():
        v = R.metric_reader(name).read(ctx)
        if workload in p["workloads"]:
            assert v is not None and math.isfinite(v), name
            assert res["metrics"][name]["value"] == v
            if p["unit"] == "%":
                assert 0 < v <= 100, (name, v)
            else:
                assert v > 0, (name, v)
        else:
            assert v is None, name
            assert name not in res["metrics"]


def test_kv_useful_counts_the_traced_positions():
    """Smoke decode: a cache of 64 positions, each traced step at position
    p reads all 64, of which p + 1 hold a token."""
    _, ctx = traced_drive("yi-9b.decode-b128")
    pos = ctx.layer["traced_positions"]
    ring = ctx.cell["context"]
    want = 100.0 * sum(min(p + 1, ring) for p in pos) / (ring * len(pos))
    assert R.metric_reader("decode.kv_useful").read(ctx) == pytest.approx(want, rel=1e-12)


def test_attn_ms_takes_the_shortest_span_of_each_step():
    """Each step's attention time is its ``attn`` spans' count times the
    shortest: a span stretched by a wait on the host does not count its
    wait. Two steps of three spans each, one stretched in each."""
    from repro_torch.runtime import spans

    spans.clear()
    with spans.recording():
        for waits in ((0.012, 0.003, 0.003), (0.003, 0.003, 0.020)):
            with spans.span("decode_step"):
                for w in waits:
                    with spans.span("attn"):
                        time.sleep(w)
    ctx = SimpleNamespace(layer={"traced_positions": [0, 1]})
    recs = spans.finished(2, "decode_step")
    shortest = {}
    for r in recs:
        if r.name == "attn":
            shortest[r.root] = min(shortest.get(r.root, math.inf), r.ms)
    v = R.metric_reader("decode.attn_ms").read(ctx)
    assert len(shortest) == 2
    assert v == pytest.approx(sum(3 * x for x in shortest.values()) / 2)
    assert 9.0 <= v < sum(r.ms for r in recs if r.name == "attn") / 2
    spans.clear()


def test_two_drives_do_not_mix_their_spans():
    from repro_torch.runtime import spans

    _, first = traced_drive("yi-9b.prefill-4k")
    before = {r.index for r in spans.finished(root="prefill") if r.parent is None}
    _, second = traced_drive("rwkv6-1.6b.prefill-4k")
    read = spans.finished(second.layer["traced_calls"], "prefill")
    roots = {r.index for r in read if r.parent is None}
    assert len(roots) == second.layer["traced_calls"] and not roots & before
    assert min(roots) > max(before)
    # the decode cell's readers see its own steps, not the prefills'
    _, dec = traced_drive("yi-9b.decode-b128")
    steps = spans.finished(len(dec.layer["traced_positions"]), "decode_step")
    assert {r.name for r in steps if r.parent is None} == {"decode_step"}
    assert len({r.root for r in steps}) == len(dec.layer["traced_positions"])
    for name in ("prefill.norm_share", "prefill.head_share"):
        assert R.metric_reader(name).read(second) is not None


def test_silent_without_the_spans_module(monkeypatch):
    """A program that lacks ``repro_torch.runtime.spans`` (the commit
    before it): each reader returns None and raises nothing."""
    _, ctx = traced_drive("yi-9b.decode-b128")
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch.runtime" and "spans" in (fromlist or ()):
            raise ImportError("no spans")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    for name in METRICS:
        assert R.metric_reader(name).read(ctx) is None


@pytest.mark.requires_cuda
def test_spans_on_the_card_stay_off_the_device_timeline():
    """The decode cell's model and batch on the card (yi-9b at full size,
    bf16, 128 sequences from position 2,048 of a 4,096 cache) and a prefill
    of 1 x 4,096 tokens, under the profiler, whose host cost paces the
    steps as it paces the cell's traced slice. No device event carries a
    span's name; every span is timed on the device and positive; each
    step's ``attn`` spans sum to no more than its ``decode_step``, the
    call's ``norm`` and ``logits`` to no more than its ``prefill``. Over
    48 profiled steps, in turns with spans on and with the sites' ``span``
    the off object, the median busy time of a step (the union of the
    device's operations between the host's stamps around it, each step
    ending in a copy to the host) with spans lies within 1 % of that
    without: a span mirrored onto the device would count the step's idle
    gaps, 5 to 30 % of it, as busy. The busy share itself swings by
    several points from step to step with the host's load (the card's host
    is shared), more than the spans' host time moves it, so it is not
    held here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' device times and the trace")
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from bench.harness.core import program
    from bench.harness.trace import traced
    from bench.harness.weights import make_weights
    from bench.reference import dense_gqa

    T, ModelConfig = program()
    from repro_torch.runtime import spans

    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cell = R.load_json(ROOT / "bench" / "cells" / "yi-9b.decode-b128.json")
    m = R.load_json(ROOT / "bench" / "configs" / "yi-9b.json")["model"]
    cfg = ModelConfig(**m)
    model = T.DecoderLM(cfg, make_weights(dense_gqa, m, 5, dev, torch.bfloat16))
    B, ctx, pos0, steps = cell["batch"], cell["context"], cell["prefix"], 48
    orig, off = T.span, (lambda *a, **k: spans._OFF)
    with torch.inference_mode():
        prompt = torch.randint(0, m["vocab_size"], (1, 4096), device=dev)
        cache = T.init_cache(cfg, B, ctx, dev)
        tok = torch.randint(0, m["vocab_size"], (B, 1), device=dev)

        def prefill():
            T.prefill(model, cfg, {"tokens": prompt})

        def decode(n):
            """n steps, spans on in every second; (on, host start, end) each."""
            marks = []
            try:
                for i in range(n):
                    T.span = orig if i % 2 == 0 else off
                    t0 = time.time_ns()
                    logits, _ = T.decode_step(model, cfg, cache, {"tokens": tok}, pos0 + i)
                    logits.argmax(-1).cpu()
                    marks.append((i % 2 == 0, t0, time.time_ns()))
            finally:
                T.span = orig
            return marks

        prefill()
        with spans.recording():
            decode(16)                     # warm: the kernels and the spans' event pool
        spans.clear()
        pre = traced(prefill, torch.cuda.synchronize)
        calls = spans.finished(1, "prefill")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            marks = decode(steps)
        recs = spans.finished(steps // 2, "decode_step")
    del model, cache
    assert not {n for n, _ in pre.device_events} & set(NAMES)
    events = prof.events()
    assert not {e.name for e in events if e.device_type.name == "CUDA"} & set(NAMES)
    assert len([r for r in recs if r.parent is None]) == steps // 2
    assert {r.name for r in recs if r.parent is not None} == {"attn"}
    assert all(r.on_device and r.ms > 0 for r in recs + calls)
    for top in (r for r in recs if r.parent is None):
        attn = sum(r.ms for r in recs if r.root == top.index and r.name == "attn")
        assert 0 < attn <= top.ms
    top = calls[0]
    assert sum(r.ms for r in calls if r.name in ("norm", "logits")) <= top.ms
    # each step's busy time on the profiler's clock (µs from its start)
    t_start = prof.profiler.kineto_results.trace_start_ns()
    work = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type.name == "CUDA")
    busy = {True: [], False: []}
    for on, a, b in marks:
        a, b = (a - t_start) / 1e3, (b - t_start) / 1e3
        busy[on].append(spans._union([(max(x, a), min(y, b)) for x, y in work
                                      if y > a and x < b]))
    med = {k: statistics.median(v) for k, v in busy.items()}
    assert abs(med[True] / med[False] - 1) < 0.01, (med, busy)
