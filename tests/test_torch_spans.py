"""The spans inside the port's model step (``repro_torch.runtime.spans``).

At smoke size on the CPU, on a dense GQA model (yi-9b), on RWKV-6 and, for
the cache counts, on a window model (h2o-danube-3-4b, a ring buffer of 32):
spans off record nothing and spans on change no output bit; each ``prefill``
call is one root holding its ``norm`` and ``logits`` spans, each
``decode_step`` one holding its ``attn`` spans and nothing else; self times
are durations less the children's union; ``count`` adds to the innermost
open span only; ``kv_read`` and ``kv_valid``, which ``attn_decode`` counts,
against hand counts; under ``torch.profiler``
the spans turn on by themselves and sit on the profiler's timeline as host
events that are no user annotation, at their ``time.time_ns()`` stamps.
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.runtime import spans

B, S, CONTEXT = 2, 16, 64
ARCHS = ["yi-9b", "rwkv6-1.6b"]
NAMES = {"prefill", "decode_step", "norm", "logits", "attn"}


@pytest.fixture(autouse=True)
def _empty_store():
    spans.clear()
    yield
    spans.clear()


def _model(arch):
    cfg = configs.get_smoke_config(arch)
    return cfg, T.DecoderLM(cfg, init_params(cfg, seed=0, device="cpu"))


def _tokens(cfg, n=S):
    return torch.randint(0, cfg.vocab_size, (B, n), generator=torch.Generator().manual_seed(3))


def _run(cfg, model, steps=3, pos0=0):
    """(prefill's logits, each decode step's logits, the cache) from a
    fresh cache."""
    tok = _tokens(cfg)
    with torch.inference_mode():
        first = T.prefill(model, cfg, {"tokens": tok})
        cache = T.init_cache(cfg, B, CONTEXT, "cpu")
        outs = []
        for p in range(pos0, pos0 + steps):
            logits, cache = T.decode_step(model, cfg, cache, {"tokens": tok[:, p % S, None]}, p)
            outs.append(logits)
    return first, outs, cache


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_on_changes_no_bit(arch):
    cfg, model = _model(arch)
    off = _run(cfg, model)
    assert spans.finished() == []
    with spans.recording():
        on = _run(cfg, model)
    assert spans.finished()
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[1], on[1]):
        assert torch.equal(a, b)
    want, got = _leaves(off[2]), _leaves(on[2])
    assert len(want) == len(got) > 0
    assert all(torch.equal(a, b) for a, b in zip(want, got))



@pytest.mark.parametrize("arch", ARCHS)
def test_one_root_per_call_and_step(arch):
    cfg, model = _model(arch)
    steps = 3
    with spans.recording():
        _run(cfg, model, steps=steps)
    recs = spans.finished()
    L = cfg.n_layers
    attn_layers = sum(cfg.layer_kind(i % cfg.period)["mixer"] == "attn" for i in range(L))
    assert attn_layers == (L if arch == "yi-9b" else 0)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["prefill"] + ["decode_step"] * steps
    assert {r.name for r in recs} <= NAMES
    for top in roots:
        kids = [r for r in recs if r.root == top.index and r is not top]
        assert all(r.parent == top.index for r in kids)
        names = [r.name for r in kids]
        if top.name == "prefill":
            assert sorted(names) == sorted(["norm"] * 2 * L + ["logits"])
        else:
            assert names == ["attn"] * attn_layers
        assert all(r.start_ns >= top.start_ns and r.end_ns <= top.end_ns for r in kids)
    # the last roots, and by name
    assert [r.index for r in spans.finished(1)] == [
        r.index for r in recs if r.root == roots[-1].index]
    assert {r.root for r in spans.finished(2, "decode_step")} == {
        roots[-2].index, roots[-1].index}
    assert {r.root for r in spans.finished(5, "prefill")} == {roots[0].index}
    assert spans.finished(0) == []


def test_self_time_is_duration_less_the_childrens_union():
    with spans.recording():
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("a"):
                time.sleep(0.003)
            with spans.span("b"):
                with spans.span("c"):
                    time.sleep(0.002)
                time.sleep(0.001)
    recs = {r.name: r for r in spans.finished()}
    assert set(recs) == {"outer", "a", "b", "c"}
    assert recs["c"].parent == recs["b"].index and recs["b"].parent == recs["outer"].index
    assert len({r.root for r in recs.values()}) == 1 and not any(r.on_device for r in recs.values())
    for r in recs.values():
        assert r.ms == pytest.approx((r.end_ns - r.start_ns) * 1e-6, abs=1e-9)
    o, a, b, c = (recs[k] for k in ("outer", "a", "b", "c"))
    assert a.self_ms == pytest.approx(a.ms) and c.self_ms == pytest.approx(c.ms)
    assert b.self_ms == pytest.approx(b.ms - c.ms, abs=1e-9)
    assert o.self_ms == pytest.approx(o.ms - a.ms - b.ms, abs=1e-9)
    assert o.self_ms >= 1.9 and b.self_ms >= 0.9


def test_count_adds_to_the_innermost_open_span():
    spans.count(n=1)                             # off: nothing to add to
    with spans.recording():
        spans.count(n=1)                         # on, but no span open
        with spans.span("outer"):
            spans.count(n=2)
            with spans.span("inner"):
                spans.count(n=3, m=1)
                spans.count(n=4)
            spans.count(m=5)
    recs = {r.name: r for r in spans.finished()}
    assert set(recs) == {"outer", "inner"}
    assert recs["outer"].counts == {"n": 2, "m": 5}
    assert recs["inner"].counts == {"n": 7, "m": 1}


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1.0), (2.0, 3.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),
    ([(1.0, 1.0), (3.0, 2.0)], 0.0),
])
def test_union_of_children(intervals, want):
    assert spans._union(intervals) == pytest.approx(want)


@pytest.mark.parametrize("arch,pos0,steps", [
    ("yi-9b", 0, 4),             # cache of 64, no window
    ("yi-9b", 60, 4),            # up to the cache's last position
    ("h2o-danube-3-4b", 0, 3),   # window 32: a ring of 32 slots
    ("h2o-danube-3-4b", 30, 6),  # the ring fills and wraps
])
def test_cache_counts_against_hand_counts(arch, pos0, steps):
    cfg, model = _model(arch)
    ring = min(CONTEXT, cfg.window) if cfg.window else CONTEXT
    tok = _tokens(cfg)
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, CONTEXT, "cpu")
        # positions before pos0 written as a prefill would: every slot of
        # the first min(pos0, ring) holds a token
        for layer in cache.values():
            layer["k"][:, :, :, :min(pos0, ring)] = 1.0
        written = []
        with spans.recording():
            for p in range(pos0, pos0 + steps):
                T.decode_step(model, cfg, cache, {"tokens": tok[:, p % S, None]}, p)
                # slots holding a token: any key that is not all zero
                k = cache["pos0"]["k"][0, 0, 0]
                written.append(int((k != 0).any(dim=-1).sum()))
    for step, p in enumerate(range(pos0, pos0 + steps)):
        top = spans.finished(steps - step, "decode_step")
        attn = [r for r in top if r.name == "attn" and r.root == top[0].root]
        assert len(attn) == cfg.n_layers
        for r in attn:
            assert r.counts == {"kv_read": ring, "kv_valid": min(p + 1, ring)}
            assert r.counts["kv_valid"] == written[step]


def test_spans_on_the_profilers_timeline():
    cfg, model = _model("yi-9b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cfg, model, steps=2)
    recs = spans.finished()
    assert len([r for r in recs if r.parent is None]) == 3
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events: dict[str, list] = {}
    for e in prof.events():
        if e.name in NAMES:
            events.setdefault(e.name, []).append(e)
    assert set(events) == NAMES
    for name, evs in events.items():
        assert all(e.device_type.name == "CPU" and not e.is_user_annotation for e in evs)
        mine = [r for r in recs if r.name == name]
        assert len(evs) == len(mine)
        for e, r in zip(sorted(evs, key=lambda e: e.time_range.start), mine):
            a, b = (r.start_ns - start_ns) / 1e3, (r.end_ns - start_ns) / 1e3   # µs
            assert e.time_range.start - 50 <= a <= e.time_range.end + 50
            assert e.time_range.start - 50 <= b <= e.time_range.end + 50
    # off again once the profiler stops
    spans.clear()
    _run(cfg, model, steps=1)
    assert spans.finished() == []
