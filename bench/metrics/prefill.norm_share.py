"""prefill.norm_share: the ``norm`` spans' time (each ``Block``'s two
float32 RMSNorms) over the ``prefill`` roots' time in the traced calls, in
percent: the spans' CUDA events on the card, the host clock elsewhere.
Reads ``repro_torch.runtime.spans`` for the last ``traced_calls``
``prefill`` roots only; silent where the program has no spans or the slice
recorded none."""

#: the span whose share of the call this reads
SPAN = "norm"


def _records(n: int, root: str) -> list:
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return []
    return spans.finished(n, root)


def read(ctx):
    n = ctx.layer.get("traced_calls")
    recs = _records(n, "prefill") if n else []
    total = sum(r.ms for r in recs if r.parent is None)
    part = [r.ms for r in recs if r.name == SPAN]
    if total <= 0 or not part:
        return None
    return 100.0 * sum(part) / total
