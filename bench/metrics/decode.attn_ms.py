"""decode.attn_ms: the median, over the traced decode steps, of a step's
time in decode attention (``attn`` spans: ``attn_decode`` in each attention
layer's ``Block.decode``: projections, cache write, ``_decode_core``, output
projection), in milliseconds, taken as the number of the step's ``attn``
spans times the shortest of them. The layers do the same work on the same
shapes, and a span's time between its CUDA events also counts any gap in
which the device waited for the host; the profiler's host cost opens such
gaps through most of a traced step on a slow host, while the shortest span
is one in which the device did not wait. The host clock stands in off the
card. Reads ``repro_torch.runtime.spans`` for the last
``len(traced_positions)`` ``decode_step`` roots only; silent where the
program has no spans or the slice recorded none."""

import statistics


def _records(n: int, root: str) -> list:
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return []
    return spans.finished(n, root)


def read(ctx):
    n = len(ctx.layer.get("traced_positions") or ())
    steps: dict[int, list[float]] = {}
    for r in _records(n, "decode_step") if n else []:
        if r.name == "attn":
            steps.setdefault(r.root, []).append(r.ms)
    if not steps:
        return None
    return statistics.median(len(ms) * min(ms) for ms in steps.values())
