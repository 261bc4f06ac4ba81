"""decode.tokens_per_s: every token the window's decode steps served (the
batch's, one a step) over the window's seconds on the host clock. It is
the decode cells' throughput, read per layer: the host's eager enqueue
paces the step, and its speed swings too far between runs to hold this
number to an end-to-end bound (``PERF.md`` §2)."""


def read(ctx):
    w = ctx.layer
    return w["steps"] * w["batch"] / w["window_s"]
