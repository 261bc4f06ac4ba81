"""decode.host_ms: the median host time, over the window's steps, from a
step's start to the return of ``decode_step`` (its kernels enqueued, not
yet waited for), in milliseconds.

It reads the serving loop's own host cost only while the device keeps up
with the launches. Where the device is slower than the host, as in
``yi-9b.decode-b128`` (128 sequences), the launch queue fills during the
step and each further launch waits for room ("Command Buffer Full" in the
trace), so the number follows the device's step time instead: the trace's
idle gaps, not this number, show the host's part there."""

import statistics


def read(ctx):
    ms = ctx.layer.get("host_ms")
    return statistics.median(ms) if ms else None
