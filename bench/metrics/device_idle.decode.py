"""device_idle.decode: ``device_idle`` in the decode cells, where the end-to-end metric it
moves is ``step_p95_ms``: the same reading (``device_idle.py``)."""

from bench.run import metric_reader


def read(ctx):
    return metric_reader("device_idle").read(ctx)
