"""mfu.decode: ``mfu`` in the decode cells, where the end-to-end metric it
moves is ``step_p95_ms``: the same reading (``mfu.py``)."""

from bench.run import metric_reader


def read(ctx):
    return metric_reader("mfu").read(ctx)
