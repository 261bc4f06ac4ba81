"""peak_mem_gib.decode: ``peak_mem_gib`` in the decode cells, where the end-to-end metric it
moves is ``step_p95_ms``: the same reading (``peak_mem_gib.py``)."""

from bench.run import metric_reader


def read(ctx):
    return metric_reader("peak_mem_gib").read(ctx)
