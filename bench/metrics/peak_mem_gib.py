"""peak_mem_gib: the most device memory allocated during the measured
window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    b = ctx.layer.get("peak_window_bytes")
    return b / 2**30 if b else None
