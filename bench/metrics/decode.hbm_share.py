"""decode.hbm_share: the traced steps' least bytes (weights, and each
layer's cache up to the step's position, moved once; the family's counts
through ``bench/work/lm.py``) at the HBM rate, over the device's busy time
in those steps, in percent."""

from bench.work import lm
from bench.work.peaks import HBM_BYTES_S


def read(ctx):
    t = ctx.trace
    pos = ctx.layer.get("traced_positions")
    if t is None or t.busy_s <= 0 or not pos:
        return None
    nbytes = sum(lm.decode_step_bytes(ctx.family, ctx.m, ctx.layer["batch"], p) for p in pos)
    return 100.0 * nbytes / HBM_BYTES_S / t.busy_s
