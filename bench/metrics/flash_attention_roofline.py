"""flash_attention_roofline: the causal attention calls' least time (the
larger of their operations at the bf16 peak and their bytes at the HBM
rate; the family's counts through ``bench/work/lm.py``) over the time the
flash kernels took in the traced slice, in percent. Silent when no kernel
of these names ran, or the family makes no such calls."""

from bench.work import lm

#: profiler names of ``csrc/flash_attention.cu``'s kernels
KERNELS = ("flash_fwd",)

#: the family's name for the calls (``kernel_calls`` in ``bench/reference``)
CALL = "flash_attention"


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.layer
    work = ctx.family.kernel_calls(ctx.m, w["batch"], w["seq"]).get(CALL)
    launches, seconds = ctx.trace.kernel_seconds(KERNELS)
    if work is None or not launches or seconds <= 0:
        return None
    calls, ops, nbytes = work
    return 100.0 * w["traced_calls"] * calls * lm.bound_s(ops, nbytes) / seconds
