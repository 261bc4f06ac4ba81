"""wkv6_roofline: the wkv6 calls' least time (the larger of their float32
operations at the float32 peak and their bytes at the HBM rate; the
family's counts through ``bench/work/lm.py``) over the time the chunked
route's two kernels took in the traced slice, in percent. Silent when no
kernel of these names ran, or the family makes no such calls."""

from bench.work import lm
from bench.work.peaks import F32_FLOPS

#: profiler names of ``csrc/wkv6.cu``'s chunked route (phase 1, state scan)
KERNELS = ("wkv6_intra", "wkv6_scan")

#: the family's name for the calls (``kernel_calls`` in ``bench/reference``)
CALL = "wkv6"


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.layer
    work = ctx.family.kernel_calls(ctx.m, w["batch"], w["seq"]).get(CALL)
    launches, seconds = ctx.trace.kernel_seconds(KERNELS)
    if work is None or not launches or seconds <= 0:
        return None
    calls, ops, nbytes = work
    return 100.0 * w["traced_calls"] * calls * lm.bound_s(ops, nbytes, F32_FLOPS) / seconds
