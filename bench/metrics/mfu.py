"""mfu: the operations the window's calls need (``bench/work/lm.py``, from
shapes) over the window's seconds at the card's bf16 peak, in percent."""

from bench.work.peaks import BF16_FLOPS


def read(ctx):
    w = ctx.layer
    return 100.0 * w["flops"] / (w["window_s"] * BF16_FLOPS)
