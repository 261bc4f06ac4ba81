"""device_idle: the share of the traced slice in which no operation ran on
the device (profiler device events), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
