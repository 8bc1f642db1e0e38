"""The share of the profiled stretch's wall time (first push to the end of
its synchronize) in which no kernel, copy or fill ran on the device."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
