"""device_idle_pct (layer: device): the share of the traced window in
which no operation ran on the device (100 minus the union of the device's
activity over the window), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
