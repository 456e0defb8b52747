"""The share of the traced window in which no operation ran on the card:
one less the union of the device operations' intervals over the window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
