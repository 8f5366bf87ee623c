"""train.idle_share: the share of the traced window in which no
operation ran on the device, in percent."""


def read(ctx):
    if ctx.trace is None or "epochs" not in ctx.stats:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * (1.0 - ctx.trace.busy_s / ((hi - lo) * 1e-9))
