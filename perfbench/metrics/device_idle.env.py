"""Share of the traced window in which no device operation ran."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
