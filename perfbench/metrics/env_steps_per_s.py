"""Engine steps per second over all boards: chunks x steps x boards over
the window (host clock)."""


def read(ctx):
    if "steps" not in ctx.work:
        return None
    return ctx.work["steps"] / ctx.window_s
