"""Share of the traced window in which a device operation launched inside
the harness's `net` range (the evaluator handed to the actor) ran."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_s("net")
    return 100.0 * s / ctx.trace.window_s if s > 0 else None
