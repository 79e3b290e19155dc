"""Device operations (kernels, copies, fills) launched inside the harness's
range around `engine.step_core`, per call: an exact count."""


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.range_count("step_core")
    return ctx.trace.op_count("step_core") / calls if calls else None
