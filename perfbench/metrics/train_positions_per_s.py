"""Positions trained on per second: steps x batch over the window (host
clock)."""


def read(ctx):
    if "positions" not in ctx.work:
        return None
    return ctx.work["positions"] / ctx.window_s
