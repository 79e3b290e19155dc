"""Seconds from the start of the process to the first timed unit: imports,
the traffic's data, the program's set-up, kernel builds and loads, and the
warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
