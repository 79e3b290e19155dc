"""Share of the traced window in which no device operation ran while the
host was inside the replay pipeline (the program's `elf.pipeline.sample`
and `elf.pipeline.features` spans): the card's idle time that the host
pipeline accounts for."""

from harness import spans

PHASES = ["elf.pipeline.sample", "elf.pipeline.features"]


def read(ctx):
    if ctx.trace is None or spans.span_s(ctx.trace, PHASES) <= 0:
        return None
    return 100.0 * spans.idle_while(ctx.trace, PHASES) / ctx.trace.window_s
