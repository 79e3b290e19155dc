"""Share of the traced window in which no device operation ran while the
host was inside the search's select-and-expand or backprop phase (the
program's `elf.mcts.select_expand` and `elf.mcts.backprop` spans): the
card's idle time that the search's host loop accounts for."""

from harness import spans

PHASES = ["elf.mcts.select_expand", "elf.mcts.backprop"]


def read(ctx):
    if ctx.trace is None or spans.span_s(ctx.trace, PHASES) <= 0:
        return None
    return 100.0 * spans.idle_while(ctx.trace, PHASES) / ctx.trace.window_s
