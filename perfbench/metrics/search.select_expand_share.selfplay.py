"""Share of the traced window in which the host was inside the search's
select-and-expand phase: the union of the program's
`elf.mcts.select_expand` spans (one per simulation batch, its m descents
and expansions) over the window."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    s = spans.span_s(ctx.trace, ["elf.mcts.select_expand"])
    return 100.0 * s / ctx.trace.window_s if s > 0 else None
