"""Share of the traced window in which the host was inside the search's
backprop phase: the union of the program's `elf.mcts.backprop` spans (one
per simulation batch, the lockstep walk and its set-up) over the
window."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    s = spans.span_s(ctx.trace, ["elf.mcts.backprop"])
    return 100.0 * s / ctx.trace.window_s if s > 0 else None
