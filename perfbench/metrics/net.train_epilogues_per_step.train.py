"""Trunk training epilogues per learner step in the traced window: the
program's counter `net.train_epilogues` (each forward call of the
training epilogue, kernel or plain version, a remat block's recomputed
ones included) over the window's steps.  One for the first layer and two
for each residual block a forward, and with block remat two more a block:
81.0 for a 20-block net.  Nothing to read where the program keeps no such
counter."""

from harness import spans


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if ctx.trace is None or steps <= 0:
        return None
    c = spans.counters()
    if "net.train_epilogues" not in c:
        return None
    return c["net.train_epilogues"] / steps
