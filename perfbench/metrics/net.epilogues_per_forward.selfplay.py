"""Trunk epilogues per serving forward in the traced window: the program's
counters `net.epilogues` (each launch of the net's epilogue kernel, or
call of its plain version) over `net.forwards` (each forward through the
serving path).  One for the first layer and two for each residual block
where every forward takes that path: 41.0 for a 20-block net.  Nothing
to read where the program keeps neither counter."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    c = spans.counters()
    forwards = c.get("net.forwards", 0)
    if forwards <= 0 or "net.epilogues" not in c:
        return None
    return c["net.epilogues"] / forwards
