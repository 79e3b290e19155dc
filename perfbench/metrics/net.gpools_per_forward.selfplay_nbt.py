"""Pooled reductions per serving forward in the traced window: the
program's counters `net.gpools` (each launch of the pooling epilogue, or
call of its plain version) over `net.forwards`.  One in each pooled block
and one for each head's pool: 8.0 for `b18c384nbt` (6 in the trunk, 2 in
the heads).  Nothing to read where the program keeps neither counter."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    c = spans.counters()
    forwards = c.get("net.forwards", 0)
    if forwards <= 0 or "net.gpools" not in c:
        return None
    return c["net.gpools"] / forwards
