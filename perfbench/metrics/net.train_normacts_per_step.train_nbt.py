"""Norm-and-activation layers per learner step in the traced window: the
program's counter `net.train_normacts` (each norm-and-activation call of
the nested-bottleneck net's training forward, a remat block's recomputed
ones included) over the window's steps.  118 a forward at b18c384nbt's
layout, and with block remat 114 more: 232.0.  Nothing to read where the
program keeps no such counter."""

from harness import spans


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if ctx.trace is None or steps <= 0:
        return None
    c = spans.counters()
    if "net.train_normacts" not in c:
        return None
    return c["net.train_normacts"] / steps
