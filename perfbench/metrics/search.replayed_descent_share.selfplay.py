"""Share of the traced window's descents (select-and-expand passes of one
rollout over every board) that the program ran from captured CUDA graphs:
its counters `search.descents_replayed` over `search.descents`, in %.
An exact count for a seed; a program that keeps neither counter leaves
nothing to read."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    c = spans.counters()
    descents = c.get("search.descents", 0)
    if descents <= 0:
        return None
    return 100.0 * c.get("search.descents_replayed", 0) / descents
