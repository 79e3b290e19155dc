"""Host reads of a device value per simulation batch in the traced
window: the program's counters `search.host_reads` (every `bool(...)` and
`nonzero()` of a device tensor that `mcts_simulate` and its callees make)
over `search.batches`.  An exact count for a seed."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    c = spans.counters()
    batches = c.get("search.batches", 0)
    if batches <= 0 or "search.host_reads" not in c:
        return None
    return c["search.host_reads"] / batches
