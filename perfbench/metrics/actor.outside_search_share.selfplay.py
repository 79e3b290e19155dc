"""Share of the window the actor spends outside `mcts_simulate`: 1 minus
the program's own host seconds of its simulate calls (`simulate_s`, each
ending on a host sync in the search's backprop loop) over the window."""


def read(ctx):
    sim = ctx.counters.get("simulate_s")
    if sim is None or ctx.trace is None:
        return None
    return 100.0 * (1.0 - sim / ctx.trace.window_s)
